"""The fused GAME training program: one call is one whole block-coordinate-
descent sweep, on one device.

Counterpart of ``photon_ml_tpu/parallel/distributed.py`` with ``mesh=None``;
reference photon-api algorithm/FixedEffectCoordinate.scala:91-165,
algorithm/RandomEffectCoordinate.scala:104-153 and photon-lib
algorithm/CoordinateDescent.scala:198-255 (the residual choreography). One
``step``:

    FE solve -> its score -> extra FE solves -> per-RE-type lane-batched
    entity solves -> MF alternations -> the training loss

in the configured ``update_order``, each coordinate solving against the
latest scores of all the others (Gauss-Seidel). The state stays in the
solves' space (normalized coefficients) between sweeps, and the training
loss is computed on the device; no host evaluator runs between coordinates.
Unlike ``GameEstimator.fit`` (``algorithm/coordinate_descent.py``) there is
no model object per coordinate inside the sweep: the state is plain tensors
(:class:`GameTrainState`) and the data and buckets are plain dicts of
tensors, built once by :meth:`GameTrainProgram.prepare_inputs`.

Kernels. ``use_kernel_fe`` is the evaluation path of the fixed effects'
solves (the JAX program's ``use_pallas_fe``): None (the default) runs the
fused GLM kernel B1 (``ops/fused_glm.py``) on every evaluation of a dense
fixed effect on a CUDA block, and the gather kernel (``ops/sparse_gather.py``)
on a sparse one; False takes the closed forms. The packed-aux kernel of
``ops/packed_glm.py`` is the coordinate-descent path's
(``FixedEffectCoordinate``), not this program's. Compact random effects on a
sparse shard score through the gather kernel over their flattened table
(``models/game.CompactEntries``).

The mesh (``mesh=``, a ``parallel/mesh.make_mesh`` DeviceMesh) runs the
same sweep data-parallel, one process per rank: :meth:`GameTrainProgram.
shard_inputs` keeps this rank's block of rows and of each bucket's entity
lanes, and every collective is explicit and in the same order on every
rank (``parallel/mesh.py`` counts them):

- a fixed effect's solve: each evaluation sums the ranks' partials with one
  ``all_reduce`` (``parallel/sharded_dense.py``; B1 or G1 on each rank's
  rows);
- a random-effect or MF coordinate: one ``all_gather`` of the residual
  offsets (bucket ``sample_rows`` index the whole sample axis), each rank
  solves its lanes, then one ``all_gather`` of the solved table rows per
  table (per MF half-step), so every rank holds the whole table again;
- the training loss: one ``all_reduce`` of (Σw·l, Σw).

The state stays replicated, and every rank holds the full [n] entity
indices of MF coordinates (the other side's factor rows of a lane's
samples). Where several lanes solve one entity (a partitioned read's
entities on several ranks), the last lane in bucket order, then rank order,
writes its table row (:class:`MeshLayout`).

:func:`train_partitioned` runs the same step on each rank's own block of a
partitioned read (``io/partitioned_reader.py``): no rank holds the whole
sample axis, and the rank-local buckets
(``build_random_effect_dataset_partitioned``) index it through their
shifted ``sample_rows``.

The model axis (``fe_feature_sharded`` over a mesh with ``model > 1``):
each rank holds its rows and its ``ceil(d/M)`` columns of the primary fixed
effect, dense (``[n/D, d/M]``) or as a sparse column block
(``parallel/column_sharded.py``), and ``state.fe_coefficients`` is that
block (``GameTrainState.fe_columns`` says which), so the coefficients, the
gradient and the solver's history are ``d/M`` long on every rank. One FE
evaluation computes the partial margins of the rank's columns and
all-reduces them over "model", takes the loss on the rank's rows, forms the
rank's gradient block and all-reduces it over "data"; the solver's inner
products are all-reduced over "model" (``optim/common.VectorOps``). The
random effects, MF coordinates and extra fixed effects shard over "data"
and are replicated across "model": their exchanges run on the data group,
as without a model axis. The whole FE vector is gathered only where the
JAX package materializes it: the model on output and the FE variances
(:meth:`GameTrainProgram.whole_state`). With a model axis of 1 the flag
changes nothing.

``train_distributed`` and ``train_partitioned`` save and restore sweep
checkpoints (``io/checkpoint.commit_checkpoint``), and a run of several
ranks, partitioned or not, recovers through ``resilience.CoordinatedRecovery``
on its exchange. Nothing is compiled: each coordinate's solve runs its lane
loops as ``GameEstimator.fit`` does. :meth:`GameTrainProgram.step_scheduled`
is the sweep with probe/rescue lane scheduling on the random effects
(``algorithm/lane_scheduler.py``), which both training functions take when a
spec's optimizer carries a scheduler: each rank schedules its own lanes, with
no collective inside the solve, and the solved rows are shared as in
:meth:`GameTrainProgram.step`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import (
    _with_scratch_column,
    bucket_variances,
    bucket_variances_indexmap,
    bucket_variances_random,
    random_variance_mode,
    solve_entity_bucket,
    solve_entity_bucket_indexmap,
    solve_entity_bucket_random,
)
from photon_ml_torch.algorithm.mf_coordinate import MFDataset, solve_mf_side_bucket
from photon_ml_torch.data.batch import LabeledPointBatch, device_tensor, solve_dtype_of
from photon_ml_torch.data.game_data import (
    PAD_ENTITY_ROW,
    GameDataset,
    RandomEffectDataset,
    pad_game_dataset,
    pad_lane_fields,
    sparse_shard_rows,
)
from photon_ml_torch.data.sparse_batch import (
    SparseLabeledPointBatch,
    SparseShard,
    feature_product,
)
from photon_ml_torch.io.checkpoint import (
    DivergenceError,
    commit_checkpoint,
    fingerprint_mismatch,
    host_array,
)
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    CompactEntries,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    compact_entry_positions,
    match_active_positions,
    score_random_effect,
)
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.models.matrix_factorization import (
    MatrixFactorizationModel,
    init_factors,
    score_matrix_factorization,
)
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.normalization import NormalizationContext, host_factors
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.ops.variance import (
    coefficient_variances,
    resolve_variance_mode,
    validate_variance_mode,
)
from photon_ml_torch.optim.optimizer import OptimizerConfig, resolve_auto_optimizer, solve
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.parallel.column_sharded import (
    ColumnShardedGLMObjective,
    FeatureShardedDenseGLMObjective,
    block_normalization,
    build_column_sharded_batch,
    fe_columns_of,
    feature_block,
    split_fe,
)
from photon_ml_torch.parallel.sharded_dense import (
    ShardedDenseGLMObjective,
    ShardedSparseGLMObjective,
)
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.resilience import recovery
from photon_ml_torch.telemetry.program_ledger import ledger_call
from photon_ml_torch.types import TaskType

@dataclasses.dataclass
class GameTrainState:
    """The model state of one training step, as tensors on one device.

    fe_coefficients: [d_fe], the primary fixed effect in normalized space.
    re_tables: RE type -> [num_entities, d_re] coefficient table ([E, K]
        over each entity's active columns for a compact coordinate).
    mf_rows / mf_cols: MF coordinate name -> [num_entities, k] factors.
    extra_fe: feature shard id -> [d] vector of each additional (dense)
        fixed effect, in its normalized space.
    fe_columns: None when ``fe_coefficients`` is the whole vector; over a
        model axis ``(start, block, dim)``: it is the rank's ``[block]``
        slice of a ``dim``-wide vector from column ``start`` (lanes past
        ``dim`` are padding, pinned at 0).
    """

    fe_coefficients: torch.Tensor
    re_tables: dict
    mf_rows: dict = dataclasses.field(default_factory=dict)
    mf_cols: dict = dataclasses.field(default_factory=dict)
    extra_fe: dict = dataclasses.field(default_factory=dict)
    fe_columns: tuple | None = None




@dataclasses.dataclass(frozen=True)
class RandomEffectStepSpec:
    """One RE coordinate of the step. ``projector`` must match the
    RandomEffectDataset's: INDEX_MAP solves each entity over its observed
    columns through the scratch-column gather/scatter, RANDOM in the sketch
    and back-projects; the table is [E, dim] in original space either way."""

    re_type: str
    feature_shard_id: str
    optimizer: OptimizerConfig
    l2_weight: float = 0.0
    projector: ProjectorType = ProjectorType.IDENTITY
    #: intercept column of the shard: required when the coordinate's
    #: normalization has shifts (STANDARDIZATION), whose margin shift the
    #: intercept absorbs in model space
    intercept_index: int | None = None


@dataclasses.dataclass(frozen=True)
class FixedEffectStepSpec:
    """The fixed-effect coordinate. ``down_sampling_rate`` < 1 trains the
    solve on down-sampled weights (reference
    DistributedOptimizationProblem.runWithSampling:145-160): ``train_distributed``
    draws a per-sweep multiplier with the coordinate-descent path's
    splitmix64 sampler; scoring and the training loss cover every sample."""

    feature_shard_id: str
    optimizer: OptimizerConfig
    l2_weight: float = 0.0
    down_sampling_rate: float = 1.0
    #: intercept column of an additional (extra) fixed effect whose
    #: normalization has shifts; the primary's rides the ``intercept_index``
    #: argument of state_to_game_model / game_model_to_state
    intercept_index: int | None = None


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationStepSpec:
    """One MF coordinate of the step (``algorithm/mf_coordinate.py``)."""

    name: str
    row_effect_type: str
    col_effect_type: str
    num_latent_factors: int
    optimizer: OptimizerConfig
    l2_weight: float = 0.0
    num_alternations: int = 1
    seed: int = 0


def _data_pytree(dataset: GameDataset, re_specs: Sequence[RandomEffectStepSpec], fe_shard: str,
                 mf_specs: Sequence[MatrixFactorizationStepSpec] = (),
                 extra_fe_shards: Sequence[str] = ()) -> dict:
    """The sample-axis inputs of the step: labels, offsets, weights, the
    dense feature blocks, the entity indices, and a sparse primary fixed
    effect's batch (zero offsets: its margins are the pure product)."""
    shards = {fe_shard} | {s.feature_shard_id for s in re_specs} | set(extra_fe_shards)
    id_types = {s.re_type for s in re_specs}
    for m in mf_specs:
        id_types |= {m.row_effect_type, m.col_effect_type}
    re_shards = {s.feature_shard_id for s in re_specs}
    for k in shards:
        if isinstance(dataset.feature_shards[k], SparseShard) and k != fe_shard:
            # sparse RE shards ride as compact entry mappings; the extra-FE
            # solves read dense blocks only
            if k in extra_fe_shards or k not in re_shards:
                raise ValueError(
                    f"feature shard '{k}' is sparse (giant-d) but is not "
                    "the PRIMARY fixed-effect shard or a random-effect "
                    "shard (additional fixed effects are dense-only; make "
                    "the sparse one the primary)"
                )
    data = {
        "labels": dataset.labels,
        "offsets": dataset.offsets,
        "weights": dataset.weights,
        "features": {k: dataset.feature_shards[k] for k in sorted(shards)
                     if not isinstance(dataset.feature_shards[k], SparseShard)},
        "entity_idx": {t: dataset.entity_idx[t] for t in sorted(id_types)},
    }
    if isinstance(dataset.feature_shards[fe_shard], SparseShard):
        base = dataset.fixed_effect_batch(fe_shard)
        data["fe_sparse_batch"] = base.with_offsets(torch.zeros_like(base.offsets))
        data["fe_sparse_shard"] = dataset.feature_shards[fe_shard]
    return data


@dataclasses.dataclass
class MeshLayout:
    """This rank's place in a mesh-sharded data pytree (``data["mesh"]``):
    its rows of the padded sample axis and, per exchanged table (an RE type,
    ``"<mf name>/row"``, ``"<mf name>/col"``), the entity rows its lanes own
    ([L], pads out of range) and every rank's owned rows in rank order
    ([R·L]).

    ``keep`` (per key) lists the positions of ``every`` that are written:
    where an entity has lanes on several ranks (a partitioned read's
    spanning entities), only its last lane in bucket order, then rank
    order, the order of the JAX package's global scatter. ``per_bucket``
    (per key) holds the same three for each bucket alone, for a key whose
    entity has lanes in more than one bucket: the table is then shared after
    every bucket, so a later bucket's lanes start from the earlier one's
    solve, as in the JAX package's global table."""

    mesh: object
    rows: slice
    num_rows: int
    owned: dict = dataclasses.field(default_factory=dict)
    keep: dict = dataclasses.field(default_factory=dict)
    per_bucket: dict = dataclasses.field(default_factory=dict)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """This rank's [n/R] slice of a sample-axis vector -> the whole [n]."""
        return mesh_ops.all_gather_rows(local, self.mesh)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return mesh_ops.all_reduce_sum(t, self.mesh)

    def share(self, key: str, table: torch.Tensor) -> torch.Tensor:
        """``table`` with every rank's solved rows for ``key``: this rank's
        rows are gathered from all ranks and written in place of the stale
        ones (rows that no lane owns are equal on every rank already)."""
        mine, every = self.owned[key]
        return self._share(table, mine, every, self.keep.get(key))

    def share_bucket(self, key: str, i: int, table: torch.Tensor) -> torch.Tensor:
        """:meth:`share` of bucket ``i``'s lanes alone (``per_bucket``)."""
        return self._share(table, *self.per_bucket[key][i])

    def _share(self, table, mine, every, keep) -> torch.Tensor:
        if mine.numel() == 0:
            return table
        n = table.shape[0]
        got = mesh_ops.all_gather_rows(table[torch.clamp(mine, max=max(n - 1, 0))], self.mesh)
        if keep is None:
            keep = every < n
        else:
            keep = keep[every[keep] < n]
        # the written rows are distinct: a row copied twice lands in an
        # unspecified order on CUDA
        return table.index_copy(0, every[keep], got[keep])


def last_lane_positions(rows: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Ascending positions of ``rows`` to write: for each entity row the one
    whose ``order`` is largest; pad rows (out of the int32 range of a table,
    or negative) are dropped."""
    rows = np.asarray(rows, dtype=np.int64)
    idx = np.flatnonzero((rows >= 0) & (rows < int(PAD_ENTITY_ROW)))
    if not len(idx):
        return idx
    by = idx[np.lexsort((np.asarray(order)[idx], rows[idx]))]
    last = np.ones(len(by), dtype=bool)
    last[:-1] = rows[by][1:] != rows[by][:-1]
    return np.sort(by[last])


def _lane_owners(layout: MeshLayout, key: str, rows, rank: int, device) -> None:
    """Set ``layout``'s owners of ``key`` from ``rows[r][b]``, rank r's
    entity rows of bucket b (each bucket has one lane count on every
    rank)."""
    size, lens = len(rows), [int(t.shape[0]) for t in rows[0]]
    # each lane's place in the global scatter order: bucket, then rank
    starts = np.concatenate([[0], np.cumsum(lens)]) * size
    order = np.concatenate([starts[b] + r * lens[b] + np.arange(lens[b])
                            for r in range(size) for b in range(len(lens))] or [np.zeros(0)])
    every = np.concatenate([t.numpy() for r in range(size) for t in rows[r]]
                           or [np.zeros(0)]).astype(np.int64)

    def on(a):
        return torch.as_tensor(a, dtype=torch.long, device=device)

    layout.owned[key] = (on(torch.cat(rows[rank]) if lens else torch.zeros(0)), on(every))
    layout.keep[key] = on(last_lane_positions(every, order))
    per_bucket = [np.concatenate([rows[r][b].numpy() for r in range(size)]).astype(np.int64)
                  for b in range(len(lens))]
    entities = np.concatenate([np.unique(e[(e >= 0) & (e < int(PAD_ENTITY_ROW))])
                               for e in per_bucket] or [np.zeros(0)])
    if len(entities) != len(np.unique(entities)):  # an entity in two buckets
        layout.per_bucket[key] = [
            (on(rows[rank][b]), on(e), on(last_lane_positions(e, np.arange(len(e)))))
            for b, e in enumerate(per_bucket)]


def _buckets_pytree(re_datasets: Mapping[str, RandomEffectDataset],
                    re_specs: Sequence[RandomEffectStepSpec] = (),
                    normalized_re_types: "set[str]" = frozenset()) -> dict:
    """RE type -> list of bucket dicts, and ``__projections__`` (RE type ->
    the [d, k] matrix) for RANDOM coordinates; checks each dataset's
    projector and pre-normalization against the specs."""
    spec_projector = {s.re_type: s.projector for s in re_specs}
    for k, ds in re_datasets.items():
        if (k in normalized_re_types
                and ds.projector_type in (ProjectorType.INDEX_MAP, ProjectorType.RANDOM)
                and not ds.pre_normalized):
            raise ValueError(
                f"random-effect coordinate '{k}': projected coordinates "
                "with normalization require the RandomEffectDataset to be "
                "built with the same normalization "
                "(build_random_effect_dataset(normalization=...))"
            )
        if ds.pre_normalized and k not in normalized_re_types:
            raise ValueError(
                f"random-effect coordinate '{k}': the RandomEffectDataset "
                "was built pre-normalized but the program spec carries no "
                "normalization context for it — tables would leave the "
                "step in normalized space unconverted"
            )
        expected = spec_projector.get(k, ProjectorType.IDENTITY)
        if ds.projector_type != expected:
            raise ValueError(
                f"random-effect dataset '{k}' uses projector "
                f"{ds.projector_type.name} but the step spec declares "
                f"{expected.name} — the step's solve/scatter logic is "
                "chosen per projector, so they must match"
            )

    def bucket_dict(b, ds) -> dict:
        out = {"features": b.features, "labels": b.labels, "weights": b.weights,
               "sample_rows": b.sample_rows, "entity_rows": b.entity_rows}
        if ds.projector_type == ProjectorType.INDEX_MAP:
            out["col_index"] = b.col_index
        return out

    out: dict = {k: [bucket_dict(b, ds) for b in ds.buckets] for k, ds in re_datasets.items()}
    projections = {k: ds.projection.matrix for k, ds in re_datasets.items()
                   if ds.projector_type == ProjectorType.RANDOM}
    if projections:
        out["__projections__"] = projections
    return out


class GameTrainProgram:
    """A full-GAME training step bound to static specs, on one device.

    Build once per (task, coordinate specs), prepare the inputs once, then
    call :meth:`step` once a sweep.
    """

    def __init__(
        self,
        task: TaskType,
        fe: FixedEffectStepSpec,
        re_specs: Sequence[RandomEffectStepSpec] = (),
        *,
        mf_specs: Sequence[MatrixFactorizationStepSpec] = (),
        extra_fes: Sequence[FixedEffectStepSpec] = (),
        update_order: Sequence[str] | None = None,
        normalization: NormalizationContext | None = None,
        re_normalizations: Mapping[str, NormalizationContext] | None = None,
        extra_fe_normalizations: Mapping[str, NormalizationContext] | None = None,
        use_kernel_fe: bool | None = None,
        mesh=None,
        fe_feature_sharded: bool = False,
    ):
        if mesh is not None:
            mesh_ops.check_data_mesh(mesh)
        self.mesh = mesh
        #: the primary FE is feature-sharded over the mesh's model axis
        #: (with no mesh, or a model axis of 1, there is one column block)
        self.fe_feature_sharded = bool(fe_feature_sharded)
        self._model_axis = (self.fe_feature_sharded and mesh is not None
                            and mesh_ops.model_size(mesh) > 1)
        #: (kind, columns) -> the model-axis FE objective of that block
        self._model_objectives: dict = {}
        self.task = task
        loss = loss_for_task(task)
        self._loss = loss

        # AUTO resolves once, here: FE coordinates take LBFGS; RE and MF
        # coordinates (small dense lane problems) take NEWTON when the loss
        # allows it. Explicit configs pass through untouched.
        def resolved(spec, small_dense):
            opt = resolve_auto_optimizer(spec.optimizer, loss=loss, small_dense=small_dense)
            return spec if opt is spec.optimizer else dataclasses.replace(spec, optimizer=opt)

        self.fe = fe = resolved(fe, False)
        self.re_specs = tuple(resolved(s, True) for s in re_specs)
        self.mf_specs = tuple(resolved(s, True) for s in mf_specs)
        self.extra_fes = tuple(resolved(s, False) for s in extra_fes)
        # one namespace: residual keys and the GameModel coordinate ids of
        # state_to_game_model (each FE coordinate named after its shard)
        names = ([fe.feature_shard_id] + [s.feature_shard_id for s in self.extra_fes]
                 + [s.re_type for s in self.re_specs] + [m.name for m in self.mf_specs])
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"coordinate names must be unique across the FE feature "
                f"shards, RE types, and MF names (duplicates: {sorted(dupes)})"
            )
        # the configured order is semantic (CoordinateDescent.scala:198-255);
        # default: primary FE, extra FEs, REs, MFs
        if update_order is None:
            self.update_order: tuple[str, ...] = tuple(names)
        else:
            if sorted(update_order) != sorted(names):
                raise ValueError(
                    f"update_order must be a permutation of the coordinate "
                    f"names {sorted(names)}; got {list(update_order)}"
                )
            self.update_order = tuple(update_order)
        self._kind = {fe.feature_shard_id: "fe"}
        self._kind.update({s.feature_shard_id: "extra_fe" for s in self.extra_fes})
        self._kind.update({s.re_type: "re" for s in self.re_specs})
        self._kind.update({m.name: "mf" for m in self.mf_specs})
        self._extra_fe_by_name = {s.feature_shard_id: s for s in self.extra_fes}
        self._re_by_name = {s.re_type: s for s in self.re_specs}
        self._mf_by_name = {m.name: m for m in self.mf_specs}
        reserved = {"__mf__", "__projections__"} & set(names)
        if reserved:
            raise ValueError(
                f"{sorted(reserved)} are reserved (internal bucket-group "
                "keys); rename the coordinate"
            )
        self.normalization = normalization
        self._fe_objective = GLMObjective(loss, l2_weight=fe.l2_weight,
                                          normalization=normalization, use_kernel=use_kernel_fe)
        self._fe_sparse_objective = SparseGLMObjective(
            loss, l2_weight=fe.l2_weight, normalization=normalization, use_kernel=use_kernel_fe)
        extra_fe_normalizations = dict(extra_fe_normalizations or {})
        for s in self.extra_fes:
            ctx = extra_fe_normalizations.get(s.feature_shard_id)
            if ctx is not None and ctx.shifts is not None and s.intercept_index is None:
                raise ValueError(
                    f"fixed-effect coordinate '{s.feature_shard_id}': "
                    "normalization with shifts (STANDARDIZATION) requires "
                    "the spec's intercept_index"
                )
        self._extra_fe_objectives = {
            s.feature_shard_id: GLMObjective(
                loss, l2_weight=s.l2_weight,
                normalization=extra_fe_normalizations.get(s.feature_shard_id),
                use_kernel=use_kernel_fe)
            for s in self.extra_fes
        }
        # RE normalization: factors scale the effective coefficients, shifts
        # subtract each entity's margin-shift scalar in scoring and are
        # absorbed into the shard's intercept on model-space conversion
        re_normalizations = dict(re_normalizations or {})
        for s in self.re_specs:
            ctx = re_normalizations.get(s.re_type)
            if ctx is not None and ctx.shifts is not None and s.intercept_index is None:
                raise ValueError(
                    f"random-effect coordinate '{s.re_type}': normalization "
                    "with shifts (STANDARDIZATION) requires the spec's "
                    "intercept_index (the intercept absorbs each entity's "
                    "margin shift in model space)"
                )
        self._re_objectives = {
            s.re_type: GLMObjective(loss, l2_weight=s.l2_weight,
                                    normalization=re_normalizations.get(s.re_type),
                                    use_kernel=False)
            for s in self.re_specs
        }
        # projected (INDEX_MAP/RANDOM) + normalization: the entity blocks
        # arrive pre-normalized, so their solves use a plain objective;
        # scoring and the table conversions keep the context
        self._re_solve_objectives = {
            s.re_type: (
                GLMObjective(loss, l2_weight=s.l2_weight, use_kernel=False)
                if s.projector in (ProjectorType.INDEX_MAP, ProjectorType.RANDOM)
                and re_normalizations.get(s.re_type) is not None
                else self._re_objectives[s.re_type])
            for s in self.re_specs
        }
        self._mf_objectives = {m.name: GLMObjective(loss, l2_weight=m.l2_weight, use_kernel=False)
                               for m in self.mf_specs}
        # the fixed effects' solves over a mesh: each rank's rows, summed by
        # one all-reduce an evaluation (the objectives above keep serving
        # scoring, variances and model conversion over whole datasets)
        self._mesh_objectives: dict = {}
        if mesh is not None:
            self._mesh_objectives = {
                "dense": ShardedDenseGLMObjective(loss, mesh, l2_weight=fe.l2_weight,
                                                  normalization=normalization,
                                                  use_kernel=use_kernel_fe),
                "sparse": ShardedSparseGLMObjective(loss, mesh, l2_weight=fe.l2_weight,
                                                    normalization=normalization,
                                                    use_kernel=use_kernel_fe),
            }
            for s in self.extra_fes:
                self._mesh_objectives[s.feature_shard_id] = ShardedDenseGLMObjective(
                    loss, mesh, l2_weight=s.l2_weight,
                    normalization=extra_fe_normalizations.get(s.feature_shard_id),
                    use_kernel=use_kernel_fe)
        # program labels (telemetry/program_ledger.py): the whole sweep and
        # the validation score; the sweep's pieces each under its own label,
        # observed where the JAX package dispatches them on their own (the
        # scheduled sweep): inside "train/step" they are part of its call
        self._step = ledger_call(self._step_impl, label="train/step")
        self._score = ledger_call(self._score_impl, label="train/score")
        self._pieces = {
            "scores": ledger_call(self._coordinate_scores, label="train/sched_scores"),
            "fe_solve": ledger_call(self._solve_primary_fe, label="train/sched_fe_solve"),
            "fe_margin": ledger_call(self._fe_margin_score, label="train/sched_fe_margin"),
            "extra_fe_solve": ledger_call(self._solve_extra_fe,
                                          label="train/sched_extra_fe_solve",
                                          static_argnums=(1,)),
            "extra_fe_margin": ledger_call(self._extra_fe_margin,
                                           label="train/sched_extra_fe_margin",
                                           static_argnums=(1,)),
            "re_solve": ledger_call(self._solve_re, label="train/sched_re_solve",
                                    static_argnums=(2,)),
            "re_score": ledger_call(self._re_coordinate_score, label="train/sched_re_score",
                                    static_argnums=(1, 3)),
            "mf_solve": ledger_call(self._solve_mf, label="train/sched_mf_solve",
                                    static_argnums=(2,)),
            "offsets": ledger_call(self._sum_scores, label="train/sched_offsets",
                                   static_argnums=(2,)),
            "loss": ledger_call(self._weighted_loss, label="train/sched_loss"),
        }

    def fe_coefficients_model_space(self, state: GameTrainState,
                                    intercept_index: int | None = None) -> torch.Tensor:
        """The state's normalized-space FE vector in original feature space
        (over a model axis gathered first: a collective)."""
        return self._fe_objective.normalization.to_model_space(self.whole_fe(state),
                                                               intercept_index)

    def whole_fe(self, state: GameTrainState) -> torch.Tensor:
        """The whole FE vector of ``state``: the rank's block gathered over
        the model axis (every rank of the model group calls it) when the
        state holds a block."""
        if state.fe_columns is None:
            return state.fe_coefficients
        if self.mesh is None:
            raise ValueError("a state holding an FE column block needs the program's mesh")
        whole = mesh_ops.all_gather_rows(state.fe_coefficients, self.mesh, axis="model")
        return whole[:state.fe_columns[2]]

    def whole_state(self, state: GameTrainState) -> GameTrainState:
        """``state`` with its whole FE vector (:meth:`whole_fe`)."""
        if state.fe_columns is None:
            return state
        return dataclasses.replace(state, fe_coefficients=self.whole_fe(state), fe_columns=None)

    def _split_state(self, state: GameTrainState, dim: int) -> GameTrainState:
        """``state`` with the rank's FE block, on a model axis (a whole
        vector is split, a block must be this rank's)."""
        if not self._model_axis:
            if state.fe_columns is not None:
                raise ValueError("the state holds an FE column block but the program runs no "
                                 "model axis (GameTrainProgram(fe_feature_sharded=True) over a "
                                 "mesh with model > 1)")
            return state
        columns = fe_columns_of(dim, self.mesh)
        if state.fe_columns is not None:
            if tuple(state.fe_columns) != columns:
                raise ValueError(f"the state's FE block {state.fe_columns} is not this rank's "
                                 f"{columns}")
            return state
        return dataclasses.replace(state, fe_coefficients=split_fe(state.fe_coefficients,
                                                                   columns),
                                   fe_columns=columns)

    def _model_objective(self, kind: str, columns: tuple):
        """The model-axis objective of the primary FE's rank block
        (``"dense"`` or ``"sparse"``), built once per block."""
        key = (kind, columns)
        if key not in self._model_objectives:
            cls = FeatureShardedDenseGLMObjective if kind == "dense" \
                else ColumnShardedGLMObjective
            self._model_objectives[key] = cls(
                self._loss, self.mesh, l2_weight=self.fe.l2_weight,
                normalization=block_normalization(self.normalization, columns),
                use_kernel=self._fe_objective.use_kernel)
        return self._model_objectives[key]

    # -- state / input preparation ------------------------------------------

    def init_state(self, dataset: GameDataset, re_datasets: Mapping[str, RandomEffectDataset],
                   mf_datasets: Mapping[str, MFDataset] | None = None,
                   dtype: torch.dtype | None = None) -> GameTrainState:
        """Zero coefficients, and MF factors from ``init_factors`` with the
        rows of entities no bucket trains zeroed (their random draws would
        leak noise into their scores)."""
        device = dataset.device
        shard = dataset.feature_shards[self.fe.feature_shard_id]
        dtype = solve_dtype_of(dtype or shard.dtype)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        mf_rows, mf_cols = {}, {}
        for m in self.mf_specs:
            mf = (mf_datasets or {})[m.name]
            row, col = init_factors(mf.num_row_entities, mf.num_col_entities,
                                    m.num_latent_factors, seed=m.seed, dtype=dtype, device=device)
            row_mask, col_mask = (torch.from_numpy(mask).to(device).unsqueeze(1)
                                  for mask in mf.trained_masks())
            mf_rows[m.name] = torch.where(row_mask, row, torch.zeros_like(row))
            mf_cols[m.name] = torch.where(col_mask, col, torch.zeros_like(col))
        return GameTrainState(
            fe_coefficients=zeros(shard.shape[1]),
            re_tables={s.re_type: zeros(re_datasets[s.re_type].num_entities,
                                        re_datasets[s.re_type].table_width)
                       for s in self.re_specs},
            mf_rows=mf_rows, mf_cols=mf_cols,
            extra_fe={s.feature_shard_id: zeros(dataset.feature_shards[s.feature_shard_id].shape[1])
                      for s in self.extra_fes},
        )

    def _attach_re_sparse(self, data: dict, dataset: GameDataset,
                          re_datasets: Mapping[str, RandomEffectDataset]) -> dict:
        """Compact (sparse-shard) RE coordinates: each entry's (entity, table
        position, row, value) against the TRAINING active-column lists, for
        O(nnz) scoring inside the step (``data["re_sparse"]``)."""
        for s in self.re_specs:
            shard = dataset.feature_shards[s.feature_shard_id]
            if not isinstance(shard, SparseShard):
                continue
            ds = re_datasets.get(s.re_type) if re_datasets else None
            if ds is None or ds.active_cols is None:
                raise ValueError(
                    f"random-effect coordinate '{s.re_type}' uses a sparse "
                    "feature shard; its RandomEffectDataset (with "
                    "active_cols) is required to prepare inputs"
                )
            ent, pos, rows, vals = compact_entry_positions(
                shard, dataset.host_array(f"entity_idx/{s.re_type}"), ds.active_cols)
            norm = self._re_objectives[s.re_type].normalization
            if norm.factors is not None:
                # the table lives in normalized space, so the entries take
                # x' = x·factor[col] (SCALE only), in coalesced order
                _, cols_s, _ = shard.coalesced()
                vals = vals * host_factors(norm).astype(vals.dtype)[np.asarray(cols_s)]
            device = dataset.device
            data.setdefault("re_sparse", {})[s.re_type] = CompactEntries(
                key=(device, None, None),
                ent=device_tensor(ent, torch.int32, device),
                pos=device_tensor(pos, torch.int32, device),
                rows=device_tensor(rows, torch.int32, device),
                vals=device_tensor(vals, shard.dtype, device),
                num_samples=dataset.num_samples)
        return data

    def prepare_inputs(self, dataset: GameDataset,
                       re_datasets: Mapping[str, RandomEffectDataset],
                       mf_datasets: Mapping[str, MFDataset] | None = None):
        """(data, buckets) of :meth:`step`."""
        data = _data_pytree(dataset, self.re_specs, self.fe.feature_shard_id, self.mf_specs,
                            extra_fe_shards=tuple(self._extra_fe_by_name))
        data = self._attach_re_sparse(data, dataset, re_datasets)
        buckets = _buckets_pytree(
            {s.re_type: re_datasets[s.re_type] for s in self.re_specs}, self.re_specs,
            normalized_re_types={k for k in self._re_solve_objectives
                                 if self._re_solve_objectives[k] is not self._re_objectives[k]})
        buckets["__mf__"] = {
            m.name: {
                side: [{"labels": b.labels, "weights": b.weights, "sample_rows": b.sample_rows,
                        "entity_rows": b.entity_rows} for b in side_buckets]
                for side, side_buckets in (("row", (mf_datasets or {})[m.name].row_buckets),
                                           ("col", (mf_datasets or {})[m.name].col_buckets))
            }
            for m in self.mf_specs
        }
        return data, buckets

    # -- the mesh layout -----------------------------------------------------

    def _check_feature_sharded(self, mesh, fe_feature_sharded: bool) -> bool:
        """Whether the inputs lay the FE out over the model axis; the
        program must have been built for the same layout."""
        sharded = bool(fe_feature_sharded) and mesh_ops.model_size(mesh) > 1
        if sharded != self._model_axis or (self.mesh is not None and self.mesh is not mesh):
            raise ValueError(
                f"inputs with fe_feature_sharded={fe_feature_sharded} over a mesh with "
                f"model={mesh_ops.model_size(mesh)} need the program built with the same mesh "
                f"and flag: GameTrainProgram(..., mesh=mesh, fe_feature_sharded="
                f"{fe_feature_sharded})")
        return sharded

    def _shard_fe_columns(self, out: dict, mesh, rows: slice) -> None:
        """The rank's FE column block (``out["fe_columns"]``): a dense block
        padded with zero columns to the model axis, or the sparse shard's
        rows grouped into column blocks of which the rank keeps its own."""
        fe = self.fe.feature_shard_id
        device = out["labels"].device
        if "fe_sparse_shard" in out:
            local = sparse_shard_rows(out["fe_sparse_shard"], rows)
            columns = fe_columns_of(int(local.feature_dim), mesh)
            out["fe_column_batch"] = build_column_sharded_batch(
                local, out["labels"].cpu().numpy(), mesh_ops.model_size(mesh),
                offsets=np.zeros(local.num_samples), weights=out["weights"].cpu().numpy(),
                only_block=mesh_ops.model_rank(mesh), device=device)
            out.pop("fe_sparse_batch", None)
            out.pop("fe_sparse_shard", None)
        else:
            x = out["features"][fe]
            columns = fe_columns_of(int(x.shape[1]), mesh)
            out["features"][fe] = feature_block(x, columns)
        out["fe_columns"] = columns

    def _shard_data(self, mesh, data, *, put_fn=None, fe_feature_sharded: bool = False) -> dict:
        """This rank's rows of a data pytree (training or scoring) whose
        sample axis divides the mesh's data axis (``pad_game_dataset``);
        with ``fe_feature_sharded`` over a model axis, the rank's FE
        columns of those rows."""
        mesh_ops.check_data_mesh(mesh)
        sharded = self._check_feature_sharded(mesh, fe_feature_sharded)
        n = int(data["labels"].shape[0])
        rows = mesh_ops.row_block(n, mesh)
        device = data["labels"].device
        put = put_fn if put_fn is not None else mesh_ops.default_put(device)
        out = {
            "labels": put(data["labels"], rows),
            "offsets": put(data["offsets"], rows),
            "weights": put(data["weights"], rows),
            "features": {k: put(v, rows) for k, v in data["features"].items()},
            "entity_idx": {k: put(v, rows) for k, v in data["entity_idx"].items()},
            "mesh": MeshLayout(mesh=mesh, rows=rows, num_rows=n),
        }
        mf_types = {t for m in self.mf_specs for t in (m.row_effect_type, m.col_effect_type)}
        if mf_types:
            # a lane's samples lie on every rank: the other side's entity of
            # each sample is read from the whole [n] index vector
            out["entity_idx_full"] = {t: data["entity_idx"][t].to(device) for t in mf_types}
        if sharded:
            if "fe_sparse_shard" in data:
                out["fe_sparse_shard"] = data["fe_sparse_shard"]
            self._shard_fe_columns(out, mesh, rows)
        elif "fe_sparse_shard" in data:
            local = sparse_shard_rows(data["fe_sparse_shard"], rows)
            out["fe_sparse_shard"] = local
            out["fe_sparse_batch"] = SparseLabeledPointBatch.from_shard(
                local, out["labels"], torch.zeros_like(out["offsets"]), out["weights"],
                device=device)
        if "re_sparse" in data:
            out["re_sparse"] = {k: _entries_rows(e, rows) for k, e in data["re_sparse"].items()}
        return out

    def shard_inputs(self, mesh, data, buckets, state: GameTrainState, *,
                     fe_feature_sharded: bool = False, put_fn=None):
        """(data, buckets, state) of this rank: its rows of the sample axis,
        its block of each bucket's entity lanes (each bucket padded first to
        a multiple of the data axis with lanes that train nothing), and the
        whole state on its device (over a model axis, with
        ``fe_feature_sharded``, the rank's FE columns and FE block). ``data``
        must come from a dataset padded to a multiple of the data axis
        (``train_distributed`` pads).

        put_fn: (tensor, rows) -> this rank's block of those rows on its
        device (``parallel/mesh.default_put``)."""
        out = self._shard_data(mesh, data, put_fn=put_fn, fe_feature_sharded=fe_feature_sharded)
        layout: MeshLayout = out["mesh"]
        device = out["labels"].device
        put = put_fn if put_fn is not None else mesh_ops.default_put(device)
        size, rank = mesh_ops.data_size(mesh), mesh_ops.data_rank(mesh)

        def split(bucket_list, key):
            every = [[] for _ in range(size)]
            local = []
            for b in bucket_list:
                b = pad_lane_fields(b, size)
                per = int(b["entity_rows"].shape[0]) // size
                lanes = slice(rank * per, (rank + 1) * per)
                local.append({k: None if v is None else put(v, lanes) for k, v in b.items()})
                rows = b["entity_rows"].long().cpu()
                for r in range(size):
                    every[r].append(rows[r * per:(r + 1) * per])
            _lane_owners(layout, key, every, rank, device)
            return local

        sharded = {k: split(bs, k) for k, bs in buckets.items()
                   if k not in ("__mf__", "__projections__")}
        if "__projections__" in buckets:
            sharded["__projections__"] = {k: torch.as_tensor(v, device=device)
                                          for k, v in buckets["__projections__"].items()}
        if "__mf__" in buckets:
            sharded["__mf__"] = {name: {side: split(bs, f"{name}/{side}")
                                        for side, bs in sides.items()}
                                 for name, sides in buckets["__mf__"].items()}
        state = GameTrainState(
            fe_coefficients=state.fe_coefficients.to(device),
            re_tables={k: v.to(device) for k, v in state.re_tables.items()},
            mf_rows={k: v.to(device) for k, v in state.mf_rows.items()},
            mf_cols={k: v.to(device) for k, v in state.mf_cols.items()},
            extra_fe={k: v.to(device) for k, v in state.extra_fe.items()},
            fe_columns=state.fe_columns)
        if "fe_columns" in out:
            state = self._split_state(state, out["fe_columns"][2])
        return out, sharded, state

    def shard_scoring_inputs(self, mesh, data, *, fe_feature_sharded: bool = False,
                             put_fn=None) -> dict:
        """This rank's rows of :meth:`prepare_scoring_inputs`' data (and its
        FE columns over a model axis)."""
        return self._shard_data(mesh, data, put_fn=put_fn, fe_feature_sharded=fe_feature_sharded)

    # -- the fused step ------------------------------------------------------

    def step(self, data, buckets, state: GameTrainState):
        """One full CD sweep. Returns (new_state, training_loss), the loss a
        0-dim tensor on the device."""
        return self._step(data, buckets, state)

    def _step_impl(self, data, buckets, state: GameTrainState):
        return self._sweep(data, buckets, state)

    def step_scheduled(self, data, buckets, state: GameTrainState, *,
                       schedulers: Mapping[str, object], final_sweep: bool = True):
        """One full CD sweep with probe/rescue lane scheduling on the random
        effects (``algorithm/lane_scheduler.py``): the recursion of
        :meth:`step` in the same ``update_order``, each scheduled random
        effect solved by its scheduler, which reads the per-lane flags
        between the probe and the rescue and compacts the lanes still
        running. The fixed effects solve as in :meth:`step` (B1 on a dense
        block, G1 on a sparse one).

        schedulers: RE type -> LaneScheduler, kept by the caller across
        sweeps (its active set lives there); REs absent from it solve
        unscheduled. Over a mesh each rank schedules its own lanes."""
        return self._sweep(data, buckets, state, schedulers, final_sweep)

    def _sweep(self, data, buckets, state: GameTrainState, schedulers=None,
               final_sweep: bool = True):
        labels, weights = data["labels"], data["weights"]
        base_offsets = data["offsets"]
        layout: MeshLayout | None = data.get("mesh")
        f = self._pieces
        # `scores` holds each coordinate's score at its LATEST coefficients,
        # so a coordinate solved later in the sweep sees the residuals of
        # the ones already updated
        scores = f["scores"](data, state)

        def offsets_excluding(skip=None):
            return f["offsets"](base_offsets, scores, skip)

        fe_w = state.fe_coefficients
        extra_fe = dict(state.extra_fe)
        tables = dict(state.re_tables)
        mf_rows = dict(state.mf_rows)
        mf_cols = dict(state.mf_cols)
        for name in self.update_order:
            kind = self._kind[name]
            if kind == "fe":
                fe_w = f["fe_solve"](data, offsets_excluding(name), weights, fe_w)
                scores[name] = f["fe_margin"](data, fe_w)
            elif kind == "extra_fe":
                extra_fe[name] = f["extra_fe_solve"](data, name, offsets_excluding(name),
                                                     labels, weights, extra_fe[name])
                scores[name] = f["extra_fe_margin"](data, name, extra_fe[name])
            elif kind == "re":
                full_offsets = offsets_excluding(name)
                if layout is not None:
                    full_offsets = layout.gather(full_offsets)
                scheduler = (schedulers or {}).get(name)
                if scheduler is None:
                    tables[name] = f["re_solve"](data, buckets, name, full_offsets,
                                                 tables[name], layout)
                else:
                    tables[name] = self._solve_re_scheduled(buckets, name, full_offsets,
                                                            tables[name], layout, scheduler,
                                                            final_sweep)
                if layout is not None and name not in layout.per_bucket:
                    tables[name] = layout.share(name, tables[name])
                scores[name] = f["re_score"](
                    data, name, tables[name], self._re_by_name[name].feature_shard_id)
            else:  # mf
                full_offsets = offsets_excluding(name)
                if layout is not None:
                    full_offsets = layout.gather(full_offsets)
                mf_rows[name], mf_cols[name], scores[name] = f["mf_solve"](
                    data, buckets, name, full_offsets, mf_rows[name], mf_cols[name])
        train_loss = f["loss"](labels, weights, offsets_excluding(), layout)
        new_state = GameTrainState(fe_coefficients=fe_w, re_tables=tables, mf_rows=mf_rows,
                                   mf_cols=mf_cols, extra_fe=extra_fe,
                                   fe_columns=state.fe_columns)
        return new_state, train_loss

    def _weighted_loss(self, labels, weights, total_margin, layout=None) -> torch.Tensor:
        losses = self._loss.loss(total_margin, labels)
        wl, ws = torch.sum(weights * losses), torch.sum(weights)
        if layout is not None:
            wl, ws = layout.total(torch.stack([wl, ws]))
        return wl / torch.clamp(ws, min=1.0)

    @staticmethod
    def _sum_scores(base, scores, skip=None):
        """base + every coordinate score except ``skip``: the residual
        offsets of the CD recursion."""
        total = base
        for k, v in scores.items():
            if k != skip:
                total = total + v
        return total

    # -- whole-model scoring (validation / best-state tracking) --------------

    def prepare_scoring_inputs(self, dataset: GameDataset,
                               re_datasets: Mapping[str, RandomEffectDataset] | None = None
                               ) -> dict:
        """Data for :meth:`score` over any dataset (a validation split); no
        buckets. Compact RE coordinates need ``re_datasets`` (the TRAINING
        datasets: their active-column lists define the tables' layout)."""
        data = _data_pytree(dataset, self.re_specs, self.fe.feature_shard_id, self.mf_specs,
                            extra_fe_shards=tuple(self._extra_fe_by_name))
        return self._attach_re_sparse(data, dataset, re_datasets or {})

    def score(self, data, state: GameTrainState) -> torch.Tensor:
        """[n] total scores (margins including the data offsets) at ``state``
        (reference GameModel.scoreAndValidate, CoordinateDescent.scala:291-356);
        over a mesh, the scores of this rank's rows."""
        return self._score(data, state)

    def _score_impl(self, data, state: GameTrainState) -> torch.Tensor:
        total = data["offsets"]
        for v in self._coordinate_scores(data, state).values():
            total = total + v
        return total

    # -- scoring helpers shared by the step and the variances ----------------

    def _re_coordinate_score(self, data, k: str, table: torch.Tensor,
                             shard_id: str) -> torch.Tensor:
        """An RE coordinate's scores from its (normalized-space) table: the
        effective coefficients, less each entity's margin shift when the
        coordinate is standardized; a compact table through its entries
        (both the table and the entry values in normalized space, so no
        shift term)."""
        entries = data.get("re_sparse", {}).get(k)
        if entries is not None:
            return entries.score(table)
        norm = self._re_objectives[k].normalization
        eff = norm.effective_coefficients(table)
        idx = data["entity_idx"][k]
        scores = score_random_effect(eff, data["features"][shard_id], idx)
        if norm.shifts is not None and eff.shape[0]:
            ent_shift = eff @ norm.shifts
            safe = torch.clamp(idx.long(), min=0)
            scores = scores - torch.where(idx >= 0, ent_shift[safe], torch.zeros_like(scores))
        return scores

    def _fe_margin_score(self, data, fe_w: torch.Tensor) -> torch.Tensor:
        """The primary FE's pure margin (no offsets) from normalized-space
        coefficients, dense or sparse (over a model axis: the rank's
        columns' partial margins, all-reduced over "model")."""
        if "fe_columns" in data:
            batch, objective = self._model_axis_batch(data)
            return objective.product(fe_w, batch)
        fe_sparse = data.get("fe_sparse_batch")
        if fe_sparse is not None:
            objective = self._fe_sparse_objective
            eff = objective.normalization.effective_coefficients(fe_w)
            return feature_product(fe_sparse, eff, use_kernel=objective.use_kernel) \
                - objective.normalization.margin_shift(eff)
        norm = self._fe_objective.normalization
        eff = norm.effective_coefficients(fe_w)
        x = data["features"][self.fe.feature_shard_id]
        return x.to(eff.dtype) @ eff - norm.margin_shift(eff)

    def _extra_fe_margin(self, data, shard_id: str, w: torch.Tensor) -> torch.Tensor:
        """Pure margin of an additional (dense) FE coordinate."""
        norm = self._extra_fe_objectives[shard_id].normalization
        eff = norm.effective_coefficients(w)
        return data["features"][shard_id].to(eff.dtype) @ eff - norm.margin_shift(eff)

    def _coordinate_scores(self, data, state: GameTrainState) -> dict:
        """name -> score of every coordinate at the state, in canonical
        order (FEs, REs, MFs), so residual sums add in a fixed order."""
        scores = {self.fe.feature_shard_id: self._fe_margin_score(data, state.fe_coefficients)}
        for s in self.extra_fes:
            scores[s.feature_shard_id] = self._extra_fe_margin(
                data, s.feature_shard_id, state.extra_fe[s.feature_shard_id])
        for s in self.re_specs:
            scores[s.re_type] = self._re_coordinate_score(
                data, s.re_type, state.re_tables[s.re_type], s.feature_shard_id)
        for m in self.mf_specs:
            scores[m.name] = score_matrix_factorization(
                state.mf_rows[m.name], state.mf_cols[m.name],
                data["entity_idx"][m.row_effect_type], data["entity_idx"][m.col_effect_type])
        return scores

    # -- the coordinates' solves ---------------------------------------------

    def _model_axis_batch(self, data):
        """(the rank's FE column block as a batch, its objective)."""
        columns = data["fe_columns"]
        if "fe_column_batch" in data:
            return data["fe_column_batch"], self._model_objective("sparse", columns)
        return LabeledPointBatch(
            features=data["features"][self.fe.feature_shard_id], labels=data["labels"],
            offsets=data["offsets"], weights=data["weights"]), \
            self._model_objective("dense", columns)

    def _primary_fe_batch(self, data, offsets, weights):
        """The primary FE's batch at ``offsets`` and ``weights``, with its
        objective."""
        if "fe_columns" in data:
            batch, objective = self._model_axis_batch(data)
            if isinstance(batch, LabeledPointBatch):
                return dataclasses.replace(batch, offsets=offsets, weights=weights), objective
            return batch.replace(offsets=offsets, weights=weights), objective
        fe_sparse = data.get("fe_sparse_batch")
        on_mesh = "mesh" in data
        if fe_sparse is not None:
            return fe_sparse.replace(offsets=offsets, weights=weights), (
                self._mesh_objectives["sparse"] if on_mesh else self._fe_sparse_objective)
        return LabeledPointBatch(features=data["features"][self.fe.feature_shard_id],
                                 labels=data["labels"], offsets=offsets, weights=weights), (
            self._mesh_objectives["dense"] if on_mesh else self._fe_objective)

    def _solve_primary_fe(self, data, fe_offsets, weights, fe_w0):
        """The primary FE solve. Down-sampling multiplies only this solve's
        weights (0 = dropped, 1/rate = kept negative). The result stays in
        normalized space."""
        mult = data.get("fe_weight_multiplier")
        batch, objective = self._primary_fe_batch(
            data, fe_offsets, weights if mult is None else weights * mult)
        return solve(self.fe.optimizer, objective.bind(batch), fe_w0).coefficients

    def _solve_extra_fe(self, data, name, full_offsets, labels, weights, w0):
        """An additional (dense) FE coordinate, with the primary's residual
        and down-sampling contract."""
        mult = data.get("extra_fe_weight_multipliers", {}).get(name)
        batch = LabeledPointBatch(features=data["features"][name], labels=labels,
                                  offsets=full_offsets,
                                  weights=weights if mult is None else weights * mult)
        spec = self._extra_fe_by_name[name]
        objective = (self._mesh_objectives[name] if "mesh" in data
                     else self._extra_fe_objectives[name])
        return solve(spec.optimizer, objective.bind(batch), w0).coefficients

    def _solve_re(self, data, buckets, k, full_offsets, table, layout=None):
        """One RE coordinate: a lane-batched solve per bucket (over a mesh
        whose key shares per bucket, each bucket's rows shared after it)."""
        spec = self._re_by_name[k]
        objective = self._re_solve_objectives[k]
        opt = spec.optimizer
        if spec.projector == ProjectorType.INDEX_MAP:
            # scratch-column solve in each entity's observed columns
            # (IndexMapProjectorRDD.scala:218-257)
            table_ext = _with_scratch_column(table)
            for b in buckets[k]:
                table_ext = solve_entity_bucket_indexmap(
                    objective, opt, b["features"], b["labels"], b["weights"], b["sample_rows"],
                    b["entity_rows"], b["col_index"], full_offsets, table_ext)
            return table_ext[:, :-1]
        if spec.projector == ProjectorType.RANDOM:
            matrix = torch.as_tensor(buckets["__projections__"][k], dtype=table.dtype,
                                     device=table.device)
            for b in buckets[k]:
                table = solve_entity_bucket_random(
                    objective, opt, b["features"], b["labels"], b["weights"], b["sample_rows"],
                    b["entity_rows"], matrix, full_offsets, table)
            return table
        per_bucket = layout is not None and k in layout.per_bucket
        for i, b in enumerate(buckets[k]):
            table = solve_entity_bucket(objective, opt, b["features"], b["labels"],
                                        b["weights"], b["sample_rows"], b["entity_rows"],
                                        full_offsets, table)
            if per_bucket:
                table = layout.share_bucket(k, i, table)
        return table

    def _solve_re_scheduled(self, buckets, k, full_offsets, table, layout, scheduler,
                            final_sweep: bool):
        """One RE coordinate through its lane scheduler (compaction across
        buckets, so a mesh key that shares per bucket is refused)."""
        if layout is not None and k in layout.per_bucket:
            raise ValueError(
                f"random-effect coordinate '{k}': the lane scheduler compacts lanes across "
                "buckets, but over this mesh an entity has lanes in several buckets, whose "
                "rows are shared after each bucket; drop its scheduler")
        spec = self._re_by_name[k]
        matrix = None
        if spec.projector == ProjectorType.RANDOM:
            matrix = torch.as_tensor(buckets["__projections__"][k], dtype=table.dtype,
                                     device=table.device)
        table, _traces, _stats = scheduler.solve(
            self._re_solve_objectives[k], spec.optimizer, buckets[k], full_offsets, table,
            projector=spec.projector, matrix=matrix, final_sweep=final_sweep)
        return table

    def _solve_mf(self, data, buckets, name, full_offsets, rows, cols):
        """One MF coordinate's alternating half-steps. Returns (rows, cols,
        score)."""
        m = self._mf_by_name[name]
        row_idx = data["entity_idx"][m.row_effect_type]
        col_idx = data["entity_idx"][m.col_effect_type]
        layout: MeshLayout | None = data.get("mesh")
        # the lanes' samples index the whole sample axis
        full_idx = data.get("entity_idx_full", data["entity_idx"])
        objective = self._mf_objectives[name]
        mf_buckets = buckets["__mf__"][name]
        for _ in range(m.num_alternations):
            for b in mf_buckets["row"]:
                rows, _ = solve_mf_side_bucket(objective, m.optimizer, b["labels"], b["weights"],
                                               b["entity_rows"], b["sample_rows"],
                                               full_idx[m.col_effect_type], cols,
                                               full_offsets, rows)
            if layout is not None:
                rows = layout.share(f"{name}/row", rows)
            for b in mf_buckets["col"]:
                cols, _ = solve_mf_side_bucket(objective, m.optimizer, b["labels"], b["weights"],
                                               b["entity_rows"], b["sample_rows"],
                                               full_idx[m.row_effect_type], rows,
                                               full_offsets, cols)
            if layout is not None:
                cols = layout.share(f"{name}/col", cols)
        return rows, cols, score_matrix_factorization(rows, cols, row_idx, col_idx)


def compute_state_variances(
    program: GameTrainProgram,
    state: GameTrainState,
    dataset: GameDataset,
    re_datasets: Mapping[str, RandomEffectDataset] | None = None,
    *,
    variance_mode: str = "auto",
    re_types: "set[str] | None" = None,
) -> tuple[torch.Tensor, dict, dict]:
    """Post-hoc coefficient variances of a fused-trained state:
    (fe_variances, {re_type: [E, d] table}, {extra_fe_shard: [d]}), in
    original model space, NaN rows for entities no bucket trained.

    Each coordinate's Hessian is evaluated at the state with every other
    coordinate's score as residual offset (the reference computes them
    inside each optimization problem at the optimum). ``re_types`` selects
    the RE coordinates (None = all). INDEX_MAP and compact variances are
    computed in the solve space and scattered back through the column
    index; RANDOM ones propagate through the sketch as diag(P H_k⁻¹ Pᵀ).
    """
    validate_variance_mode(variance_mode)
    selected = [s for s in program.re_specs if re_types is None or s.re_type in re_types]
    if program.re_specs:
        missing = [s.re_type for s in program.re_specs
                   if re_datasets is None or s.re_type not in re_datasets]
        if missing:
            raise ValueError(
                "compute_state_variances needs re_datasets entries for the "
                f"program's random-effect coordinates; missing: {missing}"
            )
    state = program.whole_state(state)
    data = program.prepare_scoring_inputs(dataset, re_datasets)
    base_offsets, weights = data["offsets"], data["weights"]
    scores = program._coordinate_scores(data, state)

    def offsets_excluding(skip=None):
        return program._sum_scores(base_offsets, scores, skip)

    fe_batch, fe_objective = program._primary_fe_batch(
        data, offsets_excluding(program.fe.feature_shard_id), weights)
    fe_variances = fe_objective.normalization.variances_to_model_space(
        coefficient_variances(fe_objective, state.fe_coefficients, fe_batch, mode=variance_mode))
    extra_fe_variances: dict = {}
    for s in program.extra_fes:
        k = s.feature_shard_id
        objective = program._extra_fe_objectives[k]
        batch = LabeledPointBatch(features=data["features"][k], labels=data["labels"],
                                  offsets=offsets_excluding(k), weights=weights)
        extra_fe_variances[k] = objective.normalization.variances_to_model_space(
            coefficient_variances(objective, state.extra_fe[k], batch, mode=variance_mode))

    re_variances: dict = {}
    for spec in selected:
        ds = re_datasets[spec.re_type]
        table = state.re_tables[spec.re_type]
        full_offsets = offsets_excluding(spec.re_type)
        max_bucket = max((b.num_entities for b in ds.buckets), default=1)
        norm = program._re_objectives[spec.re_type].normalization
        objective = program._re_solve_objectives[spec.re_type]
        var_table = torch.full_like(table, float("nan"))
        if spec.projector == ProjectorType.RANDOM:
            matrix = torch.as_tensor(ds.projection.matrix, dtype=table.dtype, device=table.device)
            mode = random_variance_mode(variance_mode, ds.dim, matrix.shape[1], max_bucket)
            for b in ds.buckets:
                var_table = bucket_variances_random(objective, b, full_offsets, matrix, table,
                                                    var_table, mode)
        elif spec.projector == ProjectorType.INDEX_MAP:
            width = max((int(b.features.shape[2]) for b in ds.buckets), default=1)
            mode = resolve_variance_mode(variance_mode, width, num_problems=max_bucket)
            table_ext, var_ext = _with_scratch_column(table), _with_scratch_column(var_table)
            for b in ds.buckets:
                var_ext = bucket_variances_indexmap(objective, b, full_offsets, table_ext,
                                                    var_ext, mode)
            var_table = var_ext[:, :-1]
            if ds.is_compact:
                re_variances[spec.re_type] = norm.variances_to_model_space_compact(
                    var_table, ds.active_cols_on(table.device))
                continue
        else:
            mode = resolve_variance_mode(variance_mode, ds.dim, num_problems=max_bucket)
            for b in ds.buckets:
                var_table = bucket_variances(objective, b, full_offsets, table, var_table, mode)
        re_variances[spec.re_type] = norm.variances_to_model_space(var_table)
    return fe_variances, re_variances, extra_fe_variances


def state_to_game_model(
    program: GameTrainProgram,
    state: GameTrainState,
    dataset: GameDataset,
    *,
    intercept_index: int | None = None,
    compute_variance: bool = False,
    variance_mode: str = "auto",
    re_datasets: Mapping[str, RandomEffectDataset] | None = None,
    variance_re_types: "set[str] | None" = None,
) -> GameModel:
    """A fused-trained state as a ``GameModel`` in original space, for
    ``io/model_io`` and ``GameTransformer``. The FE coordinate is named after
    its shard, RE coordinates after their type, MF coordinates after their
    spec name. ``compute_variance`` attaches :func:`compute_state_variances`.
    A state holding an FE column block is gathered first (a collective over
    the model axis: every rank calls this)."""
    state = program.whole_state(state)
    fe_variances = None
    re_variances: dict = {}
    extra_fe_variances: dict = {}
    if compute_variance:
        fe_variances, re_variances, extra_fe_variances = compute_state_variances(
            program, state, dataset, re_datasets, variance_mode=variance_mode,
            re_types=variance_re_types)
    task = program.task
    models: dict = {program.fe.feature_shard_id: FixedEffectModel(
        glm=GeneralizedLinearModel(Coefficients(
            means=program.fe_coefficients_model_space(state, intercept_index),
            variances=fe_variances), task),
        feature_shard_id=program.fe.feature_shard_id)}
    for s in program.extra_fes:
        k = s.feature_shard_id
        norm = program._extra_fe_objectives[k].normalization
        models[k] = FixedEffectModel(
            glm=GeneralizedLinearModel(Coefficients(
                means=norm.to_model_space(state.extra_fe[k], s.intercept_index),
                variances=extra_fe_variances.get(k)), task),
            feature_shard_id=k)
    for spec in program.re_specs:
        # tables leave in original space (factors only for a compact one)
        re_norm = program._re_objectives[spec.re_type].normalization
        ds = (re_datasets or {}).get(spec.re_type)
        is_compact = ds is not None and ds.active_cols is not None
        if isinstance(dataset.feature_shards[spec.feature_shard_id], SparseShard) \
                and not is_compact:
            raise ValueError(
                f"random-effect coordinate '{spec.re_type}' trained on a "
                "sparse shard; pass its RandomEffectDataset via re_datasets "
                "so the compact model keeps its active-column lists"
            )
        table = state.re_tables[spec.re_type]
        models[spec.re_type] = RandomEffectModel(
            coefficients=(re_norm.to_model_space_compact(table, ds.active_cols_on(table.device))
                          if is_compact else re_norm.to_model_space(table, spec.intercept_index)),
            entity_keys=dataset.entity_vocabs[spec.re_type],
            random_effect_type=spec.re_type,
            feature_shard_id=spec.feature_shard_id,
            task=task,
            variances=re_variances.get(spec.re_type),
            active_cols=ds.active_cols if is_compact else None,
            feature_dim=ds.dim if is_compact else None,
        )
    for m in program.mf_specs:
        models[m.name] = MatrixFactorizationModel(
            row_factors=state.mf_rows[m.name], col_factors=state.mf_cols[m.name],
            row_effect_type=m.row_effect_type, col_effect_type=m.col_effect_type,
            row_keys=dataset.entity_vocabs[m.row_effect_type],
            col_keys=dataset.entity_vocabs[m.col_effect_type], task=task)
    return GameModel(models=models)


def _entries_rows(entries: CompactEntries, rows: slice) -> CompactEntries:
    """The entries of rows ``[rows.start, rows.stop)`` (entries are
    row-sorted), with rows counted from ``rows.start``."""
    bounds = torch.tensor([rows.start, rows.stop], dtype=entries.rows.dtype,
                          device=entries.rows.device)
    lo, hi = (int(i) for i in torch.searchsorted(entries.rows, bounds))
    return CompactEntries(
        key=entries.key, ent=entries.ent[lo:hi], pos=entries.pos[lo:hi],
        rows=entries.rows[lo:hi] - rows.start, vals=entries.vals[lo:hi],
        num_samples=rows.stop - rows.start)


def _remap_compact_rows(values: np.ndarray, model_cols: np.ndarray | None,
                        target_cols: np.ndarray, dim: int) -> np.ndarray:
    """Re-key per-entity coefficient rows onto new active-column lists.

    values: [E, Km] compact (with model_cols [E, Km], sorted, pad=dim) or
    [E, dim] dense (model_cols None). target_cols: [E, Kt] sorted pad=dim.
    Returns [E, Kt]; columns absent from the source row are 0.
    """
    e, kt = target_cols.shape
    if model_cols is None:  # dense source: a plain per-row gather
        safe = np.minimum(target_cols, dim - 1)
        out = values[np.arange(e)[:, None], safe]
        return (out * (target_cols < dim)).astype(values.dtype)
    ent = np.repeat(np.arange(e, dtype=np.int64), kt)
    pos = match_active_positions(ent, target_cols.ravel(), model_cols, dim)
    vals_ext = np.concatenate([values, np.zeros((e, 1), values.dtype)], axis=1)
    return vals_ext[ent, pos].reshape(e, kt).astype(values.dtype)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def game_model_to_state(
    program: GameTrainProgram,
    model: GameModel,
    dataset: GameDataset,
    *,
    intercept_index: int | None = None,
    missing_ok: bool = False,
    re_datasets: Mapping[str, RandomEffectDataset] | None = None,
    mf_datasets: Mapping[str, MFDataset] | None = None,
) -> GameTrainState:
    """Inverse of :func:`state_to_game_model`: warm-start the step from a
    (possibly loaded) GameModel on the dataset's device.

    Tables are re-aligned to the dataset's entity vocabs by key, so a model
    saved against one dataset warm-starts another whose vocab order
    differs; entities absent from the model start at zero. The FE vector
    goes into normalized space. ``missing_ok`` cold-starts any coordinate
    the model lacks (zeros, fresh factors) instead of raising (reference
    GameEstimator.getInitialModel); it needs ``re_datasets`` /
    ``mf_datasets`` for those coordinates' shapes.
    """
    device = dataset.device

    def coordinate_model(cid: str):
        try:
            return model.get(cid)
        except KeyError:
            if missing_ok:
                return None
            raise

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(a, device=device)

    norm = program._fe_objective.normalization
    fe_model = coordinate_model(program.fe.feature_shard_id)
    fe_shard = dataset.feature_shards[program.fe.feature_shard_id]
    if fe_model is None:
        fe_w = torch.zeros((fe_shard.shape[1],), dtype=solve_dtype_of(fe_shard.dtype),
                           device=device)
    else:
        fe_w = norm.from_model_space(fe_model.glm.coefficients.means.to(device),
                                     intercept_index)
    dtype = fe_w.dtype
    extra_fe: dict = {}
    for s in program.extra_fes:
        k = s.feature_shard_id
        m = coordinate_model(k)
        if m is None:
            extra_fe[k] = torch.zeros((dataset.feature_shards[k].shape[1],), dtype=dtype,
                                      device=device)
        else:
            extra_fe[k] = program._extra_fe_objectives[k].normalization.from_model_space(
                m.glm.coefficients.means.to(device), s.intercept_index)

    def align(table, model_keys, vocab, coordinate: str) -> np.ndarray:
        table = _host(table)
        row_of = {k: i for i, k in enumerate(np.asarray(model_keys).tolist())}
        pairs = [(i, row_of[key]) for i, key in enumerate(np.asarray(vocab).tolist())
                 if key in row_of]
        if not pairs and len(row_of) and len(vocab):
            # a warm start that matches nothing is almost certainly the wrong
            # model/vocab pairing: fail loudly, not to a silent cold start
            raise ValueError(
                f"warm-start model for coordinate '{coordinate}' shares no "
                f"entity keys with the dataset vocab ({len(row_of)} model "
                f"keys vs {len(vocab)} vocab keys) — wrong model directory "
                "or entity namespace?"
            )
        out = np.zeros((len(vocab), table.shape[1]), dtype=table.dtype)
        if pairs:
            vi, mi = (np.asarray(p, dtype=np.intp) for p in zip(*pairs))
            out[vi] = table[mi]
        return out

    re_tables: dict = {}
    for spec in program.re_specs:
        m = coordinate_model(spec.re_type)
        ds = (re_datasets or {}).get(spec.re_type)
        ds_compact = ds is not None and ds.active_cols is not None
        vocab = dataset.entity_vocabs[spec.re_type]
        if m is None:
            if ds is None:
                raise ValueError(
                    f"missing_ok warm start: coordinate '{spec.re_type}' is "
                    "absent from the model AND re_datasets — cannot size the "
                    "cold-start table"
                )
            re_tables[spec.re_type] = torch.zeros((ds.num_entities, ds.table_width),
                                                  dtype=dtype, device=device)
            continue
        aligned = align(m.coefficients, m.entity_keys, vocab, spec.re_type)
        model_compact = getattr(m, "active_cols", None) is not None
        if model_compact and not ds_compact:
            # a compact model warm-starting a DENSE dataset: expand each
            # entity's active columns into a dense row
            mc = align(m.active_cols, m.entity_keys, vocab, spec.re_type).astype(np.int64)
            e_rows = np.repeat(np.arange(aligned.shape[0]), mc.shape[1])
            flat_cols = mc.ravel()
            dim = int(dataset.feature_shards[spec.feature_shard_id].shape[1])
            live = flat_cols < dim
            dense = np.zeros((aligned.shape[0], dim), dtype=aligned.dtype)
            dense[e_rows[live], flat_cols[live]] = aligned.ravel()[live]
            aligned = dense
        elif ds_compact or model_compact:
            # compact layouts re-key per entity from the model's active
            # columns to the dataset's (columns absent from the new list are
            # dropped, new ones start at 0)
            model_cols = None
            if model_compact:
                model_cols = align(m.active_cols, m.entity_keys, vocab,
                                   spec.re_type).astype(np.int64)
                # rows absent from the model aligned to zeros: make them
                # all pads so nothing matches
                absent = ~np.isin(np.asarray(vocab).astype(str),
                                  np.asarray(m.entity_keys).astype(str))
                model_cols[absent] = ds.dim
            aligned = _remap_compact_rows(aligned, model_cols,
                                          np.asarray(ds.active_cols, dtype=np.int64), ds.dim)
        re_norm = program._re_objectives[spec.re_type].normalization
        re_tables[spec.re_type] = (
            re_norm.from_model_space_compact(tensor(aligned), ds.active_cols_on(device))
            if ds_compact else re_norm.from_model_space(tensor(aligned), spec.intercept_index))
    mf_rows: dict = {}
    mf_cols: dict = {}
    for spec in program.mf_specs:
        m = coordinate_model(spec.name)
        if m is None:
            mf = (mf_datasets or {}).get(spec.name)
            if mf is None:
                raise ValueError(
                    f"missing_ok warm start: MF coordinate '{spec.name}' is "
                    "absent from the model AND mf_datasets — cannot size the "
                    "cold-start factors"
                )
            row, col = init_factors(mf.num_row_entities, mf.num_col_entities,
                                    spec.num_latent_factors, seed=spec.seed, dtype=dtype,
                                    device=device)
            row_mask, col_mask = (torch.from_numpy(mask).to(device).unsqueeze(1)
                                  for mask in mf.trained_masks())
            mf_rows[spec.name] = torch.where(row_mask, row, torch.zeros_like(row))
            mf_cols[spec.name] = torch.where(col_mask, col, torch.zeros_like(col))
            continue
        model_k = int(m.row_factors.shape[1])
        if model_k != spec.num_latent_factors:
            raise ValueError(
                f"warm-start MF model for coordinate '{spec.name}' has "
                f"latent dimension {model_k} but the spec configures "
                f"num_latent_factors={spec.num_latent_factors} — retrain or "
                "match the spec to the saved model"
            )
        mf_rows[spec.name] = tensor(align(m.row_factors, m.row_keys,
                                          dataset.entity_vocabs[spec.row_effect_type], spec.name))
        mf_cols[spec.name] = tensor(align(m.col_factors, m.col_keys,
                                          dataset.entity_vocabs[spec.col_effect_type], spec.name))
    state = GameTrainState(fe_coefficients=fe_w, re_tables=re_tables, mf_rows=mf_rows,
                           mf_cols=mf_cols, extra_fe=extra_fe)
    # over a model axis the rank keeps its FE block
    return program._split_state(state, int(fe_w.shape[0]))


@dataclasses.dataclass
class DistributedTrainResult:
    """Result of :func:`train_distributed`; unpacks as ``(state, losses)``.
    ``best_state``/``best_metric``/``metric_history`` are set when
    validation evaluators were given (reference CoordinateDescent best-model
    tracking, :183-192, :323-356); ``best_state`` None means the final state
    is the best."""

    state: GameTrainState
    losses: list
    best_state: GameTrainState | None = None
    best_metric: float = float("nan")
    metric_history: list = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter((self.state, self.losses))


def _host_scores(scores: torch.Tensor, n: int, layout: MeshLayout | None = None) -> np.ndarray:
    """The first ``n`` scores on the host; over a mesh, every rank's rows
    gathered first (a collective: every rank calls it)."""
    if layout is not None:
        scores = layout.gather(scores)
    return scores.detach().cpu().numpy()[:n]


_STATE_GROUPS = ("re_tables", "mf_rows", "mf_cols", "extra_fe")


def _state_arrays(state: GameTrainState, prefix: str = "") -> dict:
    """A whole state's host arrays under the JAX package's checkpoint keys
    (``fe_coefficients``, ``re_tables/<type>``, ``mf_rows/<name>``, ...)."""
    arrays = {prefix + "fe_coefficients": host_array(state.fe_coefficients)}
    for group in _STATE_GROUPS:
        for k, v in getattr(state, group).items():
            arrays[f"{prefix}{group}/{k}"] = host_array(v)
    return arrays


def _state_from_arrays(arrays: Mapping[str, np.ndarray], device, prefix: str = ""
                       ) -> GameTrainState:
    def group(name):
        head = f"{prefix}{name}/"
        return {k[len(head):]: torch.as_tensor(v, device=device) for k, v in arrays.items()
                if k.startswith(head) and "/" not in k[len(head):]}

    return GameTrainState(
        fe_coefficients=torch.as_tensor(arrays[prefix + "fe_coefficients"], device=device),
        **{name: group(name) for name in _STATE_GROUPS})


def _state_to(state: GameTrainState, device) -> GameTrainState:
    return GameTrainState(fe_coefficients=state.fe_coefficients.to(device),
                          **{name: {k: v.to(device) for k, v in getattr(state, name).items()}
                             for name in _STATE_GROUPS})


def _restore_train_state(program: GameTrainProgram, ckpt, directory: str):
    """(state, best state or None) of a fused-program checkpoint on the CPU,
    checked against the program's coordinates."""
    if "fe_coefficients" not in ckpt.arrays:
        raise ValueError(
            f"checkpoint at {directory} is not a distributed-training checkpoint (no "
            f"'fe_coefficients' array; found keys like {sorted(ckpt.arrays)[:3]}). Pass "
            "resume=False or use a fresh checkpoint directory.")
    state = _state_from_arrays(ckpt.arrays, "cpu")
    expected = {"re_tables": {s.re_type for s in program.re_specs},
                "mf_rows": {m.name for m in program.mf_specs},
                "mf_cols": {m.name for m in program.mf_specs},
                "extra_fe": {s.feature_shard_id for s in program.extra_fes}}
    found = {name: set(getattr(state, name)) for name in _STATE_GROUPS}
    if expected != found:
        raise ValueError(
            f"checkpoint at {directory} is incompatible with the program's coordinate specs: "
            f"checkpoint has {found}, program expects {expected}. Pass resume=False or use a "
            "fresh checkpoint directory.")
    best = (_state_from_arrays(ckpt.arrays, "cpu", "best/")
            if "best/fe_coefficients" in ckpt.arrays else None)
    return state, best


def train_distributed(
    program: GameTrainProgram,
    dataset: GameDataset,
    re_datasets: Mapping[str, RandomEffectDataset],
    *,
    mf_datasets: Mapping[str, MFDataset] | None = None,
    mesh=None,
    num_iterations: int = 1,
    fe_feature_sharded: bool = False,
    state: GameTrainState | None = None,
    checkpointer=None,
    checkpoint_every: int = 1,
    resume: bool = True,
    put_fn=None,
    validation_dataset: GameDataset | None = None,
    validation_evaluators: Sequence = (),
    validation_eval_data=None,
    training_evaluator=None,
    training_eval_data=None,
    down_sampling_seed: int = 0,
    check_finite: bool = True,
    on_sweep=None,
    exchange=None,
    resume_step: "int | None" = None,
) -> DistributedTrainResult:
    """Run ``num_iterations`` fused sweeps on the dataset's device.

    state: a warm start (``game_model_to_state``); else ``init_state``.
    Validation (reference CoordinateDescent.scala:183-192, 291-356): with
    ``validation_dataset``, ``validation_evaluators`` and
    ``validation_eval_data`` (an ``evaluation.EvaluationData``), each sweep
    scores the validation split, evaluates every evaluator on the host and
    tracks the best state by the FIRST evaluator's ``better_than``.
    ``training_evaluator`` + ``training_eval_data`` add a per-sweep
    ``train:<name>`` metric. on_sweep: observer ``(sweeps_done,
    num_iterations, loss)`` called at the end of every sweep.

    mesh: a data-axis mesh (``parallel/mesh.make_mesh``), whose ranks all
    call this with the same whole datasets. Both are padded with zero-weight
    rows to a multiple of the data axis, each rank keeps its rows and lanes
    (:meth:`GameTrainProgram.shard_inputs`, ``put_fn`` its placement), the
    validation metrics reduce on the device (``evaluation/sharded.py``) and
    every rank returns the whole state. The program must be built with the
    same mesh.

    ``fe_feature_sharded`` over a mesh with a model axis wider than 1 lays
    the primary FE's columns over "model" (the program must be built with
    the same flag): every rank then returns its FE block
    (``state.fe_columns``), and ``state_to_game_model`` gathers it.
    Without a mesh, or with a model axis of 1, the flag changes nothing.

    checkpointer: an ``io/checkpoint.TrainingCheckpointer``. Every
    ``checkpoint_every`` sweeps and at the last one the whole state (the FE
    block gathered over a model axis by :meth:`GameTrainProgram.whole_state`,
    which every rank joins) is saved through ``commit_checkpoint`` (rank 0
    writes), with the JAX package's keys; with ``resume=True`` and no
    ``state`` the newest checkpoint is restored, re-laid over the mesh by
    :meth:`GameTrainProgram.shard_inputs`, and its sweeps are skipped.
    With ``exchange`` (a coordinated recovery's) each commit runs between
    two of its barriers; ``resume_step`` pins the restore to one step (0:
    start from scratch).

    A spec whose optimizer carries a lane scheduler sweeps through
    :meth:`GameTrainProgram.step_scheduled` (one scheduler per such RE type,
    kept across the sweeps; ``make_schedulers``).
    """
    if mesh is not None:
        mesh_ops.check_data_mesh(mesh)
        program._check_feature_sharded(mesh, fe_feature_sharded)
    if mesh is not None and program.mesh is not mesh:
        raise ValueError("train_distributed(mesh=...) needs the program built with the same "
                         "mesh: GameTrainProgram(..., mesh=mesh)")
    if mesh is None and put_fn is not None:
        raise ValueError("put_fn places a rank's block and needs mesh=")
    from photon_ml_torch.algorithm.lane_scheduler import make_schedulers

    schedulers = make_schedulers(program.re_specs) or None

    start_sweep = 0
    prior_losses: list[float] = []
    best_state: GameTrainState | None = None
    best_metric = float("nan")
    history: list[dict] = []
    if resume_step == 0:
        resume = False
    # an explicit warm start takes precedence over a checkpoint
    if checkpointer is not None and resume and state is None:
        ckpt = checkpointer.restore(step=resume_step if resume_step else None)
        if ckpt is not None:
            state, best_state = _restore_train_state(program, ckpt, checkpointer.directory)
            state = _state_to(state, dataset.device)
            if best_state is not None:
                best_state = _state_to(best_state, dataset.device)
            best_metric = float(ckpt.meta.get("best_metric", float("nan")))
            recovery.counts["checkpoint_restores"] += 1
            start_sweep = min(int(ckpt.step), num_iterations)
            prior_losses = [float(x) for x in ckpt.meta.get("losses", [])][:start_sweep]
            history = [h for h in ckpt.meta.get("metric_history", [])
                       if int(h.get("iteration", 0)) < start_sweep]

    n_train = dataset.num_samples
    n_val = validation_dataset.num_samples if validation_dataset is not None else 0
    if mesh is not None:
        # buckets index sample rows, which appended rows leave intact: pad
        # after the caller built re_datasets
        data_axis = mesh_ops.data_size(mesh)
        dataset, n_train = pad_game_dataset(dataset, data_axis)
        if validation_dataset is not None:
            validation_dataset, n_val = pad_game_dataset(validation_dataset, data_axis)
    data, buckets = program.prepare_inputs(dataset, re_datasets, mf_datasets)
    if state is None:
        state = program.init_state(dataset, re_datasets, mf_datasets)
    if mesh is not None:
        data, buckets, state = program.shard_inputs(mesh, data, buckets, state, put_fn=put_fn,
                                                    fe_feature_sharded=fe_feature_sharded)
    layout: MeshLayout | None = data.get("mesh")

    # per-sweep FE down-sampling multipliers (stable-id splitmix64, the
    # coordinate-descent path's sampler); keyed per FE coordinate ("" =
    # the primary)
    from photon_ml_torch.sampling.down_sampler import down_sampler_for_task

    samplers = {key: down_sampler_for_task(program.task, spec.down_sampling_rate)
                for key, spec in [("", program.fe)]
                + [(s.feature_shard_id, s) for s in program.extra_fes]
                if spec.down_sampling_rate < 1.0}
    if samplers:
        samp_labels = dataset.host_array("labels")
        samp_weights = dataset.host_array("weights")
        samp_uids = np.asarray(dataset.unique_ids)

    def sweep_multiplier(sampler, sweep: int) -> torch.Tensor:
        new_w = sampler.down_sample_weights(samp_labels, samp_weights, samp_uids,
                                            seed=down_sampling_seed + sweep)
        kept = samp_weights > 0
        mult = np.where(kept, new_w / np.where(kept, samp_weights, 1.0), 0.0)
        if layout is not None:
            mult = mult[layout.rows]
        return device_tensor(mult.astype(samp_weights.dtype), data["weights"].dtype,
                             data["weights"].device)

    evaluators = list(validation_evaluators)
    val_data = None
    device_evals: list = [None] * len(evaluators)
    if validation_dataset is not None and evaluators and validation_eval_data is not None:
        val_data = program.prepare_scoring_inputs(validation_dataset, re_datasets)
        if mesh is not None:
            from photon_ml_torch.evaluation.sharded import prepare_device_evaluators

            val_data = program.shard_scoring_inputs(mesh, val_data, put_fn=put_fn,
                                                    fe_feature_sharded=fe_feature_sharded)
            # the metrics reduce on the device from the gathered score
            # vector; only scalars reach the host
            device_evals = prepare_device_evaluators(
                evaluators, validation_eval_data, n_pad=validation_dataset.num_samples,
                device=val_data["labels"].device)

    losses: list[float] = list(prior_losses)
    for sweep in range(start_sweep, num_iterations):
        for key, sampler in samplers.items():
            mult = sweep_multiplier(sampler, sweep)
            if key == "":
                data["fe_weight_multiplier"] = mult
            else:
                data.setdefault("extra_fe_weight_multipliers", {})[key] = mult
        if schedulers is not None:
            state, loss = program.step_scheduled(data, buckets, state, schedulers=schedulers,
                                                 final_sweep=sweep + 1 == num_iterations)
        else:
            state, loss = program.step(data, buckets, state)
        losses.append(float(loss))
        if check_finite and not np.isfinite(losses[-1]):
            raise DivergenceError(
                f"fused training step produced non-finite loss {losses[-1]} at sweep {sweep}")
        metrics: dict[str, float] = {}
        if training_evaluator is not None and training_eval_data is not None:
            train_scores = _host_scores(program.score(data, state), n_train, layout)
            metrics[f"train:{training_evaluator.name}"] = float(
                training_evaluator.evaluate(train_scores, training_eval_data))
        if val_data is not None:
            from photon_ml_torch.evaluation.sharded import evaluate_prepared

            val_scores = program.score(val_data, state)
            values = evaluate_prepared(
                evaluators, device_evals, val_scores, validation_eval_data,
                lambda: _host_scores(val_scores, n_val, val_data.get("mesh")),
                layout=val_data.get("mesh"))
            for i, (ev, v) in enumerate(zip(evaluators, values)):
                metrics[f"validate:{ev.name}"] = v
                if i == 0 and (best_state is None or ev.better_than(v, best_metric)):
                    best_state, best_metric = state, v
        if metrics:
            history.append({"iteration": sweep, "coordinate": "fused_sweep", **metrics})
        if checkpointer is not None and (
                (sweep + 1) % max(1, checkpoint_every) == 0 or sweep + 1 == num_iterations):
            # every rank joins the FE block's gather; rank 0 writes
            arrays = _state_arrays(program.whole_state(state))
            if best_state is not None:
                arrays.update(_state_arrays(program.whole_state(best_state), "best/"))
            commit_checkpoint(checkpointer, sweep + 1, arrays,
                              {"losses": losses, "metric_history": history,
                               "best_metric": best_metric}, exchange=exchange)
        if on_sweep is not None:
            on_sweep(sweep + 1, num_iterations, losses[-1] if losses else None)
    return DistributedTrainResult(
        state=state, losses=losses,
        # best == final collapses to None ("treat final as best")
        best_state=None if best_state is None or best_state is state else best_state,
        best_metric=best_metric, metric_history=history)


# ---------------------------------------------------------------------------
# Partitioned training: each rank feeds only its own block of a partitioned read
# ---------------------------------------------------------------------------


def _partitioned_guards(program: GameTrainProgram, prepared: dict) -> None:
    """The partitioned surface: a dense or sparse (hybrid too) primary fixed
    effect, dense extra fixed effects and IDENTITY random effects. The rest
    trains through the full read."""
    if program.mf_specs:
        raise ValueError(
            "partitioned training does not support matrix-factorization "
            "coordinates; use the full-read path"
        )
    for data, buckets in prepared.values():
        if "re_sparse" in data:
            raise ValueError(
                "partitioned training does not support sparse RANDOM-"
                "EFFECT shards (the primary fixed effect may be sparse); "
                "use the full-read path"
            )
        if "__projections__" in buckets:
            raise ValueError(
                "partitioned training does not support projected random "
                "effects; use the full-read path"
            )


def _assemble_sparse_fe(data: dict, rank: int, exchange, tag: str) -> SparseLabeledPointBatch:
    """The rank's sparse fixed-effect batch, its layout checked against every
    rank's: the ELL width, the flat overflow's length (``SparseShard.
    flat_block_nnz``: pads carry value 0, column 0 and the rank's last
    overflow row) and the hybrid hot ids must be the ones
    ``io/partitioned_reader.read_partitioned`` agreed. The batch's row ids
    stay rank-local: ``parallel/sharded_dense.ShardedSparseGLMObjective``
    sums each rank's rows, as it does over a full read's blocks."""
    import hashlib

    sb = data["fe_sparse_batch"]
    if not sb.has_ell_view:
        raise ValueError(
            f"rank {rank}: the sparse FE batch has no ELL view; "
            "partitioned sparse training rides the fixed-width ELL "
            "layout (read through read_partitioned)"
        )
    hot = (hashlib.sha256(sb.hot_col_ids.cpu().numpy().astype(np.int64).tobytes())
           .hexdigest()[:16] if sb.has_hybrid_view else None)
    mine = {"dim": int(sb.dim), "ell": list(sb.ell_vals.shape), "nnz": int(sb.nnz), "hot": hot}
    for r, g in enumerate(exchange.allgather(f"partitioned_sparse_fe/{tag}", mine)):
        if (g["dim"], g["ell"], g["nnz"]) != (mine["dim"], mine["ell"], mine["nnz"]):
            raise ValueError(
                f"rank {r}: sparse FE batch shapes disagree across ranks "
                f"(dim {g['dim']} vs {mine['dim']}, ELL {g['ell']} vs {mine['ell']}, flat "
                f"{g['nnz']} vs {mine['nnz']}) — ingest through "
                "io/partitioned_reader.read_partitioned, which agrees the "
                "global layout"
            )
        if g["hot"] != mine["hot"]:
            raise ValueError(
                f"rank {r}: hybrid hot heads disagree across ranks — the "
                "hot ranking must be resolved globally "
                "(read_partitioned's hybrid_hot exchange)"
            )
    return sb


def prepare_partitioned_inputs(
    program: GameTrainProgram,
    parts: "Mapping[int, tuple[GameDataset, Mapping[str, RandomEffectDataset]]]",
    mesh,
    num_ranks: int,
    *,
    fe_feature_sharded: bool = False,
    state: GameTrainState | None = None,
    exchange=None,
    tag: str = "train",
):
    """(data, buckets, state) of :meth:`GameTrainProgram.step` from this
    rank's own block of a partitioned read (``io/partitioned_reader.py``:
    ``num_ranks`` equal blocks, pad rows and lanes inert), with no array of
    global size on any host.

    parts: ``{rank: (padded local GameDataset, RE datasets from
    build_random_effect_dataset_partitioned)}``, this process's rank only
    (one process a rank, the mesh's data axis ``num_ranks`` wide). The
    blocks' shapes are checked against every rank's through ``exchange``
    (``parallel/multihost.assemble_partitioned``; the run's exchange by
    default), and each RE coordinate's owned entity rows of every rank come
    from one all-gather of the padded bucket lanes' entity rows. The state
    (zeros, or a warm start equal on every rank) stays whole on every rank.

    Over a mesh with a model axis the partition's ranks are the data ranks:
    the ranks of one data row each read (and pass here) the same block, the
    default exchange is narrowed to the data axis
    (``multihost.DataAxisExchange``: one payload a data rank), and with
    ``fe_feature_sharded`` each keeps its FE columns and FE block.
    """
    from photon_ml_torch.parallel import multihost

    mesh_ops.check_data_mesh(mesh)
    sharded = program._check_feature_sharded(mesh, fe_feature_sharded)
    if mesh_ops.data_size(mesh) != num_ranks:
        raise ValueError(f"the mesh's data axis ({mesh_ops.data_size(mesh)}) must have one "
                         f"rank a partition ({num_ranks})")
    rank = mesh_ops.data_rank(mesh)
    if set(parts) != {rank}:
        raise ValueError(f"parts must hold this rank's block only ({{{rank}: (dataset, "
                         f"re_datasets)}}), got ranks {sorted(parts)}")
    if exchange is None:
        exchange = multihost.default_exchange()
        if mesh_ops.model_size(mesh) > 1:
            exchange = multihost.DataAxisExchange(exchange, mesh)
    ds, res = parts[rank]
    data, buckets = program.prepare_inputs(ds, res, None)
    _partitioned_guards(program, {rank: (data, buckets)})
    device = ds.device
    n = ds.num_samples
    blocks = {"labels": data["labels"], "offsets": data["offsets"], "weights": data["weights"],
              "features": data["features"], "entity_idx": data["entity_idx"],
              "buckets": {k: v for k, v in buckets.items() if k != "__mf__"}}
    multihost.assemble_partitioned(blocks, exchange, device=device, tag=tag)
    layout = MeshLayout(mesh=mesh, rows=slice(rank * n, (rank + 1) * n), num_rows=num_ranks * n)
    data = dict(data, mesh=layout)
    if sharded:
        # the rank's rows are the whole block: keep its FE columns
        program._shard_fe_columns(data, mesh, slice(0, n))
    elif "fe_sparse_batch" in data:
        data["fe_sparse_batch"] = _assemble_sparse_fe(data, rank, exchange, tag)
    # every rank's lanes' entity rows: one all-gather of all coordinates'
    keys = [s.re_type for s in program.re_specs]
    lens = [[int(b["entity_rows"].shape[0]) for b in buckets[k]] for k in keys]
    mine = [b["entity_rows"].long() for k in keys for b in buckets[k]]
    every = (mesh_ops.all_gather_rows(torch.cat(mine), mesh).cpu() if mine
             else torch.zeros((0,), dtype=torch.long))
    block = sum(sum(x) for x in lens)
    for i, k in enumerate(keys):
        start = sum(sum(x) for x in lens[:i])
        rows = [list(torch.split(every[r * block + start: r * block + start + sum(lens[i])],
                                 lens[i])) for r in range(num_ranks)]
        _lane_owners(layout, k, rows, rank, device)
    if state is None:
        state = program.init_state(ds, res, None)
    state = GameTrainState(
        fe_coefficients=torch.as_tensor(state.fe_coefficients).to(device),
        re_tables={k: torch.as_tensor(v).to(device) for k, v in state.re_tables.items()},
        extra_fe={k: torch.as_tensor(v).to(device) for k, v in state.extra_fe.items()},
        fe_columns=state.fe_columns)
    if sharded:
        state = program._split_state(state, data["fe_columns"][2])
    return data, buckets, state


def _partition_fingerprint(program: GameTrainProgram, parts, num_ranks: int) -> dict:
    """What a partitioned run's state is valid under: the rank geometry, the
    agreed global sparse layout (hybrid hot head, ELL width, flat overflow)
    and the coordinates. Read from one rank's part: these quantities are
    equal on every rank by the reader's exchange."""
    import hashlib

    r0 = sorted(parts)[0]
    ds, res = parts[r0]
    fe_shard = ds.feature_shards[program.fe.feature_shard_id]
    if isinstance(fe_shard, SparseShard):
        policy = fe_shard.hybrid_policy
        hot = tuple(policy.hot_ids) if policy is not None and policy.hot_ids else ()
        layout = {
            "dim": int(fe_shard.feature_dim),
            "ell_width": None if fe_shard.ell_width is None else int(fe_shard.ell_width),
            "flat_block_nnz": (None if fe_shard.flat_block_nnz is None
                               else int(fe_shard.flat_block_nnz)),
            "k_hot": len(hot),
            "hot_hash": hashlib.sha256(np.asarray(hot, np.int64).tobytes()).hexdigest()[:16],
        }
    else:
        layout = {"dim": int(fe_shard.shape[1])}
    return {
        "num_ranks": int(num_ranks),
        "block_rows": int(ds.num_samples),
        "fe_shard": program.fe.feature_shard_id,
        "fe_layout": layout,
        "re_entities": {s.re_type: int(res[s.re_type].num_entities) for s in program.re_specs},
        "extra_fe": sorted(s.feature_shard_id for s in program.extra_fes),
    }


def train_partitioned(
    program: GameTrainProgram,
    parts: "Mapping[int, tuple[GameDataset, Mapping[str, RandomEffectDataset]]]",
    mesh,
    num_ranks: int,
    *,
    num_iterations: int = 1,
    state: GameTrainState | None = None,
    fe_feature_sharded: bool = False,
    check_finite: bool = True,
    schedulers: "Mapping[str, object] | None" = None,
    checkpointer=None,
    checkpoint_every: int = 1,
    resume: bool = True,
    exchange=None,
    resume_step: "int | None" = None,
) -> DistributedTrainResult:
    """``train_distributed`` over a partitioned read: each rank feeds only
    its block of the data and bucket lanes (each decoded about 1/P of the
    input; ``io/partitioned_reader.py``) and the fused step runs unchanged
    over the mesh (B1 or G1 on the rank's rows, one all-reduce an
    evaluation; the residual offsets and the solved table rows all-gathered).
    The state is whole on every rank after each sweep, so the returned state
    needs no gather (with ``fe_feature_sharded`` over a model axis, every
    rank returns its FE block, as ``train_distributed`` does). Scope: a
    dense or sparse (hybrid too) primary fixed effect, dense extra fixed
    effects and dense IDENTITY random effects, no validation (score and
    evaluate through ``parallel/scoring.py``).

    checkpointer: an ``io/checkpoint.TrainingCheckpointer``. Every
    ``checkpoint_every`` sweeps and at the last one the whole state (the FE
    block gathered over a model axis) is committed through
    ``commit_checkpoint`` (every rank calls; with ``exchange``, between two
    barriers, so a step exists only when every rank completed it), with the
    partition's fingerprint (``_partition_fingerprint``) in ``meta.json``;
    a resume under another fingerprint fails fast naming the fields that
    differ, and one whose step lies past ``num_iterations`` is refused. An
    explicit ``state`` takes precedence over a checkpoint. ``resume_step``
    pins the restore to one step (0: start from scratch).

    schedulers: optional RE type -> ``algorithm.lane_scheduler.LaneScheduler``
    (``make_schedulers``; one per rank): the sweeps then run through
    :meth:`GameTrainProgram.step_scheduled`. A checkpointed run refuses
    freeze tolerances: the cross-sweep active set is scheduler state the
    checkpoint does not hold."""
    if program.mesh is not mesh:
        raise ValueError("train_partitioned needs the program built with the same mesh: "
                         "GameTrainProgram(..., mesh=mesh)")
    fingerprint = None
    start_sweep = 0
    losses: list[float] = []
    if resume_step == 0:
        resume = False
    if checkpointer is not None:
        freezing = sorted(k for k, sch in (schedulers or {}).items()
                          if getattr(getattr(sch, "config", None), "freezes", False))
        if freezing:
            # a restart would probe every lane again and leave the
            # uninterrupted run's path
            raise ValueError(
                "partitioned checkpointing cannot yet resume cross-sweep "
                f"active-set state (freeze tolerances set on {freezing}); "
                "drop scheduler.freeze.tolerance/scheduler.freeze.gradient "
                "(probe/rescue scheduling resumes exactly) or disable "
                "checkpointing for this run")
        fingerprint = _partition_fingerprint(program, parts, num_ranks)
        if resume and state is None:
            ckpt = checkpointer.restore(step=resume_step if resume_step else None)
            if ckpt is not None:
                mismatch = fingerprint_mismatch(ckpt.meta.get("partition_fingerprint"),
                                                fingerprint)
                if mismatch is not None:
                    raise ValueError(
                        f"partitioned checkpoint at {checkpointer.directory} was written "
                        f"under a different partition fingerprint ({mismatch}) — a restored "
                        "table row would map onto a different rank block / sparse layout; "
                        "resume with the original rank count and layout agreement, or use a "
                        "fresh checkpoint directory")
                if int(ckpt.step) > num_iterations:
                    raise ValueError(
                        f"partitioned checkpoint at {checkpointer.directory} is at sweep "
                        f"{int(ckpt.step)}, beyond this run's num_iterations={num_iterations}; "
                        "raise num_iterations to continue training, or use a fresh "
                        "checkpoint directory")
                state = _state_from_arrays(ckpt.arrays, "cpu")
                start_sweep = int(ckpt.step)
                losses = [float(x) for x in ckpt.meta.get("losses", [])][:start_sweep]
                recovery.counts["checkpoint_restores"] += 1
                recovery.counts["epochs_resumed"] += start_sweep
    data, buckets, st = prepare_partitioned_inputs(program, parts, mesh, num_ranks, state=state,
                                                   exchange=exchange,
                                                   fe_feature_sharded=fe_feature_sharded)
    for sweep in range(start_sweep, num_iterations):
        if schedulers:
            st, loss = program.step_scheduled(data, buckets, st, schedulers=schedulers,
                                              final_sweep=sweep + 1 == num_iterations)
        else:
            st, loss = program.step(data, buckets, st)
        losses.append(float(loss))
        if check_finite and not np.isfinite(losses[-1]):
            raise DivergenceError(
                f"partitioned training step produced non-finite loss {losses[-1]} at sweep "
                f"{sweep}" + (f"; last good checkpoint: step {checkpointer.latest_step()} in "
                              f"{checkpointer.directory}" if checkpointer is not None else ""))
        if checkpointer is not None and (
                (sweep + 1) % max(1, checkpoint_every) == 0 or sweep + 1 == num_iterations):
            arrays = _state_arrays(program.whole_state(st))
            commit_checkpoint(checkpointer, sweep + 1, arrays,
                              {"partition_fingerprint": fingerprint, "losses": losses},
                              exchange=exchange)
    return DistributedTrainResult(state=st, losses=losses)
