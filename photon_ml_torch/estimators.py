"""The training facades: ``GameEstimator`` and single-GLM ``train_glm``.

Counterpart of ``photon_ml_tpu/estimators.py``. ``GameEstimator.fit``
(reference photon-api estimators/GameEstimator.scala) builds the
per-coordinate datasets, the training-loss and validation evaluators and the
per-shard normalization, then runs block coordinate descent; with ``mesh``
it trains through the fused program over the mesh instead
(``_fit_distributed``, ``parallel/distributed.py``; ``fe_feature_sharded``
lays the primary fixed effect's columns over the mesh's "model" axis), and
with ``partition``
(:class:`TrainPartition`) on this rank's block of a partitioned read
(``train_partitioned``); ``refresh`` solves again only the entities that
changed (``algorithm/refresh.py``). One device runs it over
a dense or sparse fixed effect, random effects
on dense shards (IDENTITY, INDEX_MAP or RANDOM projection, optional
per-entity Pearson feature selection) or on sparse shards (compact ``[E, K]``
tables over each entity's active columns), and matrix-factorization
coordinates (``algorithm/mf_coordinate.py``). ``train_glm`` (reference ModelTraining.scala:55-228)
is the single-GLM regularization path with warm starts, for dense and sparse
batches alike; ``train_glm_grid`` trains the whole λ grid at once, one solver
lane per λ, and ``train_glm_tournament`` one lane per hyperparameter
configuration (``algorithm/lane_search.py``); ``train_glm_streaming`` is the same path over an out-of-core
chunk source (``io/stream_reader.py``), checkpointed through
``io/checkpoint.SolverCheckpointer``. A ``GameEstimator`` with a checkpointer
saves and resumes its coordinate descent or fused program.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinate_descent import (
    CoordinateDescentResult,
    run_coordinate_descent,
)
from photon_ml_torch.algorithm.coordinates import (
    Coordinate,
    CoordinateOptimizationConfig,
    FixedEffectCoordinate,
    ModelCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_torch.algorithm.mf_coordinate import MatrixFactorizationCoordinate, build_mf_dataset
from photon_ml_torch.data.batch import LabeledPointBatch, summarize
from photon_ml_torch.data.game_data import (
    GameDataset,
    build_random_effect_dataset,
    build_random_effect_dataset_partitioned,
)
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, SparseShard
from photon_ml_torch.device import resolve_device
from photon_ml_torch.evaluation.evaluators import (
    EvaluationData,
    default_evaluator_for_task,
    parse_evaluator,
)
from photon_ml_torch.models.game import FixedEffectModel, GameModel
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.normalization import (
    NormalizationContext,
    NormalizationType,
    build_normalization,
)
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.ops.variance import (
    coefficient_variances,
    diag_inverse_from_hessian,
    inverse_of_diagonal,
    resolve_variance_mode_for,
    validate_variance_mode,
)
from photon_ml_torch.optim.common import SolverResult
from photon_ml_torch.optim.optimizer import (
    OptimizerConfig,
    OptimizerType,
    resolve_auto_optimizer,
    solve,
)
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.telemetry.program_ledger import ledger_call
from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FixedEffectCoordinateConfig:
    """Reference: FixedEffectDataConfiguration + optimization config."""

    feature_shard_id: str
    optimization: CoordinateOptimizationConfig


@dataclasses.dataclass(frozen=True)
class RandomEffectCoordinateConfig:
    """Reference: RandomEffectDataConfiguration (RE type, shard, bounds) +
    optimization config."""

    random_effect_type: str
    feature_shard_id: str
    optimization: CoordinateOptimizationConfig
    active_data_upper_bound: int | None = None
    active_data_lower_bound: int | None = None
    #: reference projector/ProjectorType.scala: INDEX_MAP trains each entity
    #: on its observed columns, RANDOM on a shared Gaussian sketch (a name
    #: is taken too)
    projector_type: ProjectorType = ProjectorType.IDENTITY
    projected_dim: int | None = None  # RANDOM only
    #: per-entity Pearson feature selection: an entity with c samples keeps
    #: its ceil(ratio·c) best columns (LocalDataSet.scala:221-280)
    features_to_samples_ratio: float | None = None
    bucket_sizes: Sequence[int] = (8, 32, 128, 512, 2048)

    def __post_init__(self):
        object.__setattr__(self, "projector_type", ProjectorType(
            getattr(self.projector_type, "value", self.projector_type)))


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationCoordinateConfig:
    """An MF coordinate over a (row entity, col entity) pair: the model
    family the reference declares (README.md:92-95, LatentFactorAvro.avsc)
    but never implemented. It takes no feature shard."""

    row_effect_type: str
    col_effect_type: str
    num_latent_factors: int
    optimization: CoordinateOptimizationConfig
    num_alternations: int = 2
    active_data_upper_bound: int | None = None
    seed: int = 0


CoordinateConfig = (
    FixedEffectCoordinateConfig
    | RandomEffectCoordinateConfig
    | MatrixFactorizationCoordinateConfig
)


@dataclasses.dataclass
class TrainPartition:
    """Partitioned-read context of ``GameEstimator``: ``fit`` receives this
    rank's padded block from ``io/partitioned_reader.read_partitioned``
    instead of the whole dataset.

    info: the reader's PartitionInfo (the rank geometry).
    exchange: the run's MetadataExchange (the RE bucket structure rides it).
    lane_multiple: devices a rank along the mesh's "data" axis (1 in the
        port, one process a device).
    entity_rank_presence: the reader's RE type -> ranks-per-entity, for the
        rank-local RE builder's warning about entities that span ranks.
    """

    info: object
    exchange: object
    lane_multiple: int = 1
    entity_rank_presence: Mapping[str, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GameEstimator:
    """Trains a GAME model on one device: ordered coordinates, block
    coordinate descent."""

    task: TaskType
    coordinate_configs: Mapping[str, object]
    update_sequence: Sequence[str] | None = None
    num_iterations: int = 1
    normalization: NormalizationType = NormalizationType.NONE
    validation_evaluators: Sequence[str] = ()
    locked_coordinates: frozenset = frozenset()
    #: shard id -> index of the intercept column (exempt from normalization,
    #: absorbs the standardization margin shift)
    intercept_indices: Mapping[str, int] = dataclasses.field(default_factory=dict)
    #: an io/checkpoint.TrainingCheckpointer: coordinate-descent progress (or,
    #: over a mesh, the fused program's state) is saved every
    #: ``checkpoint_every`` updates (sweeps) and at the last one
    checkpointer: object | None = None
    checkpoint_every: int = 1
    #: False ignores an existing checkpoint (a fresh fit)
    resume: bool = True
    #: a mesh fit's restore pinned to one step (0: from scratch)
    resume_step: int | None = None
    #: raise DivergenceError on non-finite coordinate updates
    check_finite: bool = True
    #: a data-axis DeviceMesh (``parallel/mesh.make_mesh``): fit() trains
    #: through the fused program over it (every rank calls fit with the same
    #: datasets) instead of the coordinate-descent loop
    mesh: object | None = None
    #: lay the primary fixed effect's feature axis over the mesh's "model"
    #: axis (its dimension padded with zero columns to a multiple of it;
    #: the padding's coefficients stay 0 and are sliced off on output)
    fe_feature_sharded: bool = False
    #: a telemetry.SolverTelemetry: per-coordinate, per-sweep convergence
    #: rows (the drivers thread their run journal and event emitter here)
    telemetry: object | None = None
    #: evaluation path of the fixed-effect solves (ops/objective.py): None =
    #: the packed kernel on a CUDA block, False = the closed form
    use_kernel: bool | None = None
    #: unit of the packed kernel's products ("fma" or "mma") and the form of
    #: its label/offset/weight operand ("packed" or "columns")
    kernel_unit: str = "fma"
    kernel_aux: str = "packed"
    #: called with (iteration, coordinate id, solver info) after each update
    on_update: Callable | None = None
    #: partitioned-read context (TrainPartition): fit() receives this rank's
    #: block and trains through train_partitioned over ``mesh``; a dense or
    #: sparse primary FE and dense IDENTITY REs, without normalization or
    #: validation (``_check_partition_supported``)
    partition: "TrainPartition | None" = None
    #: a mesh fit without ``partition`` commits its checkpoints between this
    #: MetadataExchange's barriers (a coordinated recovery's exchange), so a
    #: step exists only when every rank reached it
    exchange: object | None = None

    def fit(self, dataset: GameDataset, validation_dataset: GameDataset | None = None,
            initial_model: GameModel | None = None) -> CoordinateDescentResult:
        if self.fe_feature_sharded and self.mesh is None:
            raise ValueError("fe_feature_sharded requires a mesh (GameEstimator(mesh=...))")
        if self.partition is not None and self.mesh is None:
            # the coordinate-descent path would train a whole model on this
            # rank's 1/P block
            raise ValueError(
                "partitioned training requires a mesh (the per-rank blocks "
                "feed its addressable shards); pass GameEstimator(mesh=...)"
            )
        if self.mesh is not None:
            from photon_ml_torch.parallel.mesh import check_data_mesh

            check_data_mesh(self.mesh)
            return self._fit_distributed(dataset, validation_dataset, initial_model)
        sequence, coordinates = self._build_coordinates(dataset, initial_model)

        def eval_data(ds):
            return EvaluationData(labels=ds.host_array("labels"), offsets=ds.host_array("offsets"),
                                  weights=ds.host_array("weights"), ids=ds.ids)

        validation_scorer = None
        validation_data = None
        evaluators = [parse_evaluator(s) for s in self.validation_evaluators]
        if validation_dataset is not None and evaluators:
            validation_data = eval_data(validation_dataset)

            def validation_scorer(model: GameModel):
                return (model.score_dataset(validation_dataset)
                        + validation_dataset.offsets).cpu().numpy()

        initial_models = dict(initial_model.models) if initial_model is not None else None
        return run_coordinate_descent(
            coordinates, sequence, self.num_iterations,
            initial_models=initial_models,
            locked_coordinates=self.locked_coordinates,
            training_evaluator=default_evaluator_for_task(self.task),
            training_data=eval_data(dataset),
            validation_evaluators=evaluators,
            validation_scorer=validation_scorer,
            validation_data=validation_data,
            checkpointer=self.checkpointer,
            checkpoint_every=self.checkpoint_every,
            resume=self.resume,
            check_finite=self.check_finite,
            telemetry=self.telemetry,
            on_update=self.on_update,
        )

    def _check_partition_supported(self, sequence, locked, dataset, validation_dataset) -> None:
        """The partitioned-training surface (a dense or sparse primary FE and
        dense IDENTITY REs, no global-statistics riders): anything outside it
        raises before any rank-local work could diverge from the full read."""
        problems: list[str] = []
        if self.mesh is None:
            problems.append("a mesh is required")
        if locked:
            problems.append("locked coordinates")
        if validation_dataset is not None:
            problems.append(
                "validation datasets (score + evaluate partitioned via "
                "parallel/scoring.py instead)"
            )
        if self.normalization != NormalizationType.NONE:
            problems.append(
                "normalization (feature stats would be rank-local)"
            )
        # the primary FE (the first trainable fixed effect) may be sparse:
        # the partitioned reader agreed its hybrid head and ELL width
        primary_fe = next((cid for cid in sequence if cid not in locked and isinstance(
            self.coordinate_configs[cid], FixedEffectCoordinateConfig)), None)
        for cid in sequence:
            cfg = self.coordinate_configs[cid]
            if isinstance(cfg, MatrixFactorizationCoordinateConfig):
                problems.append(f"matrix-factorization coordinate '{cid}'")
                continue
            if isinstance(cfg, RandomEffectCoordinateConfig) and (
                cfg.projector_type != ProjectorType.IDENTITY
                or cfg.features_to_samples_ratio is not None
            ):
                problems.append(
                    f"projected/feature-selected random effect '{cid}'"
                )
            if cfg.optimization.down_sampling_rate < 1.0:
                problems.append(f"down-sampling on '{cid}'")
            if cfg.optimization.compute_variance:
                problems.append(f"compute_variance on '{cid}'")
            if cid != primary_fe and isinstance(
                dataset.feature_shards.get(cfg.feature_shard_id), SparseShard
            ):
                problems.append(
                    f"sparse feature shard on '{cid}' (only the primary "
                    "fixed effect may be sparse)"
                )
        if problems:
            raise ValueError(
                "partitioned training does not support: "
                + "; ".join(sorted(set(problems)))
                + " — use the full-read path for these"
            )

    def _fit_distributed(self, dataset: GameDataset,
                         validation_dataset: GameDataset | None = None,
                         initial_model: GameModel | None = None) -> CoordinateDescentResult:
        """fit() through the fused program over the mesh (JAX
        ``estimators.py:461-955``): one step per sweep over every coordinate
        in the configured order, per-sweep validation and best-model
        tracking, the same CoordinateDescentResult.

        As in the JAX package: the first trainable fixed effect of the
        sequence is the primary (the only one that may be sparse), further
        fixed effects train as dense extra coordinates inside the step, a
        fit without one carries a zero-width placeholder, locked
        coordinates add their fixed scores to the offsets and pass through,
        and variances are computed after training at the final and best
        states."""
        from photon_ml_torch.algorithm.coordinates import _solve_config
        from photon_ml_torch.parallel.distributed import (
            FixedEffectStepSpec,
            GameTrainProgram,
            MatrixFactorizationStepSpec,
            RandomEffectStepSpec,
            game_model_to_state,
            state_to_game_model,
            train_distributed,
            train_partitioned,
        )

        sequence = list(self.update_sequence or self.coordinate_configs.keys())
        task_loss = loss_for_task(self.task)
        locked = set(self.locked_coordinates)
        if locked and initial_model is None:
            raise ValueError("locked coordinates require an initial model "
                             "(partial retraining needs a pre-trained model)")
        partition = self.partition
        if partition is not None:
            self._check_partition_supported(sequence, locked, dataset, validation_dataset)
        fe_ids = [cid for cid in sequence if cid not in locked
                  and isinstance(self.coordinate_configs[cid], FixedEffectCoordinateConfig)]
        if fe_ids:
            fe_cid = fe_ids[0]
            fe_cfg = self.coordinate_configs[fe_cid]
            fe_shard = fe_cfg.feature_shard_id
        else:
            # the step always carries a fixed effect: a zero-width one, whose
            # solve is a no-op and whose (empty) model is dropped on output
            fe_cid = None
            fe_shard = "__no_fe__"
            while fe_shard in dataset.feature_shards:
                fe_shard = "_" + fe_shard
            fe_cfg = FixedEffectCoordinateConfig(fe_shard, CoordinateOptimizationConfig(
                optimizer=OptimizerConfig(max_iterations=1)))

            def with_empty_shard(ds):
                empty = torch.zeros((ds.num_samples, 0), dtype=ds.labels.dtype,
                                    device=ds.device)
                return dataclasses.replace(ds, feature_shards={**ds.feature_shards,
                                                               fe_shard: empty})

            dataset = with_empty_shard(dataset)
            if validation_dataset is not None:
                validation_dataset = with_empty_shard(validation_dataset)
        fe_intercept = self.intercept_indices.get(fe_shard)

        # the model axis wants the FE dimension divisible by it: pad with zero
        # columns, whose coefficients stay exactly 0 (zero data and L2) and
        # are sliced off again on output
        fe_pad = 0
        if self.fe_feature_sharded and fe_cid is not None:
            from photon_ml_torch.parallel.mesh import model_size

            fe_pad = (-int(dataset.feature_shards[fe_shard].shape[1])) % model_size(self.mesh)
        if fe_pad:
            def with_padded_fe(ds):
                shard = ds.feature_shards[fe_shard]
                host_cache = dict(ds.host_cache)
                if isinstance(shard, SparseShard):
                    shard = dataclasses.replace(shard, feature_dim=shard.feature_dim + fe_pad,
                                                _device={}, _hybrid_cache=None)
                else:
                    shard = torch.nn.functional.pad(shard, (0, fe_pad))
                    host_cache.pop(f"shard/{fe_shard}", None)
                return dataclasses.replace(ds, feature_shards={**ds.feature_shards,
                                                               fe_shard: shard},
                                           host_cache=host_cache, _sparse_batches={})

            dataset = with_padded_fe(dataset)
            if validation_dataset is not None:
                validation_dataset = with_padded_fe(validation_dataset)
        norms = self._prepare_normalization(dataset)

        re_specs, re_datasets, re_cid_of_type = [], {}, {}
        mf_specs, mf_datasets = [], {}
        re_normalizations: dict[str, NormalizationContext] = {}
        extra_fe_specs, extra_fe_cid_of_shard = [], {}
        for cid in sequence:
            if cid in locked or cid == fe_cid:
                continue
            cfg = self.coordinate_configs[cid]
            if isinstance(cfg, FixedEffectCoordinateConfig):
                if cfg.feature_shard_id in extra_fe_cid_of_shard or cfg.feature_shard_id == fe_shard:
                    raise ValueError(
                        f"distributed training: fixed-effect coordinates '{cid}' and another "
                        f"share feature shard '{cfg.feature_shard_id}' — the fused step keys FE "
                        "coordinates by feature shard; merge or rename")
                extra_fe_cid_of_shard[cfg.feature_shard_id] = cid
                extra_fe_specs.append(FixedEffectStepSpec(
                    feature_shard_id=cfg.feature_shard_id,
                    optimizer=_solve_config(cfg.optimization, loss=task_loss),
                    l2_weight=cfg.optimization.l2_weight,
                    down_sampling_rate=cfg.optimization.down_sampling_rate,
                    intercept_index=self.intercept_indices.get(cfg.feature_shard_id)))
                continue
            if isinstance(cfg, MatrixFactorizationCoordinateConfig):
                mf_datasets[cid] = build_mf_dataset(
                    dataset, cfg.row_effect_type, cfg.col_effect_type,
                    active_data_upper_bound=cfg.active_data_upper_bound, seed=cfg.seed)
                mf_specs.append(MatrixFactorizationStepSpec(
                    name=cid, row_effect_type=cfg.row_effect_type,
                    col_effect_type=cfg.col_effect_type,
                    num_latent_factors=cfg.num_latent_factors,
                    optimizer=_solve_config(cfg.optimization, loss=task_loss, small_dense=True),
                    l2_weight=cfg.optimization.l2_weight,
                    num_alternations=cfg.num_alternations, seed=cfg.seed))
                continue
            re_type = cfg.random_effect_type
            if re_type in re_cid_of_type:
                raise ValueError(
                    f"distributed training: coordinates '{re_cid_of_type[re_type]}' and "
                    f"'{cid}' share random effect type '{re_type}' — the fused step keys its "
                    "coefficient tables by RE type; merge or rename")
            re_cid_of_type[re_type] = cid
            if partition is not None:
                # rank-local buckets with an exchanged global structure (the
                # guard limited the surface to dense IDENTITY)
                re_datasets[re_type] = build_random_effect_dataset_partitioned(
                    dataset, re_type, cfg.feature_shard_id, partition=partition.info,
                    exchange=partition.exchange,
                    active_data_upper_bound=cfg.active_data_upper_bound,
                    active_data_lower_bound=cfg.active_data_lower_bound,
                    bucket_sizes=cfg.bucket_sizes, lane_multiple=partition.lane_multiple,
                    entity_rank_presence=partition.entity_rank_presence.get(re_type), tag=cid)
            else:
                re_datasets[re_type] = build_random_effect_dataset(
                    dataset, re_type, cfg.feature_shard_id,
                    active_data_upper_bound=cfg.active_data_upper_bound,
                    active_data_lower_bound=cfg.active_data_lower_bound,
                    bucket_sizes=cfg.bucket_sizes, projector_type=cfg.projector_type,
                    projected_dim=cfg.projected_dim,
                    features_to_samples_ratio=cfg.features_to_samples_ratio,
                    normalization=_build_normalization_for(cfg, dataset, norms))
            if norms.get(cfg.feature_shard_id) is not None:
                re_normalizations[re_type] = norms[cfg.feature_shard_id]
            re_specs.append(RandomEffectStepSpec(
                re_type=re_type, feature_shard_id=cfg.feature_shard_id,
                optimizer=_solve_config(cfg.optimization, loss=task_loss, small_dense=True),
                l2_weight=cfg.optimization.l2_weight,
                # the dataset's projector: sparse shards coerce to compact
                # INDEX_MAP
                projector=re_datasets[re_type].projector_type,
                intercept_index=self.intercept_indices.get(cfg.feature_shard_id)))

        cid_to_name: dict[str, str] = {} if fe_cid is None else {fe_cid: fe_shard}
        cid_to_name.update({cid: sh for sh, cid in extra_fe_cid_of_shard.items()})
        cid_to_name.update({cid: t for t, cid in re_cid_of_type.items()})
        cid_to_name.update({m.name: m.name for m in mf_specs})
        update_order = [cid_to_name[cid] for cid in sequence if cid not in locked]
        if fe_cid is None:
            update_order = [fe_shard] + update_order
        program = GameTrainProgram(
            self.task,
            FixedEffectStepSpec(feature_shard_id=fe_shard,
                                optimizer=_solve_config(fe_cfg.optimization, loss=task_loss),
                                l2_weight=fe_cfg.optimization.l2_weight,
                                down_sampling_rate=fe_cfg.optimization.down_sampling_rate),
            tuple(re_specs), mf_specs=tuple(mf_specs), extra_fes=tuple(extra_fe_specs),
            update_order=update_order, normalization=norms.get(fe_shard),
            re_normalizations=re_normalizations,
            extra_fe_normalizations={sh: norms[sh] for sh in extra_fe_cid_of_shard
                                     if sh in norms},
            use_kernel_fe=self.use_kernel, mesh=self.mesh,
            fe_feature_sharded=self.fe_feature_sharded)

        # locked coordinates: fixed offsets and pass-through models
        locked_models: dict = {}
        train_ds, val_ds = dataset, validation_dataset
        if locked:
            def locked_total(ds) -> torch.Tensor:
                total = torch.zeros_like(ds.offsets)
                for cid in sequence:
                    if cid in locked:
                        m = initial_model.get(cid)
                        locked_models[cid] = m
                        total = total + ModelCoordinate(cid, ds, m).score(m)
                return total

            def with_extra_offsets(ds, extra):
                new_off = ds.offsets + extra
                return dataclasses.replace(ds, offsets=new_off, host_cache={
                    **ds.host_cache, "offsets": new_off.detach().cpu().numpy()})

            train_ds = with_extra_offsets(dataset, locked_total(dataset))
            if validation_dataset is not None:
                val_ds = with_extra_offsets(validation_dataset, locked_total(validation_dataset))

        warm_state = None
        if initial_model is not None:
            # model keys are coordinate ids; the program keys the FE by shard
            # and REs by effect type
            program_key = {} if fe_cid is None else {fe_cid: fe_shard}
            program_key.update({cid: sh for sh, cid in extra_fe_cid_of_shard.items()})
            program_key.update({cid: t for t, cid in re_cid_of_type.items()})
            remapped = {program_key.get(cid, cid): m for cid, m in initial_model.models.items()}
            if fe_pad and fe_shard in remapped:
                c = remapped[fe_shard].glm.coefficients
                remapped[fe_shard] = FixedEffectModel(
                    glm=GeneralizedLinearModel(Coefficients(
                        means=torch.nn.functional.pad(c.means, (0, fe_pad))), self.task),
                    feature_shard_id=fe_shard)
            warm_state = game_model_to_state(
                program, GameModel(models=remapped), train_ds, intercept_index=fe_intercept,
                missing_ok=True, re_datasets=re_datasets, mf_datasets=mf_datasets)

        def eval_data(ds):
            return EvaluationData(labels=ds.host_array("labels"), offsets=ds.host_array("offsets"),
                                  weights=ds.host_array("weights"), ids=ds.ids)

        evaluators = [parse_evaluator(s) for s in self.validation_evaluators]
        val_eval_data = (eval_data(validation_dataset)
                         if validation_dataset is not None and evaluators else None)
        if partition is not None:
            # this rank feeds only its block; no validation or metric riders
            # (the guard refused them); scheduled random effects compose, each
            # rank scheduling its own lanes
            from photon_ml_torch.algorithm.lane_scheduler import make_schedulers

            result = train_partitioned(
                program, {partition.info.rank: (train_ds, re_datasets)}, self.mesh,
                partition.info.num_ranks, num_iterations=self.num_iterations,
                state=warm_state, check_finite=self.check_finite,
                exchange=partition.exchange, fe_feature_sharded=self.fe_feature_sharded,
                checkpointer=self.checkpointer, checkpoint_every=self.checkpoint_every,
                resume=self.resume, resume_step=self.resume_step,
                schedulers=make_schedulers(program.re_specs) or None)
        else:
            result = train_distributed(
                program, train_ds, re_datasets, mf_datasets=mf_datasets, mesh=self.mesh,
                num_iterations=self.num_iterations, state=warm_state,
                fe_feature_sharded=self.fe_feature_sharded,
                validation_dataset=val_ds if val_eval_data is not None else None,
                validation_evaluators=evaluators, validation_eval_data=val_eval_data,
                training_evaluator=default_evaluator_for_task(self.task),
                training_eval_data=eval_data(dataset), check_finite=self.check_finite,
                checkpointer=self.checkpointer, checkpoint_every=self.checkpoint_every,
                resume=self.resume, exchange=self.exchange, resume_step=self.resume_step,
                on_sweep=None if self.telemetry is None else (
                    lambda sweep, total, loss: self.telemetry.heartbeat(
                        "fused_game", sweep=sweep, num_sweeps=total, loss=loss)))

        trainable_cids = {} if fe_cid is None else {fe_shard: fe_cid}
        trainable_cids.update(extra_fe_cid_of_shard)
        trainable_cids.update({t: cid for t, cid in re_cid_of_type.items()})
        compute_var = any(self.coordinate_configs[cid].optimization.compute_variance
                          for cid in sequence if cid not in locked)
        variance_re_types = {t for t, cid in re_cid_of_type.items()
                             if self.coordinate_configs[cid].optimization.compute_variance}

        def to_game_model(state) -> GameModel:
            m = state_to_game_model(
                program, state, train_ds, intercept_index=fe_intercept,
                compute_variance=compute_var, variance_mode=fe_cfg.optimization.variance_mode,
                re_datasets=re_datasets, variance_re_types=variance_re_types)
            models = dict(m.models)
            if fe_pad:
                # the padding columns' zero coefficients come off (saved
                # models keep the true dimension)
                c = models[fe_shard].glm.coefficients
                models[fe_shard] = FixedEffectModel(
                    glm=GeneralizedLinearModel(Coefficients(
                        means=c.means[:-fe_pad],
                        variances=None if c.variances is None else c.variances[:-fe_pad]),
                        self.task),
                    feature_shard_id=fe_shard)
            renamed = {trainable_cids.get(k, k): v for k, v in models.items()
                       if not (fe_cid is None and k == fe_shard)}
            renamed.update(locked_models)
            return GameModel(models={cid: renamed[cid] for cid in sequence if cid in renamed})

        final_model = to_game_model(result.state)
        best_model = (to_game_model(result.best_state) if result.best_state is not None
                      else final_model)
        if self.telemetry is not None:
            # the fused program carries no per-lane solver state out of its
            # sweeps; report the per-sweep evaluations under a synthetic id
            for i, m in enumerate(result.metric_history or []):
                self.telemetry.record_coordinate("fused-sweep", i, None, metrics=m)
        return CoordinateDescentResult(model=final_model, best_model=best_model,
                                       best_metric=result.best_metric,
                                       metric_history=result.metric_history)

    def refresh(self, dataset: GameDataset, resident_model: GameModel, policy=None, *,
                checkpointer=None, fingerprint: dict | None = None,
                resume: bool | None = None):
        """Incremental retrain (``algorithm/refresh.py``): solve again only the
        random-effect entities the policy selects (declared changed or
        gradient-screened), against residuals frozen at
        ``resident_model``'s scores, warm-started from its coefficients; the
        rest carries over bitwise. One process, no mesh."""
        from photon_ml_torch.algorithm.refresh import RefreshPolicy, run_incremental_refresh

        if self.mesh is not None or self.partition is not None:
            raise ValueError(
                "incremental refresh is the single-process host path; "
                "drop mesh/partition and refresh on one host, or run the "
                "full fused fit to retrain at mesh scale")
        sequence, coordinates = self._build_coordinates(dataset, resident_model)
        return run_incremental_refresh(
            coordinates, sequence, resident_model,
            policy if policy is not None else RefreshPolicy(),
            checkpointer=checkpointer if checkpointer is not None else self.checkpointer,
            resume=self.resume if resume is None else resume,
            check_finite=self.check_finite, telemetry=self.telemetry, fingerprint=fingerprint)

    def _build_coordinates(self, dataset: GameDataset, initial_model: GameModel | None):
        """(sequence, coordinate map), locked coordinates wrapped as
        ModelCoordinates."""
        sequence = list(self.update_sequence or self.coordinate_configs.keys())
        norms = self._prepare_normalization(dataset)
        coordinates: dict[str, Coordinate] = {}
        for cid in sequence:
            cfg = self.coordinate_configs[cid]
            if cid in self.locked_coordinates:
                if initial_model is None:
                    raise ValueError(
                        f"locked coordinate '{cid}' requires an initial model "
                        "(partial retraining needs a pre-trained model)")
                coordinates[cid] = ModelCoordinate(coordinate_id=cid, dataset=dataset,
                                                   model=initial_model.get(cid))
            elif isinstance(cfg, FixedEffectCoordinateConfig):
                coordinates[cid] = FixedEffectCoordinate(
                    coordinate_id=cid, dataset=dataset, feature_shard_id=cfg.feature_shard_id,
                    task=self.task, config=cfg.optimization,
                    normalization=norms.get(cfg.feature_shard_id),
                    intercept_index=self.intercept_indices.get(cfg.feature_shard_id),
                    use_kernel=self.use_kernel, kernel_unit=self.kernel_unit,
                    kernel_aux=self.kernel_aux)
            elif isinstance(cfg, MatrixFactorizationCoordinateConfig):
                coordinates[cid] = MatrixFactorizationCoordinate(
                    coordinate_id=cid, dataset=dataset,
                    mf_dataset=build_mf_dataset(
                        dataset, cfg.row_effect_type, cfg.col_effect_type,
                        active_data_upper_bound=cfg.active_data_upper_bound, seed=cfg.seed),
                    task=self.task, config=cfg.optimization,
                    num_latent_factors=cfg.num_latent_factors,
                    num_alternations=cfg.num_alternations, seed=cfg.seed)
            elif isinstance(cfg, RandomEffectCoordinateConfig):
                re_dataset = build_random_effect_dataset(
                    dataset, cfg.random_effect_type, cfg.feature_shard_id,
                    active_data_upper_bound=cfg.active_data_upper_bound,
                    active_data_lower_bound=cfg.active_data_lower_bound,
                    bucket_sizes=cfg.bucket_sizes,
                    projector_type=cfg.projector_type,
                    projected_dim=cfg.projected_dim,
                    features_to_samples_ratio=cfg.features_to_samples_ratio,
                    # projected and compact entity blocks are rewritten to
                    # normalized space at build time
                    # (IndexMapProjectorRDD.scala:134-147)
                    normalization=_build_normalization_for(cfg, dataset, norms))
                coordinates[cid] = RandomEffectCoordinate(
                    coordinate_id=cid, dataset=dataset, re_dataset=re_dataset, task=self.task,
                    config=cfg.optimization, normalization=norms.get(cfg.feature_shard_id),
                    intercept_index=self.intercept_indices.get(cfg.feature_shard_id))
            else:
                raise TypeError(f"coordinate '{cid}': unknown configuration {type(cfg).__name__}")
        return sequence, coordinates

    def _prepare_normalization(self, dataset: GameDataset) -> dict[str, NormalizationContext]:
        """Per-feature-shard normalization from feature summaries (reference
        GameTrainingDriver.prepareNormalizationContexts:545-562)."""
        norms: dict[str, NormalizationContext] = {}
        if self.normalization == NormalizationType.NONE:
            return norms
        weights = dataset.host_array("weights")
        for shard_id, features in dataset.feature_shards.items():
            intercept = self.intercept_indices.get(shard_id)
            norm_type = self.normalization
            if norm_type == NormalizationType.STANDARDIZATION and intercept is None:
                # mean-shifting needs an intercept to absorb the margin shift
                logger.warning(
                    "shard '%s' has no intercept_indices entry; using "
                    "SCALE_WITH_STANDARD_DEVIATION instead of STANDARDIZATION", shard_id)
                norm_type = NormalizationType.SCALE_WITH_STANDARD_DEVIATION
            if isinstance(features, SparseShard):
                stats = features.summarize(weights)
            else:
                stats = summarize(dataset.host_array(f"shard/{shard_id}"), weights)
            dtype = dataset.labels.dtype  # the solve dtype
            stat = {k: torch.as_tensor(np.asarray(stats[k]), dtype=dtype, device=dataset.device)
                    for k in ("mean", "variance", "max_magnitude")}
            norms[shard_id] = build_normalization(norm_type, **stat, intercept_index=intercept)
        return norms


def _build_normalization_for(cfg: RandomEffectCoordinateConfig, dataset: GameDataset,
                             norms) -> NormalizationContext | None:
    """The context an RE coordinate's entity blocks are pre-normalized with
    at dataset build: INDEX_MAP and RANDOM coordinates (RANDOM normalizes
    before sketching, which is exact), and sparse shards (which coerce to
    the compact INDEX_MAP form). IDENTITY coordinates on a dense shard
    normalize through the objective's context instead."""
    if cfg.projector_type in (ProjectorType.INDEX_MAP, ProjectorType.RANDOM) \
            or isinstance(dataset.feature_shards[cfg.feature_shard_id], SparseShard):
        return norms.get(cfg.feature_shard_id)
    return None


def _require_batch(batch) -> None:
    if not isinstance(batch, (LabeledPointBatch, SparseLabeledPointBatch)):
        raise TypeError(
            f"{type(batch).__name__} is not a training batch: pass a "
            "LabeledPointBatch or a SparseLabeledPointBatch"
        )


def _objective_for_batch(batch, loss, l2_weight, normalization,
                         use_kernel: bool | None = None):
    """Dense or sparse objective by batch type: one train_glm serves both
    the [n, d] block and the giant-d sparse layouts."""
    _require_batch(batch)
    cls = SparseGLMObjective if isinstance(batch, SparseLabeledPointBatch) else GLMObjective
    return cls(loss, l2_weight=l2_weight, normalization=normalization, use_kernel=use_kernel)


def train_glm(
    batch: LabeledPointBatch | SparseLabeledPointBatch,
    task: TaskType,
    *,
    optimizer: OptimizerConfig | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: float = 0.0,
    normalization: NormalizationContext | None = None,
    intercept_index: int | None = None,
    compute_variance: bool = False,
    variance_mode: str = "auto",
    lower_bounds=None,
    upper_bounds=None,
    telemetry=None,
    use_kernel: bool | None = None,
    on_solve: Callable[[float, SolverResult], None] | None = None,
) -> dict[float, GeneralizedLinearModel]:
    """Single-GLM regularization path with warm starts, on the batch's device.

    elastic_net_alpha: fraction of λ on L1 (α λ ‖w‖₁ + (1-α) λ/2 ‖w‖²); a λ
    with an L1 part is solved by OWL-QN. Returned models are in original
    feature space (warm starts stay in normalized space).

    compute_variance: attach per-coefficient variances at each optimum
    (``ops/variance.py``); ``variance_mode`` is "auto", "full" or
    "diagonal" (a sparse batch supports only the diagonal), checked before
    any λ trains.

    use_kernel: the objective's evaluation path (``ops/objective.py``,
    ``ops/sparse_objective.py``; None = the kernels on a CUDA batch). on_solve: called with
    (λ, SolverResult) after each λ's solve.

    telemetry: a ``telemetry.SolverTelemetry``: one convergence row
    (iterations, reason, value history) and one heartbeat a λ.
    """
    _require_batch(batch)
    optimizer = resolve_auto_optimizer(optimizer or OptimizerConfig())
    validate_variance_mode(variance_mode)
    has_bounds = lower_bounds is not None or upper_bounds is not None
    if has_bounds and (
        elastic_net_alpha > 0.0
        or optimizer.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.LBFGSB)
    ):
        # fail before any λ trains; solve() enforces the same rule
        raise ValueError(
            "box constraints require the LBFGS family without L1 "
            "(elastic_net_alpha must be 0)"
        )
    loss = loss_for_task(task)
    if compute_variance:  # an explicit "full" on a sparse batch fails here
        resolve_variance_mode_for(_objective_for_batch(batch, loss, 0.0, normalization),
                                  variance_mode, batch.dim)

    def bound_tensor(b):
        return None if b is None else torch.as_tensor(b, dtype=batch.solve_dtype,
                                                      device=batch.device)

    models: dict[float, GeneralizedLinearModel] = {}
    w = torch.zeros((batch.dim,), dtype=batch.solve_dtype, device=batch.device)
    for lam in sorted(regularization_weights):
        l1 = elastic_net_alpha * lam
        l2 = (1.0 - elastic_net_alpha) * lam
        objective = _objective_for_batch(batch, loss, l2, normalization, use_kernel)
        opt = optimizer
        if l1 > 0.0:
            opt = dataclasses.replace(optimizer.with_l1(l1), optimizer_type=OptimizerType.OWLQN)
        result = solve(opt, objective.bind(batch), w,
                       lower_bounds=bound_tensor(lower_bounds),
                       upper_bounds=bound_tensor(upper_bounds))
        w = result.coefficients
        if telemetry is not None:
            telemetry.record_solve("glm", result, extra={"lambda": lam})
            telemetry.heartbeat("glm", lam=lam, n_lambdas=len(regularization_weights))
        if on_solve is not None:
            on_solve(lam, result)
        norm = objective.normalization
        means = norm.to_model_space(w, intercept_index)
        variances = None
        if compute_variance:
            variances = norm.variances_to_model_space(
                coefficient_variances(objective, w, batch, mode=variance_mode))
        models[lam] = GeneralizedLinearModel(Coefficients(means=means, variances=variances), task)
        logger.info("trained λ=%g: value=%g iters=%d", lam, float(result.value),
                    result.iterations)
    return models


@partial(ledger_call, label="glm/grid_solve", static_argnums=(0, 1, 2))
def _grid_solve(objective, use_owlqn: bool, optimizer: OptimizerConfig, batch, l2v, l1v,
                tolerance, w0v, bounds=None):
    """Every λ lane's solve at once (``lane_search.solve_lanes``)."""
    from photon_ml_torch.algorithm.lane_search import solve_lanes

    return solve_lanes(objective, use_owlqn, optimizer, batch, l2v, l1v, tolerance, w0v,
                       bounds)


@partial(ledger_call, label="glm/grid_diagonals", static_argnums=(0,))
def _grid_diagonals(objective, batch, w: torch.Tensor, l2) -> torch.Tensor:
    """One λ lane's Hessian diagonal with its L2 term."""
    return objective.hessian_diagonal(w, batch) + l2


@partial(ledger_call, label="glm/grid_full_variances", static_argnums=(0,))
def _grid_full_variances(objective, batch, w: torch.Tensor, l2) -> torch.Tensor:
    """One λ lane's diag(H⁻¹) (DistributedOptimizationProblem.scala:82-96)."""
    h = objective.hessian_matrix(w, batch)
    h = h + l2 * torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    return diag_inverse_from_hessian(h)


def train_glm_grid(
    batch: LabeledPointBatch | SparseLabeledPointBatch,
    task: TaskType,
    *,
    optimizer: OptimizerConfig | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: float = 0.0,
    normalization: NormalizationContext | None = None,
    intercept_index: int | None = None,
    compute_variance: bool = False,
    variance_mode: str = "auto",
    lower_bounds=None,
    upper_bounds=None,
    telemetry=None,
    use_kernel: bool | None = None,
) -> dict[float, GeneralizedLinearModel]:
    """Train the whole regularization grid at once, one solver lane per λ.

    The alternative to :func:`train_glm`'s sequential warm-start path
    (reference ModelTraining.scala:202-220): all λ lanes share every read
    of the feature block, so on a dense batch the per-lane margins are one
    ``X @ Wᵀ`` product instead of |λ| products, and a sparse batch runs its
    kernels once per lane and evaluation (``algorithm/lane_search.py``).
    Lanes start cold instead of warm from the previous λ. L-BFGS and OWL-QN
    lanes (elastic net included), with an optional box shared by every
    lane; TRON stays on the sequential path. Variances are per lane, full
    (diag(H⁻¹)) or diagonal. ``telemetry``: a ``telemetry.SolverTelemetry``
    that gets the lanes' convergence rows, keyed by λ.
    ``use_kernel``: the sparse objective's evaluation path, as in
    :func:`train_glm` (``False`` takes the plain gathers, the only path of a
    float64 batch on the card); the dense lanes are a library product.

    The λ-only case of the configuration tournaments
    (``algorithm/lane_search.py``); a uniform tournament is bitwise this.
    """
    _require_batch(batch)
    optimizer = resolve_auto_optimizer(optimizer or OptimizerConfig())
    if optimizer.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.OWLQN):
        raise ValueError(
            "train_glm_grid supports LBFGS/OWLQN lanes; use train_glm for "
            f"{optimizer.optimizer_type.name}")
    use_owlqn = elastic_net_alpha > 0.0 or optimizer.optimizer_type == OptimizerType.OWLQN
    has_bounds = lower_bounds is not None or upper_bounds is not None
    if use_owlqn and has_bounds:
        raise ValueError("box constraints cannot combine with OWL-QN / elastic-net lanes")
    loss = loss_for_task(task)
    objective = _objective_for_batch(batch, loss, 0.0, normalization, use_kernel)
    validate_variance_mode(variance_mode)
    resolved_variance = None
    if compute_variance:
        resolved_variance = resolve_variance_mode_for(
            objective, variance_mode, batch.dim, num_problems=len(regularization_weights))
    dtype, device = batch.solve_dtype, batch.device

    def lanes(values):
        return torch.as_tensor(values, dtype=dtype, device=device)

    lams = sorted(float(l) for l in regularization_weights)
    l2s = lanes([(1.0 - elastic_net_alpha) * l for l in lams])
    # the elastic-net component overrides the config's own l1_weight (train_glm)
    l1s = (lanes([elastic_net_alpha * l for l in lams]) if elastic_net_alpha > 0.0
           else torch.full((len(lams),), optimizer.l1_weight, dtype=dtype, device=device))
    bounds = None
    if has_bounds:
        inf = torch.full((batch.dim,), float("inf"), dtype=dtype, device=device)
        bounds = (-inf if lower_bounds is None else lanes(lower_bounds),
                  inf if upper_bounds is None else lanes(upper_bounds))
    w0 = torch.zeros((len(lams), batch.dim), dtype=dtype, device=device)
    results = _grid_solve(objective, use_owlqn, optimizer, batch, l2s, l1s,
                          optimizer.tolerance, w0, bounds)
    if telemetry is not None:
        telemetry.record_lanes("glm-grid", results, keys=[{"lambda": lam} for lam in lams])
    norm = objective.normalization
    models: dict[float, GeneralizedLinearModel] = {}
    for i, lam in enumerate(lams):
        w = results.coefficients[i]
        variances = None
        if resolved_variance == "full":
            variances = norm.variances_to_model_space(
                _grid_full_variances(objective, batch, w, l2s[i]))
        elif resolved_variance is not None:
            variances = norm.variances_to_model_space(
                inverse_of_diagonal(_grid_diagonals(objective, batch, w, l2s[i])))
        models[lam] = GeneralizedLinearModel(
            Coefficients(means=norm.to_model_space(w, intercept_index), variances=variances),
            task)
    return models


def train_glm_tournament(batch, task: TaskType, configs, *,
                         optimizer: OptimizerConfig | None = None, warm_start=None,
                         normalization: NormalizationContext | None = None,
                         intercept_index: int | None = None, telemetry=None):
    """One configuration tournament (per-lane L1/L2/tolerance/box vectors,
    the generalization of :func:`train_glm_grid`'s λ lanes).

    ``configs``: ``algorithm.lane_search.LaneConfigs``. Returns its
    TournamentResult; the search above it is ``hyperparameter/search_driver.py``.
    """
    from photon_ml_torch.algorithm.lane_search import run_lane_tournament

    return run_lane_tournament(batch, task, configs, optimizer=optimizer,
                               warm_start=warm_start, normalization=normalization,
                               intercept_index=intercept_index, telemetry=telemetry)


def _normalization_digest(norm) -> str | None:
    """16-hex digest of a NormalizationContext's factor and shift arrays
    (None without normalization): the streamed checkpoint's fingerprint
    field, the JAX package's digest of the same bytes."""
    if norm is None:
        return None
    import hashlib

    h = hashlib.sha256()
    for part in (norm.factors, norm.shifts):
        if part is None:
            h.update(b"none")
        else:
            h.update(np.ascontiguousarray(part.detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def train_glm_streaming(
    source,
    task: TaskType,
    *,
    optimizer: OptimizerConfig | None = None,
    regularization_weights: Sequence[float] = (0.0,),
    elastic_net_alpha: float = 0.0,
    normalization: NormalizationContext | None = None,
    intercept_index: int | None = None,
    telemetry=None,
    mesh=None,
    exchange=None,
    prefetch: bool = True,
    retry_policy=None,
    chunk_timeout: float | None = None,
    lower_bounds=None,
    upper_bounds=None,
    checkpointer=None,
    use_kernel: bool | None = None,
    device=None,
    on_solve: Callable | None = None,
) -> dict[float, GeneralizedLinearModel]:
    """The warm-started λ path of :func:`train_glm` over an out-of-core chunk
    source (``io/stream_reader.ChunkSource``), on ``device`` (CUDA unless
    ``"cpu"``). Every objective evaluation is one exact chunked epoch
    (``algorithm/streaming.StreamingGLMObjective``), with the next chunk's
    decode behind the current one's copy and accumulation
    (``prefetch=False`` decodes inline). L-BFGS, LBFGSB, OWL-QN and TRON
    only: NEWTON needs the dense [d, d] Hessian.

    ``checkpointer``: an ``io/checkpoint.SolverCheckpointer``. Every
    ``save_every`` outer iterations and at each λ boundary it saves the
    solver state, the λ-grid position, the epoch cursor and the finished
    λs' coefficients; a restarted run skips the finished λs and re-enters
    the solve in flight from its state, bitwise where it left off. A
    checkpoint written under another λ grid, optimizer or input fails fast
    naming the fields that differ. The fingerprint and the saved fields are
    the JAX package's, so either package resumes the other's checkpoints.

    on_solve: called with (λ, SolverResult, the λ's StreamingGLMObjective)
    after each λ's solve. ``telemetry``: a ``telemetry.SolverTelemetry``:
    one convergence row a λ and a heartbeat at every outer iteration (an
    epoch boundary).

    ``exchange``: a ``parallel.multihost.MetadataExchange``; each rank
    streams its own chunks (``io/stream_reader.plan_partitioned_stream``)
    and every epoch's accumulators sum across the ranks in rank order, so
    every rank solves the same problem. ``mesh``: the port's data-axis mesh
    (``algorithm/streaming.resolve_rank_exchange``). With an exchange, rank
    0 alone writes the checkpoints (a shared directory) and every rank
    restores the same one.
    """
    from photon_ml_torch.algorithm.streaming import StreamingGLMObjective, resolve_rank_exchange
    from photon_ml_torch.io.checkpoint import host_array
    from photon_ml_torch.io.stream_reader import DEFAULT_CHUNK_TIMEOUT
    from photon_ml_torch.optim.optimizer import solver_state_class
    from photon_ml_torch.resilience import recovery

    exchange = resolve_rank_exchange(mesh, exchange)
    writes = exchange is None or exchange.rank == 0
    device = resolve_device(device)
    optimizer = resolve_auto_optimizer(optimizer or OptimizerConfig())
    if optimizer.optimizer_type == OptimizerType.NEWTON:
        raise ValueError("NEWTON cannot stream (dense [d, d] Hessian); use TRON for "
                         "streamed second-order solves")
    has_bounds = lower_bounds is not None or upper_bounds is not None
    if has_bounds and (elastic_net_alpha > 0.0 or optimizer.optimizer_type
                       not in (OptimizerType.LBFGS, OptimizerType.LBFGSB)):
        raise ValueError("box constraints require the LBFGS family without L1 "
                         "(elastic_net_alpha must be 0)")
    loss = loss_for_task(task)
    solve_dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(source.dtype))).dtype
    lams = sorted(float(lam) for lam in regularization_weights)

    def bound_tensor(b):
        return None if b is None else torch.as_tensor(b, dtype=solve_dtype, device=device)

    fingerprint = None
    start_index = 0
    completed: list[tuple[float, np.ndarray]] = []
    resume_state_arrays = None
    epochs_total = 0
    resume_epochs_lambda = 0
    if checkpointer is not None:
        # everything a restored state is valid under (the JAX package's fields)
        fingerprint = {
            "kind": "glm_streaming",
            "task": task.name,
            "lambdas": lams,
            "optimizer": optimizer.optimizer_type.name,
            "max_iterations": int(optimizer.max_iterations),
            "history": int(optimizer.history),
            "tolerance": float(optimizer.tolerance),
            "rel_function_tolerance": (None if optimizer.rel_function_tolerance is None
                                       else float(optimizer.rel_function_tolerance)),
            "max_cg_iterations": int(optimizer.max_cg_iterations),
            "elastic_net_alpha": float(elastic_net_alpha),
            "normalization": _normalization_digest(normalization),
            "intercept_index": None if intercept_index is None else int(intercept_index),
            "bounded": bool(has_bounds),
            "dim": int(source.dim),
            "num_chunks": int(source.num_chunks),
            "total_records": int(source.total_records),
            "num_ranks": 1 if exchange is None else int(exchange.num_ranks),
            "input": (None if getattr(source, "files", None) is None
                      else [[os.path.basename(f), int(os.path.getsize(f))]
                            for f in source.files]),
        }
        progress = checkpointer.restore_progress(fingerprint)
        if progress is not None:
            start_index = progress.lam_index
            completed = list(progress.completed)
            resume_state_arrays = progress.state_arrays
            epochs_total = progress.epochs_total
            resume_epochs_lambda = progress.epochs_lambda
            recovery.counts["checkpoint_restores"] += 1
            recovery.counts["epochs_resumed"] += progress.epochs_total + progress.epochs_lambda
            logger.info("resuming streaming solve from checkpoint: λ %d/%d, iteration %d "
                        "(%d epochs not redone)", start_index, len(lams), progress.iteration,
                        progress.epochs_total + progress.epochs_lambda)

    models: dict[float, GeneralizedLinearModel] = {}
    w = torch.zeros((source.dim,), dtype=solve_dtype, device=device)
    for li, lam in enumerate(lams):
        l1 = elastic_net_alpha * lam
        l2 = (1.0 - elastic_net_alpha) * lam
        objective = StreamingGLMObjective(
            source, loss, l2_weight=l2, normalization=normalization, prefetch=prefetch,
            retry_policy=retry_policy,
            chunk_timeout=DEFAULT_CHUNK_TIMEOUT if chunk_timeout is None else chunk_timeout,
            use_kernel=use_kernel, device=device, exchange=exchange)
        norm = objective.objective.normalization
        if li < start_index:
            # finished before the restored checkpoint: its saved solve-space
            # coefficients are the model and the next λ's warm start
            w = torch.as_tensor(completed[li][1], device=device).to(solve_dtype)
            models[lam] = GeneralizedLinearModel(
                Coefficients(means=norm.to_model_space(w, intercept_index)), task)
            continue
        opt = optimizer
        if l1 > 0.0:
            opt = dataclasses.replace(optimizer.with_l1(l1), optimizer_type=OptimizerType.OWLQN)
        resume_state = None
        if li == start_index and resume_state_arrays is not None:
            resume_state = solver_state_class(opt).from_arrays(
                resume_state_arrays, dtype=solve_dtype, device=device)
            objective.epochs = resume_epochs_lambda
        observers = []
        if telemetry is not None:
            # the epoch cursor a wedged run is diagnosed by; observes only
            def heartbeat(state, _li=li, _obj=objective):
                telemetry.heartbeat("glm_streaming", lam_index=_li, n_lambdas=len(lams),
                                    iteration=int(state.iteration), epochs=_obj.epochs)

            observers.append(heartbeat)
        if checkpointer is not None and writes:
            def checkpoint(state, _li=li, _obj=objective, _mi=opt.max_iterations):
                if state.iteration % checkpointer.save_every:
                    return
                if state.reason != 0 or state.iteration >= _mi:
                    # the loop ends on this state: the λ-boundary save covers it
                    return
                checkpointer.save_progress(
                    fingerprint=fingerprint, lam_index=_li, iteration=state.iteration,
                    epochs_total=epochs_total, epochs_lambda=_obj.epochs,
                    completed=completed, solver_state=state)

            observers.append(checkpoint)

        def state_observer(state, _obs=tuple(observers)):
            for obs in _obs:
                obs(state)

        result = solve(opt, objective, w, lower_bounds=bound_tensor(lower_bounds),
                       upper_bounds=bound_tensor(upper_bounds),
                       state_observer=state_observer if observers else None,
                       resume_state=resume_state)
        w = result.coefficients
        if checkpointer is not None:
            completed.append((lam, host_array(w)))
            epochs_total += objective.epochs
            if writes:
                # λ boundary: a failure between λs resumes with this λ done
                checkpointer.save_progress(
                    fingerprint=fingerprint, lam_index=li + 1, iteration=0,
                    epochs_total=epochs_total, epochs_lambda=0, completed=completed,
                    solver_state=None)
        if telemetry is not None:
            telemetry.record_solve("glm_streaming", result,
                                   extra={"lambda": lam, "epochs": objective.epochs,
                                          "chunks": source.num_chunks})
        if on_solve is not None:
            on_solve(lam, result, objective)
        models[lam] = GeneralizedLinearModel(
            Coefficients(means=norm.to_model_space(w, intercept_index)), task)
        logger.info("streamed λ=%g: value=%g iters=%d epochs=%d", lam, float(result.value),
                    result.iterations, objective.epochs)
    return models
