"""Training coordinates: fixed-effect and random-effect updates.

Counterpart of ``photon_ml_tpu/algorithm/coordinates.py``; reference
photon-api algorithm/FixedEffectCoordinate.scala:91-165,
algorithm/RandomEffectCoordinate.scala:104-153 (per-entity local solves),
the locked-model coordinates and algorithm/CoordinateFactory.scala:50-111.

- Fixed effect: one solve over the whole sample axis. On a CUDA dense block
  the labels, the offsets with the residual scores added, and the
  (down-sampled) weights are packed once per update into the ``[n, 3]``
  block of ``ops/packed_glm.py``, and every evaluation of the solve streams
  X and that block through the hand-written kernel.
- Random effect: each entity bucket is one lane-batched solve
  (``optim/lanes.py``, ``optim/newton.py``): thousands of independent small
  problems advancing in lock-step. Warm starts flow in as the per-entity
  table rows; results scatter back into the [E, d] table.
- Residual offsets arrive as ``extra_offsets`` (the partial-score mechanism
  of coordinate descent, reference Coordinate.scala:60-63).
- Projected random effects (``projector/projectors.py``): an INDEX_MAP
  bucket gathers each entity's warm start through its column index from an
  ``[E, d+1]`` table (the last column a scratch slot for pad slots) and
  scatters the solve back; a RANDOM bucket warm-starts from ``table[rows] @ P``
  and back-projects with ``solved @ Pᵀ``. Pre-normalized blocks solve on a
  plain objective.

A random effect on a sparse shard is compact: its table is ``[E, K]`` over
each entity's active columns and its buckets' column index holds table
positions (pad = K), so the INDEX_MAP bucket solve runs on it unchanged and
normalization converts it through the ``*_compact`` context methods. The
lanes are L-BFGS, Newton, OWL-QN (with an L1 weight) or TRON.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial

import numpy as np
import torch

from photon_ml_torch.data.batch import solve_dtype_of
from photon_ml_torch.data.game_data import GameDataset, RandomEffectDataset
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import DatumScoringModel, FixedEffectModel, RandomEffectModel
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops.lane_objective import LaneObjective
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.ops.variance import (
    FULL_VARIANCE_MAX_DIM,
    coefficient_variances,
    diag_inverse_from_hessian,
    full_inverse_from_hessian,
    inverse_of_diagonal,
    resolve_variance_mode,
    resolve_variance_mode_for,
    validate_variance_mode,
)
from photon_ml_torch.optim.common import LaneTrace, LaneTraces, lane_trace_of
from photon_ml_torch.optim.lanes import minimize_lbfgs_lanes
from photon_ml_torch.optim.newton import minimize_newton
from photon_ml_torch.optim.owlqn import minimize_owlqn_lanes
from photon_ml_torch.optim.tron import minimize_tron_lanes
from photon_ml_torch.optim.optimizer import (
    OptimizerConfig,
    OptimizerType,
    resolve_auto_optimizer,
    solve,
)
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.sampling.down_sampler import down_sampler_for_task
from photon_ml_torch.telemetry.program_ledger import ledger_call
from photon_ml_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class CoordinateOptimizationConfig:
    """Per-coordinate optimization settings (reference
    GLMOptimizationConfiguration: optimizer + reg weights + variance flag)."""

    optimizer: OptimizerConfig
    l2_weight: float = 0.0
    l1_weight: float = 0.0
    compute_variance: bool = False
    variance_mode: str = "auto"  # "auto" | "full" (diag(H⁻¹)) | "diagonal"
    down_sampling_rate: float = 1.0

    def __post_init__(self):
        validate_variance_mode(self.variance_mode)

    @property
    def uses_owlqn(self) -> bool:
        return self.l1_weight > 0.0 or self.optimizer.optimizer_type == OptimizerType.OWLQN


class Coordinate:
    """One block of the coordinate-descent update (reference Coordinate[D])."""

    coordinate_id: str

    def update_model(self, model: DatumScoringModel, extra_offsets: torch.Tensor | None):
        """Train this coordinate with residual offsets; returns (model, info)."""
        raise NotImplementedError

    def score(self, model: DatumScoringModel) -> torch.Tensor:
        raise NotImplementedError

    def initial_model(self) -> DatumScoringModel:
        raise NotImplementedError

    def skip_update(self) -> None:
        """Account for an update a restored checkpoint already holds (a
        resumed coordinate descent skips it), so per-update state such as a
        down-sampling seed continues where the interrupted run left it."""


def _make_objective(task: TaskType, cfg: CoordinateOptimizationConfig,
                    normalization: NormalizationContext | None, sparse: bool = False,
                    use_kernel: bool | None = None, kernel_unit: str = "fma",
                    kernel_aux: str = "packed") -> GLMObjective | SparseGLMObjective:
    """The fixed-effect solve's objective (dense or sparse by batch type)."""
    if sparse:
        return SparseGLMObjective(loss_for_task(task), l2_weight=cfg.l2_weight,
                                  normalization=normalization, use_kernel=use_kernel)
    return GLMObjective(loss_for_task(task), l2_weight=cfg.l2_weight,
                        normalization=normalization, use_kernel=use_kernel,
                        kernel_unit=kernel_unit, kernel_aux=kernel_aux)


def _solve_config(cfg: CoordinateOptimizationConfig, *, loss=None,
                  small_dense: bool = False) -> OptimizerConfig:
    """Concrete solver config for one coordinate solve: resolves AUTO
    (NEWTON on the small dense per-entity solves, LBFGS elsewhere) and then
    applies the elastic-net OWLQN flip, which overrides any resolution."""
    opt = resolve_auto_optimizer(cfg.optimizer, loss=loss, small_dense=small_dense)
    if cfg.uses_owlqn:
        opt = dataclasses.replace(opt, optimizer_type=OptimizerType.OWLQN,
                                  l1_weight=cfg.l1_weight)
    return opt


@dataclasses.dataclass
class FixedEffectCoordinate(Coordinate):
    """Trains one GLM on a feature shard over the full sample axis.

    Models are held in original feature space: training converts the warm
    start into normalized space, solves there, and converts back, so scoring
    and persistence never need the normalization context.
    """

    coordinate_id: str
    dataset: GameDataset
    feature_shard_id: str
    task: TaskType
    config: CoordinateOptimizationConfig
    normalization: NormalizationContext | None = None
    intercept_index: int | None = None
    #: the solve's evaluation path: None = the kernel on a CUDA block, True =
    #: the kernel (its plain version on the CPU), False = the closed form
    use_kernel: bool | None = None
    #: unit of the packed kernel's two products: "fma" or "mma"
    kernel_unit: str = "fma"
    #: "packed" ([n, 3] aux block, packed once per update) or "columns"
    kernel_aux: str = "packed"
    _update_count: int = dataclasses.field(default=0, init=False, repr=False)

    def initial_model(self) -> FixedEffectModel:
        shard = self.dataset.feature_shards[self.feature_shard_id]
        means = torch.zeros((shard.shape[1],), dtype=solve_dtype_of(shard.dtype),
                            device=self.dataset.device)
        return FixedEffectModel(glm=GeneralizedLinearModel(Coefficients(means=means), self.task),
                                feature_shard_id=self.feature_shard_id)

    def skip_update(self) -> None:
        if self.config.down_sampling_rate < 1.0:
            self._update_count += 1  # the seed the skipped update used

    def update_model(self, model: FixedEffectModel, extra_offsets: torch.Tensor | None = None):
        batch = self.dataset.fixed_effect_batch(self.feature_shard_id, extra_offsets)
        if self.config.down_sampling_rate < 1.0:
            # training-only thinning by weight zeroing (reference
            # DistributedOptimizationProblem.runWithSampling:145-160); scoring
            # still covers every sample. The seed rotates per update, so the
            # excluded rows differ across sweeps, deterministically.
            sampler = down_sampler_for_task(self.task, self.config.down_sampling_rate)
            new_w = sampler.down_sample_weights(
                self.dataset.host_array("labels"), self.dataset.host_array("weights"),
                self.dataset.unique_ids, seed=self._update_count)
            self._update_count += 1
            weights = torch.as_tensor(new_w, dtype=batch.weights.dtype, device=batch.device)
            batch = (batch.replace(weights=weights) if isinstance(batch, SparseLabeledPointBatch)
                     else dataclasses.replace(batch, weights=weights))
        sparse = isinstance(batch, SparseLabeledPointBatch)
        objective = _make_objective(self.task, self.config, self.normalization, sparse=sparse,
                                    use_kernel=self.use_kernel, kernel_unit=self.kernel_unit,
                                    kernel_aux=self.kernel_aux)
        if self.config.compute_variance:
            # a full-variance-on-sparse config fails before the solve
            resolve_variance_mode_for(objective, self.config.variance_mode, batch.dim)
        norm = objective.normalization
        w0 = norm.from_model_space(model.glm.coefficients.means, self.intercept_index)
        result = _fe_solve(objective, _solve_config(self.config, loss=objective.loss), batch, w0)
        means = norm.to_model_space(result.coefficients, self.intercept_index)
        variances = None
        if self.config.compute_variance:
            variances = norm.variances_to_model_space(coefficient_variances(
                objective, result.coefficients, batch, mode=self.config.variance_mode))
        glm = GeneralizedLinearModel(Coefficients(means=means, variances=variances), self.task)
        return FixedEffectModel(glm=glm, feature_shard_id=self.feature_shard_id), result

    def score(self, model: FixedEffectModel) -> torch.Tensor:
        return model.score_dataset(self.dataset)


@partial(ledger_call, label="coord/fe_solve", static_argnums=(0, 1))
def _fe_solve(objective, opt: OptimizerConfig, batch, w0: torch.Tensor):
    """The fixed effect's solve over its (dense: packed once) batch."""
    sparse = isinstance(batch, SparseLabeledPointBatch)
    bound = objective.bind(batch) if sparse else objective.bind_packed(batch)
    return solve(opt, bound, w0)


def _bucket_offsets(sample_rows: torch.Tensor, full_offsets: torch.Tensor) -> torch.Tensor:
    rows = sample_rows.long()
    gathered = full_offsets[torch.clamp(rows, min=0)]
    return torch.where(rows >= 0, gathered, torch.zeros_like(gathered))


def _lane_objective(objective: GLMObjective, features, labels, weights, offsets):
    return LaneObjective(objective.loss, features, labels, offsets, weights,
                         l2_weight=objective.l2_weight, normalization=objective.normalization)


def _solve_bucket_entities(objective: GLMObjective, opt: OptimizerConfig, features, labels,
                           weights, offsets, w0s) -> tuple[torch.Tensor, LaneTrace]:
    """Lane-batched per-entity solves: ([e, k] solved coefficients, [e] trace),
    with the single-problem ``solve``'s dispatch and refusals (no box
    constraints reach a random effect, so LBFGSB raises as it does there)."""
    lanes = _lane_objective(objective, features, labels, weights, offsets)
    t = opt.optimizer_type
    if t == OptimizerType.AUTO:
        raise ValueError("OptimizerType.AUTO must be resolved before the bucket solve")
    loss_name = type(objective.loss).__name__
    if t == OptimizerType.LBFGS:
        result = minimize_lbfgs_lanes(
            lanes.value_and_grad, w0s, max_iter=opt.max_iterations, history=opt.history,
            tolerance=opt.tolerance, rel_function_tolerance=opt.rel_function_tolerance)
    elif t == OptimizerType.LBFGSB:
        raise ValueError("LBFGSB requires box constraints")
    elif t == OptimizerType.OWLQN:
        result = minimize_owlqn_lanes(
            lanes.value_and_grad, w0s, l1_weight=opt.l1_weight, max_iter=opt.max_iterations,
            history=opt.history, tolerance=opt.tolerance,
            rel_function_tolerance=opt.rel_function_tolerance)
    elif t == OptimizerType.TRON:
        if not objective.loss.twice_differentiable:
            raise ValueError(f"TRON requires a twice-differentiable loss, got {loss_name}"
                             " (reference restricts smoothed-hinge to the LBFGS family)")
        result = minimize_tron_lanes(
            lanes.value_and_grad, lanes.hessian_vector_at, w0s, max_iter=opt.max_iterations,
            tolerance=opt.tolerance, rel_function_tolerance=opt.rel_function_tolerance,
            max_cg_iter=opt.max_cg_iterations)
    elif t == OptimizerType.NEWTON:
        if not objective.loss.twice_differentiable:
            raise ValueError(
                f"NEWTON requires a twice-differentiable loss, got {loss_name} "
                "(same restriction as TRON)")
        result = minimize_newton(
            lanes.value_and_grad, lanes.hessian_matrix, w0s, value_fn=lanes.value,
            max_iter=opt.max_iterations, tolerance=opt.tolerance,
            rel_function_tolerance=opt.rel_function_tolerance)
    else:
        raise ValueError(f"Unknown optimizer type {t}")
    return result.coefficients, lane_trace_of(result)


def _mask_padding_lanes(trace: LaneTrace, entity_rows: torch.Tensor, num_rows: int) -> LaneTrace:
    """Mark padding lanes invalid: out-of-range entity rows solve
    all-zero-weight problems whose iteration counts and reasons must not
    enter convergence tallies."""
    return trace.replace(valid=(entity_rows >= 0) & (entity_rows < num_rows))


def _scatter_rows(table: torch.Tensor, entity_rows: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with ``values`` written at ``entity_rows``;
    out-of-range rows (padding lanes) are dropped."""
    rows = entity_rows.long()
    valid = (rows >= 0) & (rows < table.shape[0])
    return table.index_copy(0, rows[valid], values[valid].to(table.dtype))


def _gather_rows(table: torch.Tensor, entity_rows: torch.Tensor) -> torch.Tensor:
    """table[entity_rows] with out-of-range rows clamped (padding lanes get
    some row's warm start; their problem is all zero weights)."""
    return table[torch.clamp(entity_rows.long(), min=0, max=max(table.shape[0] - 1, 0))]


@partial(ledger_call, label="coord/re_bucket_solve", static_argnums=(0, 1))
def solve_entity_bucket_traced(objective: GLMObjective, opt: OptimizerConfig, features, labels,
                               weights, sample_rows, entity_rows, full_offsets,
                               table) -> tuple[torch.Tensor, LaneTrace]:
    """Solve every entity in a bucket and write the results into a copy of
    the table; returns it with the per-lane trace (padding lanes invalid)."""
    offsets = _bucket_offsets(sample_rows, full_offsets)
    solved, trace = _solve_bucket_entities(objective, opt, features, labels, weights, offsets,
                                           _gather_rows(table, entity_rows))
    trace = _mask_padding_lanes(trace, entity_rows, table.shape[0])
    return _scatter_rows(table, entity_rows, solved), trace


def solve_entity_bucket(objective, opt, features, labels, weights, sample_rows, entity_rows,
                        full_offsets, table) -> torch.Tensor:
    return solve_entity_bucket_traced(objective, opt, features, labels, weights, sample_rows,
                                      entity_rows, full_offsets, table)[0]


def _lane_variances(lanes: LaneObjective, w: torch.Tensor, mode: str) -> torch.Tensor:
    """diag(H⁻¹) by one batched Cholesky ("full"), or 1/diag(H)."""
    if mode == "full":
        return diag_inverse_from_hessian(lanes.hessian_matrix(w))
    return inverse_of_diagonal(lanes.hessian_diagonal(w))


def _by_mode(full, diagonal):
    """One variance function (whose last argument is the mode) under two
    program labels, the first for "full" and the second otherwise, as the
    JAX package compiles one program for each mode."""

    @functools.wraps(full.wrapped)
    def run(*args):
        return (full if args[-1] == "full" else diagonal)(*args)

    return run


def _bucket_variances(objective: GLMObjective, bucket, full_offsets, table, var_table,
                      mode: str) -> torch.Tensor:
    """Per-entity variances at the solved coefficients written into a copy of
    ``var_table``: diag(H⁻¹) by one batched Cholesky ("full"), or 1/diag(H)."""
    offsets = _bucket_offsets(bucket.sample_rows, full_offsets)
    lanes = _lane_objective(objective, bucket.features, bucket.labels, bucket.weights, offsets)
    return _scatter_rows(var_table, bucket.entity_rows,
                         _lane_variances(lanes, _gather_rows(table, bucket.entity_rows), mode))


def _gather_cells(table_ext: torch.Tensor, entity_rows: torch.Tensor,
                  col_index: torch.Tensor) -> torch.Tensor:
    """table_ext[entity_rows[:, None], col_index]: [e, k], out-of-range rows
    clamped like :func:`_gather_rows`."""
    rows = torch.clamp(entity_rows.long(), min=0, max=max(table_ext.shape[0] - 1, 0))
    return table_ext[rows.unsqueeze(1), col_index.long()]


def _scatter_cells(table_ext: torch.Tensor, entity_rows: torch.Tensor, col_index: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """A copy of ``table_ext`` with ``values`` [e, k] written at
    (entity_rows, col_index); padding lanes are dropped. Pad slots all write
    the scratch column, whose value is then arbitrary: the caller re-zeroes
    or drops it before any read."""
    rows = entity_rows.long()
    valid = (rows >= 0) & (rows < table_ext.shape[0])
    cols = col_index.long()[valid]
    out = table_ext.clone()
    out[rows[valid].unsqueeze(1).expand_as(cols), cols] = values[valid].to(out.dtype)
    return out


def _with_scratch_column(table: torch.Tensor) -> torch.Tensor:
    """[E, d] -> [E, d+1], the last column zero: the slot every INDEX_MAP pad
    slot gathers from and scatters to."""
    return torch.cat([table, torch.zeros((table.shape[0], 1), dtype=table.dtype,
                                         device=table.device)], dim=1)


@partial(ledger_call, label="coord/re_bucket_solve_indexmap", static_argnums=(0, 1))
def solve_entity_bucket_indexmap_traced(objective: GLMObjective, opt: OptimizerConfig, features,
                                        labels, weights, sample_rows, entity_rows, col_index,
                                        full_offsets, table_ext
                                        ) -> tuple[torch.Tensor, LaneTrace]:
    """An index-map-projected bucket solve: each entity's warm start gathered
    through its column index from the ``[E, d+1]`` table, the solve in the
    projected space, the result scattered back and the scratch column
    re-zeroed; returns the table with the per-lane trace."""
    offsets = _bucket_offsets(sample_rows, full_offsets)
    solved, trace = _solve_bucket_entities(objective, opt, features, labels, weights, offsets,
                                           _gather_cells(table_ext, entity_rows, col_index))
    trace = _mask_padding_lanes(trace, entity_rows, table_ext.shape[0])
    table_ext = _scatter_cells(table_ext, entity_rows, col_index, solved)
    table_ext[:, -1] = 0.0
    return table_ext, trace


def solve_entity_bucket_indexmap(objective, opt, features, labels, weights, sample_rows,
                                 entity_rows, col_index, full_offsets, table_ext) -> torch.Tensor:
    return solve_entity_bucket_indexmap_traced(objective, opt, features, labels, weights,
                                               sample_rows, entity_rows, col_index,
                                               full_offsets, table_ext)[0]


@partial(ledger_call, label="coord/re_bucket_solve_random", static_argnums=(0, 1))
def solve_entity_bucket_random_traced(objective: GLMObjective, opt: OptimizerConfig, features,
                                      labels, weights, sample_rows, entity_rows, matrix,
                                      full_offsets, table) -> tuple[torch.Tensor, LaneTrace]:
    """A random-projected bucket solve: warm start Pᵀw (the adjoint, close to
    the projected coefficients since E[PᵀP] = I), back-projection P w_k."""
    offsets = _bucket_offsets(sample_rows, full_offsets)
    solved, trace = _solve_bucket_entities(objective, opt, features, labels, weights, offsets,
                                           _gather_rows(table, entity_rows) @ matrix)
    trace = _mask_padding_lanes(trace, entity_rows, table.shape[0])
    return _scatter_rows(table, entity_rows, solved @ matrix.T), trace


def solve_entity_bucket_random(objective, opt, features, labels, weights, sample_rows,
                               entity_rows, matrix, full_offsets, table) -> torch.Tensor:
    return solve_entity_bucket_random_traced(objective, opt, features, labels, weights,
                                             sample_rows, entity_rows, matrix, full_offsets,
                                             table)[0]


bucket_variances = _by_mode(
    ledger_call(_bucket_variances, label="coord/re_bucket_variances", static_argnums=(0,)),
    ledger_call(_bucket_variances, label="coord/re_bucket_variances_diagonal",
                static_argnums=(0,)))


def _bucket_variances_indexmap(objective: GLMObjective, bucket, full_offsets, table_ext, var_ext,
                               mode: str) -> torch.Tensor:
    """Per-entity variances in the projected space (H over the entity's
    active columns), scattered back through its column index into a copy of
    ``var_ext`` [E, d+1]; the scratch column holds pad slots' values."""
    offsets = _bucket_offsets(bucket.sample_rows, full_offsets)
    lanes = _lane_objective(objective, bucket.features, bucket.labels, bucket.weights, offsets)
    w = _gather_cells(table_ext, bucket.entity_rows, bucket.col_index)
    return _scatter_cells(var_ext, bucket.entity_rows, bucket.col_index,
                          _lane_variances(lanes, w, mode))


bucket_variances_indexmap = _by_mode(
    ledger_call(_bucket_variances_indexmap, label="coord/re_bucket_variances_indexmap",
                static_argnums=(0,)),
    ledger_call(_bucket_variances_indexmap, label="coord/re_bucket_variances_indexmap_diagonal",
                static_argnums=(0,)))


def _recover_sketch_coefficients(rows: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """The exact solve-space coefficients of back-projected table rows:
    rows hold w = P w_k, so w_k = (PᵀP)⁻¹ Pᵀ w, one shared [k, k] Gram solve.
    The adjoint Pᵀw is off w_k by about sqrt(k/d) relative, which would bias
    a coefficient-dependent Hessian (logistic, Poisson) evaluated there."""
    gram = matrix.T @ matrix
    return torch.linalg.solve(gram, (rows @ matrix).T).T


def _bucket_variances_random(objective: GLMObjective, bucket, full_offsets, matrix, table,
                             var_table, mode: str) -> torch.Tensor:
    """Original-space variances of a random-projected solve, w = P w_k:
    "full" propagates the covariance, var(w) = diag(P H_k⁻¹ Pᵀ); "diagonal"
    takes (P∘P) @ 1/diag(H_k). Written into a copy of ``var_table``."""
    offsets = _bucket_offsets(bucket.sample_rows, full_offsets)
    lanes = _lane_objective(objective, bucket.features, bucket.labels, bucket.weights, offsets)
    wks = _recover_sketch_coefficients(_gather_rows(table, bucket.entity_rows), matrix)
    if mode == "full":
        h_inv = full_inverse_from_hessian(lanes.hessian_matrix(wks))
        vs = torch.einsum("dk,lkj,dj->ld", matrix, h_inv, matrix)
    else:
        vs = inverse_of_diagonal(lanes.hessian_diagonal(wks)) @ (matrix * matrix).T
    return _scatter_rows(var_table, bucket.entity_rows, vs)


bucket_variances_random = _by_mode(
    ledger_call(_bucket_variances_random, label="coord/re_bucket_variances_random",
                static_argnums=(0,)),
    ledger_call(_bucket_variances_random, label="coord/re_bucket_variances_random_diagonal",
                static_argnums=(0,)))


def _lane_grad_norms(objective, bucket, full_offsets, w) -> torch.Tensor:
    lanes = _lane_objective(objective, bucket.features, bucket.labels, bucket.weights,
                            _bucket_offsets(bucket.sample_rows, full_offsets))
    return torch.linalg.norm(lanes.value_and_grad(w)[1], dim=-1)


@partial(ledger_call, label="refresh/grad_norms", static_argnums=(0,))
def bucket_grad_norms(objective, bucket, full_offsets, table) -> torch.Tensor:
    """[e] solve-space gradient norms of a bucket's lanes at their rows of
    ``table`` (the refresh's screening signal)."""
    return _lane_grad_norms(objective, bucket, full_offsets,
                            _gather_rows(table, bucket.entity_rows))


@partial(ledger_call, label="refresh/grad_norms_indexmap", static_argnums=(0,))
def bucket_grad_norms_indexmap(objective, bucket, full_offsets, table_ext) -> torch.Tensor:
    """:func:`bucket_grad_norms` of an INDEX_MAP bucket on the [E, d+1] table."""
    return _lane_grad_norms(objective, bucket, full_offsets,
                            _gather_cells(table_ext, bucket.entity_rows, bucket.col_index))


@partial(ledger_call, label="refresh/grad_norms_random", static_argnums=(0,))
def bucket_grad_norms_random(objective, bucket, full_offsets, matrix, table) -> torch.Tensor:
    """:func:`bucket_grad_norms` of a RANDOM bucket, at table[rows] @ P."""
    return _lane_grad_norms(objective, bucket, full_offsets,
                            _gather_rows(table, bucket.entity_rows) @ matrix)


def random_variance_mode(mode: str, d: int, k: int, num_problems: int) -> str:
    """"auto" for the random-projection variances: the full propagation
    holds a [d, k] product per entity of a bucket, num_problems·d·k values,
    so the budget covers that stack as well as the e·k² Hessians."""
    resolved = resolve_variance_mode(mode, k, num_problems=num_problems)
    if mode == "auto" and resolved == "full" \
            and num_problems * d * k > FULL_VARIANCE_MAX_DIM * FULL_VARIANCE_MAX_DIM:
        return "diagonal"
    return resolved


@dataclasses.dataclass
class RandomEffectCoordinate(Coordinate):
    """Per-entity solves over bucketed padded blocks, lane-batched."""

    coordinate_id: str
    dataset: GameDataset
    re_dataset: RandomEffectDataset
    task: TaskType
    config: CoordinateOptimizationConfig
    normalization: NormalizationContext | None = None
    intercept_index: int | None = None
    #: the probe/rescue lane scheduler (algorithm/lane_scheduler.py), made
    #: at the first scheduled update and kept across sweeps (its active set)
    _scheduler: object = dataclasses.field(default=None, init=False, repr=False)
    #: (iteration, num_iterations) from the coordinate-descent loop: the
    #: active set needs the final sweep, which runs everyone. None (a lone
    #: update_model call) counts as final: nothing is skipped.
    _sweep_context: tuple = dataclasses.field(default=None, init=False, repr=False)
    #: bool [num_entities] refresh selection (algorithm/refresh.py): when
    #: set, update_model re-solves only the selected entities' lanes and the
    #: other rows carry over bitwise
    _refresh_selection: object = dataclasses.field(default=None, init=False, repr=False)
    #: SchedulerStats of the last refresh-selected solve
    last_refresh_stats: object = dataclasses.field(default=None, init=False, repr=False)

    def set_sweep(self, iteration: int, num_iterations: int) -> None:
        """The coordinate-descent loop's sweep, set before each update."""
        self._sweep_context = (iteration, num_iterations)

    def set_refresh_selection(self, selected: "np.ndarray | None") -> None:
        """Install (or clear, with None) the refresh's entity selection for
        the next ``update_model``: the entity-granular counterpart of the
        reference's locked coordinates (CoordinateDescent.scala:44-49)."""
        if selected is None:
            self._refresh_selection = None
            return
        selected = np.ascontiguousarray(selected, dtype=bool)
        if selected.shape != (self.re_dataset.num_entities,):
            raise ValueError(
                f"refresh selection covers {selected.shape} but coordinate "
                f"'{self.coordinate_id}' has "
                f"{self.re_dataset.num_entities} entities")
        self._refresh_selection = selected

    def initial_model(self) -> RandomEffectModel:
        re = self.re_dataset
        dtype = solve_dtype_of(self.dataset.feature_shards[re.feature_shard_id].dtype)
        return RandomEffectModel(
            coefficients=torch.zeros((re.num_entities, re.table_width), dtype=dtype,
                                     device=self.dataset.device),
            entity_keys=self.dataset.entity_vocabs[re.random_effect_type],
            random_effect_type=re.random_effect_type,
            feature_shard_id=re.feature_shard_id,
            task=self.task,
            active_cols=re.active_cols,
            feature_dim=re.dim if re.is_compact else None,
        )

    def _prepare_solve(self, model: RandomEffectModel, extra_offsets: torch.Tensor | None):
        """Checks the projector/normalization composition and returns
        (objective, projector, full_offsets, norm, compact_cols, table in
        solve space); compact_cols is the [E, K] active-column table of a
        compact coordinate, else None."""
        re = self.re_dataset
        projector = re.projector_type
        if projector == ProjectorType.RANDOM and self.normalization is not None \
                and not re.pre_normalized:
            # normalization goes before the sketch, at dataset build: a
            # context cannot be folded through P afterwards
            raise ValueError(
                "RANDOM-projected coordinate with normalization: the "
                "RandomEffectDataset must be built with the same "
                "normalization (build_random_effect_dataset(normalization=...)) "
                "so features are normalized before sketching"
            )
        if re.is_compact and self.normalization is not None \
                and self.normalization.shifts is not None:
            raise ValueError(
                "compact (sparse-shard) random-effect coordinates support "
                "SCALE-only normalization; mean shifts (STANDARDIZATION) "
                "would densify the feature space"
            )
        if projector == ProjectorType.INDEX_MAP and self.normalization is not None \
                and not re.pre_normalized:
            raise ValueError(
                "INDEX_MAP coordinate with normalization: the "
                "RandomEffectDataset must be built with the same "
                "normalization (build_random_effect_dataset(normalization=...)) "
                "so entity blocks are pre-normalized"
            )
        if re.pre_normalized and self.normalization is None:
            raise ValueError(
                "this RandomEffectDataset was built pre-normalized but the "
                "coordinate has no normalization context — its solved "
                "tables would be emitted as model-space coefficients while "
                "actually living in normalized space"
            )
        # pre-normalized projected blocks already hold x' = (x - shift)·factor:
        # the solve runs plain; the table conversions keep the context
        projected = projector in (ProjectorType.INDEX_MAP, ProjectorType.RANDOM)
        objective = GLMObjective(loss_for_task(self.task), l2_weight=self.config.l2_weight,
                                 normalization=None if projected else self.normalization,
                                 use_kernel=False)
        full_offsets = self.dataset.offsets
        if extra_offsets is not None:
            full_offsets = full_offsets + extra_offsets
        norm = self.normalization if self.normalization is not None else no_normalization()
        compact_cols = None
        if re.is_compact:
            # compact tables convert per entity through gathered factors
            compact_cols = re.active_cols_on(model.coefficients.device)
            table = norm.from_model_space_compact(model.coefficients, compact_cols)
        else:
            table = norm.from_model_space(model.coefficients, self.intercept_index)
        return objective, projector, full_offsets, norm, compact_cols, table

    def _projection_matrix(self, table: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.re_dataset.projection.matrix, dtype=table.dtype,
                               device=table.device)

    def update_model(self, model: RandomEffectModel, extra_offsets: torch.Tensor | None = None):
        objective, projector, full_offsets, norm, compact_cols, table = self._prepare_solve(
            model, extra_offsets)
        opt = _solve_config(self.config, loss=objective.loss, small_dense=True)
        buckets = self.re_dataset.buckets
        traces: list[LaneTrace] = []
        refresh_sel = self._refresh_selection
        if refresh_sel is not None:
            table, traces = self._solve_refresh(objective, opt, projector, full_offsets, table,
                                                refresh_sel)
        elif opt.scheduler is not None:
            table, traces = self._solve_scheduled(objective, opt, projector, full_offsets, table)
        elif projector == ProjectorType.INDEX_MAP:
            table_ext = _with_scratch_column(table)
            for b in buckets:
                table_ext, trace = solve_entity_bucket_indexmap_traced(
                    objective, opt, b.features, b.labels, b.weights, b.sample_rows,
                    b.entity_rows, b.col_index, full_offsets, table_ext)
                traces.append(trace)
            table = table_ext[:, :-1]
        elif projector == ProjectorType.RANDOM:
            matrix = self._projection_matrix(table)
            for b in buckets:
                table, trace = solve_entity_bucket_random_traced(
                    objective, opt, b.features, b.labels, b.weights, b.sample_rows,
                    b.entity_rows, matrix, full_offsets, table)
                traces.append(trace)
        else:
            for b in buckets:
                table, trace = solve_entity_bucket_traced(
                    objective, opt, b.features, b.labels, b.weights, b.sample_rows,
                    b.entity_rows, full_offsets, table)
                traces.append(trace)
        variances = None
        if self.config.compute_variance:
            var_table = self._variances(objective, projector, full_offsets, table)
            variances = (norm.variances_to_model_space(var_table) if compact_cols is None
                         else norm.variances_to_model_space_compact(var_table, compact_cols))
        table = (norm.to_model_space(table, self.intercept_index) if compact_cols is None
                 else norm.to_model_space_compact(table, compact_cols))
        if refresh_sel is not None:
            # unselected entities carry over bitwise: the compacted solve never
            # wrote their rows, and this erases the normalization round trip;
            # their variances carry over too, the selected ones' are fresh (or
            # NaN when this refresh computed none)
            sel = torch.as_tensor(refresh_sel, device=table.device).unsqueeze(1)
            table = torch.where(sel, table, model.coefficients.to(table.dtype))
            if variances is not None or model.variances is not None:
                nans = torch.full_like(table, float("nan"))
                variances = torch.where(
                    sel, nans if variances is None else variances.to(table.dtype),
                    nans if model.variances is None else model.variances.to(table.dtype))
        info = LaneTraces(traces) if traces else None
        return dataclasses.replace(model, coefficients=table, variances=variances), info

    def _scheduler_blocks(self, projector) -> list[dict]:
        """Bucket field dicts in the form the lane scheduler takes."""
        return [{"features": b.features, "labels": b.labels, "weights": b.weights,
                 "sample_rows": b.sample_rows, "entity_rows": b.entity_rows,
                 **({"col_index": b.col_index} if projector == ProjectorType.INDEX_MAP else {})}
                for b in self.re_dataset.buckets]

    def _matrix_for(self, projector, table: torch.Tensor):
        return self._projection_matrix(table) if projector == ProjectorType.RANDOM else None

    def _solve_scheduled(self, objective, opt, projector, full_offsets, table):
        """Probe/rescue (and cross-sweep active-set) solve of every bucket
        (algorithm/lane_scheduler.py); returns (table, host traces)."""
        from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler

        if self._scheduler is None or self._scheduler.config != opt.scheduler:
            self._scheduler = LaneScheduler(opt.scheduler)
        iteration, num_iterations = self._sweep_context or (0, 1)
        table, traces, _stats = self._scheduler.solve(
            objective, opt, self._scheduler_blocks(projector), full_offsets, table,
            projector=projector, matrix=self._matrix_for(projector, table),
            final_sweep=iteration >= num_iterations - 1)
        return table, traces

    def _solve_refresh(self, objective, opt, projector, full_offsets, table,
                       selected: np.ndarray):
        """The refresh's solve (algorithm/refresh.py): the scheduler's active
        set chosen from outside. Only the selected entities' lanes are
        compacted and solved, with the whole iteration budget (the probe is
        the whole solve), warm-started from the incoming table; the other
        rows are never written. A fresh scheduler each call."""
        from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler
        from photon_ml_torch.optim.optimizer import LaneSchedulerConfig

        base = dataclasses.replace(opt, scheduler=None)
        scheduler = LaneScheduler(LaneSchedulerConfig(probe_iterations=base.max_iterations),
                                  warn_no_live_stop=False)
        scheduler.freeze_rows(~selected)
        table, traces, stats = scheduler.solve(
            objective, base, self._scheduler_blocks(projector), full_offsets, table,
            projector=projector, matrix=self._matrix_for(projector, table), final_sweep=False)
        self.last_refresh_stats = stats
        return table, traces

    def refresh_gradient_norms(self, model: RandomEffectModel,
                               extra_offsets: torch.Tensor | None = None) -> np.ndarray:
        """[num_entities] solve-space gradient norms of ``model`` at its own
        coefficients, the refresh's screening signal: an entity whose data
        changed since the resident solve has a gradient well above rounding
        scale. One lane-batched gradient per bucket; entities in no bucket
        give NaN."""
        objective, projector, full_offsets, _norm, _cols, table = self._prepare_solve(
            model, extra_offsets)
        num_rows = int(table.shape[0])
        out = np.full(num_rows, np.nan)
        matrix = self._matrix_for(projector, table)
        if projector == ProjectorType.INDEX_MAP:
            table_ext = _with_scratch_column(table)
        for b in self.re_dataset.buckets:
            if projector == ProjectorType.INDEX_MAP:
                norms = bucket_grad_norms_indexmap(objective, b, full_offsets, table_ext)
            elif projector == ProjectorType.RANDOM:
                norms = bucket_grad_norms_random(objective, b, full_offsets, matrix, table)
            else:
                norms = bucket_grad_norms(objective, b, full_offsets, table)
            rows = b.entity_rows.cpu().numpy().astype(np.int64)
            valid = (rows >= 0) & (rows < num_rows)
            out[rows[valid]] = norms.cpu().numpy()[valid]
        return out

    def _variances(self, objective, projector, full_offsets, table) -> torch.Tensor:
        """Solve-space variances at the solved table, NaN where none was
        computed: entities in no bucket, and an INDEX_MAP entity's columns
        off its support. "auto" budgets for the largest bucket's stack."""
        buckets, mode = self.re_dataset.buckets, self.config.variance_mode
        max_bucket = max((b.num_entities for b in buckets), default=1)
        var_table = torch.full_like(table, float("nan"))
        if projector == ProjectorType.RANDOM:
            matrix = self._projection_matrix(table)
            resolved = random_variance_mode(mode, self.re_dataset.dim, matrix.shape[1],
                                            max_bucket)
            for b in buckets:
                var_table = bucket_variances_random(objective, b, full_offsets, matrix, table,
                                                    var_table, resolved)
            return var_table
        if projector == ProjectorType.INDEX_MAP:
            width = max((b.features.shape[2] for b in buckets), default=1)
            resolved = resolve_variance_mode(mode, width, num_problems=max_bucket)
            table_ext, var_ext = _with_scratch_column(table), _with_scratch_column(var_table)
            for b in buckets:
                var_ext = bucket_variances_indexmap(objective, b, full_offsets, table_ext,
                                                    var_ext, resolved)
            return var_ext[:, :-1]
        resolved = resolve_variance_mode(mode, self.re_dataset.dim, num_problems=max_bucket)
        for b in buckets:
            var_table = bucket_variances(objective, b, full_offsets, table, var_table, resolved)
        return var_table

    def score(self, model: RandomEffectModel) -> torch.Tensor:
        return model.score_dataset(self.dataset)


def lane_iteration_histogram(info: LaneTraces | None) -> dict[int, int]:
    """Valid lanes by iteration count over every bucket of one update."""
    if info is None:
        return {}
    its = np.concatenate([t.iterations[t.valid].cpu().numpy() for t in info.buckets])
    values, counts = np.unique(its, return_counts=True)
    return {int(v): int(c) for v, c in zip(values, counts)}


@dataclasses.dataclass
class ModelCoordinate(Coordinate):
    """A locked coordinate: contributes scores, never retrains (reference
    FixedEffectModelCoordinate / RandomEffectModelCoordinate, used by partial
    retraining, CoordinateDescent.scala:44-49)."""

    coordinate_id: str
    dataset: GameDataset
    model: DatumScoringModel

    def initial_model(self) -> DatumScoringModel:
        return self.model

    def update_model(self, model: DatumScoringModel, extra_offsets: torch.Tensor | None = None):
        return model, None

    def score(self, model: DatumScoringModel) -> torch.Tensor:
        return model.score_dataset(self.dataset)
