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

In this slice a random effect is an IDENTITY projection on a dense shard,
solved by L-BFGS or Newton lanes.
"""

from __future__ import annotations

import dataclasses

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
    coefficient_variances,
    diag_inverse_from_hessian,
    inverse_of_diagonal,
    resolve_variance_mode,
    resolve_variance_mode_for,
    validate_variance_mode,
)
from photon_ml_torch.optim.common import LaneTrace, LaneTraces, lane_trace_of
from photon_ml_torch.optim.lanes import minimize_lbfgs_lanes
from photon_ml_torch.optim.newton import minimize_newton
from photon_ml_torch.optim.optimizer import (
    OptimizerConfig,
    OptimizerType,
    resolve_auto_optimizer,
    solve,
)
from photon_ml_torch.sampling.down_sampler import down_sampler_for_task
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
        bound = objective.bind(batch) if sparse else objective.bind_packed(batch)
        result = solve(_solve_config(self.config, loss=objective.loss), bound, w0)
        means = norm.to_model_space(result.coefficients, self.intercept_index)
        variances = None
        if self.config.compute_variance:
            variances = norm.variances_to_model_space(coefficient_variances(
                objective, result.coefficients, batch, mode=self.config.variance_mode))
        glm = GeneralizedLinearModel(Coefficients(means=means, variances=variances), self.task)
        return FixedEffectModel(glm=glm, feature_shard_id=self.feature_shard_id), result

    def score(self, model: FixedEffectModel) -> torch.Tensor:
        return model.score_dataset(self.dataset)


def _bucket_offsets(sample_rows: torch.Tensor, full_offsets: torch.Tensor) -> torch.Tensor:
    rows = sample_rows.long()
    gathered = full_offsets[torch.clamp(rows, min=0)]
    return torch.where(rows >= 0, gathered, torch.zeros_like(gathered))


def _lane_objective(objective: GLMObjective, features, labels, weights, offsets):
    return LaneObjective(objective.loss, features, labels, offsets, weights,
                         l2_weight=objective.l2_weight, normalization=objective.normalization)


def _solve_bucket_entities(objective: GLMObjective, opt: OptimizerConfig, features, labels,
                           weights, offsets, w0s) -> tuple[torch.Tensor, LaneTrace]:
    """Lane-batched per-entity solves: ([e, k] solved coefficients, [e] trace)."""
    lanes = _lane_objective(objective, features, labels, weights, offsets)
    t = opt.optimizer_type
    if t == OptimizerType.AUTO:
        raise ValueError("OptimizerType.AUTO must be resolved before the bucket solve")
    if t == OptimizerType.LBFGS:
        result = minimize_lbfgs_lanes(
            lanes.value_and_grad, w0s, max_iter=opt.max_iterations, history=opt.history,
            tolerance=opt.tolerance, rel_function_tolerance=opt.rel_function_tolerance)
    elif t == OptimizerType.NEWTON:
        if not objective.loss.twice_differentiable:
            raise ValueError(
                f"NEWTON requires a twice-differentiable loss, got "
                f"{type(objective.loss).__name__} (same restriction as TRON)")
        result = minimize_newton(
            lanes.value_and_grad, lanes.hessian_matrix, w0s, value_fn=lanes.value,
            max_iter=opt.max_iterations, tolerance=opt.tolerance,
            rel_function_tolerance=opt.rel_function_tolerance)
    else:
        raise NotImplementedError(
            f"{t.name} lanes (a random effect with L1, box constraints or a trust region) "
            "are not ported yet: ROADMAP.md item 12; use LBFGS or NEWTON")
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


def bucket_variances(objective: GLMObjective, bucket, full_offsets, table, var_table,
                     mode: str) -> torch.Tensor:
    """Per-entity variances at the solved coefficients written into a copy of
    ``var_table``: diag(H⁻¹) by one batched Cholesky ("full"), or 1/diag(H)."""
    offsets = _bucket_offsets(bucket.sample_rows, full_offsets)
    lanes = _lane_objective(objective, bucket.features, bucket.labels, bucket.weights, offsets)
    w = _gather_rows(table, bucket.entity_rows)
    if mode == "full":
        vs = diag_inverse_from_hessian(lanes.hessian_matrix(w))
    else:
        vs = inverse_of_diagonal(lanes.hessian_diagonal(w))
    return _scatter_rows(var_table, bucket.entity_rows, vs)


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
        )

    def _prepare_solve(self, model: RandomEffectModel, extra_offsets: torch.Tensor | None):
        """(objective, full_offsets, norm, table in solve space)."""
        objective = GLMObjective(loss_for_task(self.task), l2_weight=self.config.l2_weight,
                                 normalization=self.normalization, use_kernel=False)
        full_offsets = self.dataset.offsets
        if extra_offsets is not None:
            full_offsets = full_offsets + extra_offsets
        norm = self.normalization if self.normalization is not None else no_normalization()
        table = norm.from_model_space(model.coefficients, self.intercept_index)
        return objective, full_offsets, norm, table

    def update_model(self, model: RandomEffectModel, extra_offsets: torch.Tensor | None = None):
        objective, full_offsets, norm, table = self._prepare_solve(model, extra_offsets)
        opt = _solve_config(self.config, loss=objective.loss, small_dense=True)
        if opt.scheduler is not None:
            raise NotImplementedError(
                "the lane scheduler (probe/rescue, cross-sweep freezing) is not ported yet: "
                "ROADMAP.md item 18; drop OptimizerConfig.scheduler")
        traces: list[LaneTrace] = []
        for bucket in self.re_dataset.buckets:
            table, trace = solve_entity_bucket_traced(
                objective, opt, bucket.features, bucket.labels, bucket.weights,
                bucket.sample_rows, bucket.entity_rows, full_offsets, table)
            traces.append(trace)
        variances = None
        if self.config.compute_variance:
            # entities in no bucket keep NaN: no variance computed
            max_bucket = max((b.num_entities for b in self.re_dataset.buckets), default=1)
            mode = resolve_variance_mode(self.config.variance_mode, self.re_dataset.dim,
                                         num_problems=max_bucket)
            var_table = torch.full_like(table, float("nan"))
            for bucket in self.re_dataset.buckets:
                var_table = bucket_variances(objective, bucket, full_offsets, table, var_table,
                                             mode)
            variances = norm.variances_to_model_space(var_table)
        table = norm.to_model_space(table, self.intercept_index)
        info = LaneTraces(traces) if traces else None
        return dataclasses.replace(model, coefficients=table, variances=variances), info

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
