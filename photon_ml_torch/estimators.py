"""The training facades: ``GameEstimator`` and single-GLM ``train_glm``.

Counterpart of ``photon_ml_tpu/estimators.py``. ``GameEstimator.fit``
(reference photon-api estimators/GameEstimator.scala) builds the
per-coordinate datasets, the training-loss and validation evaluators and the
per-shard normalization, then runs block coordinate descent; in the port it
runs on one device, over a dense or sparse fixed effect, random effects
on dense shards (IDENTITY, INDEX_MAP or RANDOM projection, optional
per-entity Pearson feature selection) or on sparse shards (compact ``[E, K]``
tables over each entity's active columns), and matrix-factorization
coordinates (``algorithm/mf_coordinate.py``). ``train_glm`` (reference ModelTraining.scala:55-228)
is the single-GLM regularization path with warm starts, for dense and sparse
batches alike.
"""

from __future__ import annotations

import dataclasses
import logging
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
from photon_ml_torch.data.game_data import GameDataset, build_random_effect_dataset
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, SparseShard
from photon_ml_torch.evaluation.evaluators import (
    EvaluationData,
    default_evaluator_for_task,
    parse_evaluator,
)
from photon_ml_torch.models.game import GameModel
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


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md item {item}")


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
    checkpointer: object | None = None
    #: raise DivergenceError on non-finite coordinate updates
    check_finite: bool = True
    mesh: object | None = None
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

    def fit(self, dataset: GameDataset, validation_dataset: GameDataset | None = None,
            initial_model: GameModel | None = None) -> CoordinateDescentResult:
        if self.mesh is not None:
            raise _not_ported("the mesh path (_fit_distributed, GameTrainProgram)", 10)
        if self.checkpointer is not None:
            raise _not_ported("checkpoints in run_coordinate_descent", 16)
        if self.telemetry is not None:
            raise _not_ported("solver telemetry", 19)
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
            check_finite=self.check_finite,
            on_update=self.on_update,
        )

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
                if cfg.optimization.optimizer.scheduler is not None:
                    raise _not_ported(f"random effect '{cid}': the lane scheduler", 18)
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
