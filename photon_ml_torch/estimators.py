"""Single-GLM training: the regularization path with warm starts.

Counterpart of ``train_glm`` and ``_objective_for_batch`` in
``photon_ml_tpu/estimators.py``: dense and sparse batches train through
the same path; reference photon-api
ModelTraining.scala:55-228 (trainGeneralizedLinearModel, a foldLeft over
sorted λs warm-starting each solve from the previous one).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Sequence

import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.normalization import NormalizationContext
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
from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)


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
