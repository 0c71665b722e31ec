"""Configuration-tournament lanes: one lane-batched solve, many
hyperparameter configurations.

Counterpart of ``photon_ml_tpu/algorithm/lane_search.py``. The reference
evaluates hyperparameter candidates as a sequential loop of full driver fits
(photon-client hyperparameter glue around RandomSearch.scala:33-50); here
every lane of one solve is one configuration, with per-lane vectors of L2
weight, L1 weight, solver tolerance, warm start and, optionally, box bounds,
through the lane solvers of ``optim/lanes.py`` and ``optim/owlqn.py``.
Whether the lanes are OWL-QN or L-BFGS, and whether they are boxed, is
decided once per tournament.

The lane objective (:func:`lane_value_and_grad`) evaluates every lane at
once. On a dense batch the margins of all lanes are one product
``X @ Wᵀ`` and the gradients one ``Rᵀ X``, with the normalization applied
implicitly as ``ops/objective.py`` does (the JAX package computes this
product outside any kernel too). On a sparse batch each lane runs the
objective's own evaluation in lane order: on the card G1's row kernel for
the margins and its segment kernel for the transpose.

Invariants:

- A uniform tournament (per-lane L2/L1 from one elastic-net α, the
  optimizer's tolerance in every lane, no box, zero warm starts) is bitwise
  ``estimators.train_glm_grid``: both run :func:`solve_lanes`, and a uniform
  per-lane tolerance gives the bits of the scalar.
- A tournament with no box lane passes ``bounds=None``: ±inf bounds select
  the projected path, which is not bitwise the unprojected one.
- Evaluation stays on the device: per-lane validation margins and the
  metric of ``evaluation/sharded.py``; only the [L] metric values reach the
  host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.objective import chain_rule
from photon_ml_torch.optim.common import LaneResult
from photon_ml_torch.optim.lanes import minimize_lbfgs_lanes
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType, resolve_auto_optimizer
from photon_ml_torch.optim.owlqn import minimize_owlqn_lanes
from photon_ml_torch.types import TaskType

#: evaluations of a lane objective (each evaluates every lane): read by
#: ``chip_smoke.py`` beside the sparse kernels' launches
lane_evaluations = 0


@dataclasses.dataclass(frozen=True)
class LaneConfigs:
    """Per-lane hyperparameter vectors for one tournament round.

    l2 / l1 / tolerance: [L] float arrays (one lane per configuration).
    lower_bounds / upper_bounds: optional [L, d] per-lane box; lanes without
    a box carry ±inf rows. Leave both None when no lane uses a box (the
    unprojected L-BFGS path).
    """

    l2: np.ndarray
    l1: np.ndarray
    tolerance: np.ndarray
    lower_bounds: np.ndarray | None = None
    upper_bounds: np.ndarray | None = None

    def __post_init__(self):
        l2 = np.asarray(self.l2, np.float64)
        l1 = np.asarray(self.l1, np.float64)
        tol = np.asarray(self.tolerance, np.float64)
        if not (l2.shape == l1.shape == tol.shape and l2.ndim == 1):
            raise ValueError(
                "LaneConfigs needs matching [L] vectors, got "
                f"l2{l2.shape} l1{l1.shape} tolerance{tol.shape}")
        if (self.lower_bounds is None) != (self.upper_bounds is None):
            raise ValueError(
                "per-lane boxes need BOTH lower_bounds and upper_bounds "
                "([L, d]; ±inf rows for box-off lanes)")

    @property
    def num_lanes(self) -> int:
        return int(np.asarray(self.l2).shape[0])

    @property
    def has_box(self) -> bool:
        return self.lower_bounds is not None

    def needs_owlqn(self) -> bool:
        return bool(np.any(np.asarray(self.l1) > 0.0))


@dataclasses.dataclass
class TournamentResult:
    """One tournament: the per-lane solver results and model-space models."""

    #: LaneResult: every field has a leading [L] lane axis
    results: LaneResult
    #: model-space GLMs, lane order
    models: list[GeneralizedLinearModel]
    #: the configurations that trained them
    configs: LaneConfigs


def lane_value_and_grad(objective, batch, l2v: torch.Tensor):
    """([L, d] coefficients -> ([L] values, [L, d] gradients)) of the
    smooth objective plus each lane's L2 term. ``objective`` carries no L2
    weight of its own."""

    def dense(w):
        norm = objective.normalization
        eff = norm.effective_coefficients(w)
        x = batch.features
        if x.dtype == torch.bfloat16:
            # bf16-rounded coefficients, f32 accumulation (ops/objective.py)
            margins = x.to(w.dtype) @ eff.to(torch.bfloat16).to(w.dtype).T
        else:
            margins = x @ eff.T
        if norm.shifts is not None:
            margins = margins - (eff @ norm.shifts).unsqueeze(0)
        margins = margins + batch.offsets.unsqueeze(1)
        loss, dz = objective.loss.loss_and_dz(margins, batch.labels.unsqueeze(1))
        weights = batch.weights.unsqueeze(1)
        r = weights * dz
        value = torch.sum(weights * loss, dim=0)
        grad = chain_rule(norm, r.T @ x.to(r.dtype), torch.sum(r, dim=0).unsqueeze(1))
        return value, grad

    def sparse(w):
        parts = [objective.value_and_gradient(w[i], batch) for i in range(w.shape[0])]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])

    data = sparse if isinstance(batch, SparseLabeledPointBatch) else dense

    def value_and_grad(w):
        global lane_evaluations
        lane_evaluations += 1
        value, grad = data(w)
        return (value + 0.5 * l2v * torch.sum(w * w, dim=-1),
                grad + l2v.unsqueeze(1) * w)

    return value_and_grad


def solve_lanes(objective, use_owlqn: bool, optimizer: OptimizerConfig, batch, l2v, l1v,
                tolerance, w0v, bounds=None) -> LaneResult:
    """Every lane's solve at once: the grid's and the tournament's one
    program. ``tolerance`` is the optimizer's scalar or a [L] tensor;
    ``bounds`` None or (lower, upper), each [d] or [L, d]."""
    vg = lane_value_and_grad(objective, batch, l2v)
    common = dict(max_iter=optimizer.max_iterations, history=optimizer.history,
                  tolerance=tolerance, rel_function_tolerance=optimizer.rel_function_tolerance)
    if use_owlqn:
        return minimize_owlqn_lanes(vg, w0v, l1_weight=l1v, **common)
    return minimize_lbfgs_lanes(vg, w0v, lower_bounds=None if bounds is None else bounds[0],
                                upper_bounds=None if bounds is None else bounds[1], **common)


def run_lane_tournament(batch: LabeledPointBatch, task: TaskType, configs: LaneConfigs, *,
                        optimizer: OptimizerConfig | None = None, warm_start=None,
                        normalization=None, intercept_index: int | None = None,
                        telemetry=None) -> TournamentResult:
    """Train every lane of ``configs`` in one lane-batched solve.

    ``warm_start``: optional [L, d] per-lane initial coefficients in
    normalized (solver) space; None starts every lane at zero, the
    ``train_glm_grid`` path. AUTO resolves once for the whole tournament;
    only L-BFGS and OWL-QN lanes run. ``telemetry``: a
    ``telemetry.SolverTelemetry`` that gets the lanes' convergence rows,
    keyed by their L2 and L1 weights.
    """
    from photon_ml_torch.estimators import _objective_for_batch

    optimizer = resolve_auto_optimizer(optimizer or OptimizerConfig())
    if optimizer.optimizer_type not in (OptimizerType.LBFGS, OptimizerType.OWLQN):
        raise ValueError(
            "lane tournaments support LBFGS/OWLQN lanes; got "
            f"{optimizer.optimizer_type.name}")
    use_owlqn = configs.needs_owlqn() or optimizer.optimizer_type == OptimizerType.OWLQN
    if use_owlqn and configs.has_box:
        raise ValueError("box constraints cannot combine with OWL-QN / L1 lanes")
    objective = _objective_for_batch(batch, loss_for_task(task), 0.0, normalization)
    dtype, device = batch.solve_dtype, batch.device
    num_lanes = configs.num_lanes

    def lanes(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if warm_start is None:
        w0v = torch.zeros((num_lanes, batch.dim), dtype=dtype, device=device)
    else:
        w0v = torch.as_tensor(warm_start, dtype=dtype, device=device)
        if tuple(w0v.shape) != (num_lanes, batch.dim):
            raise ValueError(
                f"warm_start must be [{num_lanes}, {batch.dim}], got {tuple(w0v.shape)}")
    bounds = ((lanes(configs.lower_bounds), lanes(configs.upper_bounds))
              if configs.has_box else None)
    results = solve_lanes(objective, use_owlqn, optimizer, batch, lanes(configs.l2),
                          lanes(configs.l1), lanes(configs.tolerance), w0v, bounds)
    if telemetry is not None:
        l2, l1 = np.asarray(configs.l2), np.asarray(configs.l1)
        telemetry.record_lanes("lane-search", results,
                               keys=[{"l2": float(l2[i]), "l1": float(l1[i])}
                                     for i in range(num_lanes)])
    norm = objective.normalization
    models = [GeneralizedLinearModel(Coefficients(
        means=norm.to_model_space(results.coefficients[i], intercept_index)), task)
        for i in range(num_lanes)]
    return TournamentResult(results=results, models=models, configs=configs)


def evaluate_tournament_on_device(objective, metric_fn, val_batch: LabeledPointBatch,
                                  coefficients: torch.Tensor, consts: dict,
                                  intercept_index: int | None = None) -> torch.Tensor:
    """[L] metric values of a tournament's coefficient stack (solver space)
    on the device: each lane mapped to model space, its margins over the
    validation batch, the metric of a prepared
    ``evaluation.sharded.DeviceEvaluator`` (``metric_fn``, ``consts``).
    Returns the device tensor; reading it is the one host sync."""
    if isinstance(val_batch, SparseLabeledPointBatch):
        raise TypeError(
            "tournament evaluation needs a dense validation batch "
            "(per-lane margins are one [n, d] @ [d] per lane)")
    norm = objective.normalization
    out = []
    for w in coefficients:
        wm = norm.to_model_space(w, intercept_index)
        scores = val_batch.features.to(wm.dtype) @ wm + val_batch.offsets
        out.append(metric_fn(scores, consts))
    return torch.stack(out)
