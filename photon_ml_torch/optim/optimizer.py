"""Optimizer facade: config objects + dispatch to the solvers.

Counterpart of ``photon_ml_tpu/optim/optimizer.py``; reference photon-lib
optimization/Optimizer.scala, OptimizerFactory.scala and OptimizerConfig /
GLMOptimizationConfiguration. An optimizer is a frozen config whose
``solve`` runs one solve.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from photon_ml_torch.ops.objective import BoundObjective
from photon_ml_torch.optim.common import LOCAL, SolverResult, new_history
from photon_ml_torch.optim.lbfgs import minimize_lbfgs
from photon_ml_torch.optim.newton import minimize_newton
from photon_ml_torch.optim.owlqn import minimize_owlqn
from photon_ml_torch.optim.tron import minimize_tron


class OptimizerType(enum.Enum):
    """Reference: photon-lib optimization/OptimizerType.scala, plus the JAX
    package's NEWTON (small-d batched solves) and AUTO."""

    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"
    NEWTON = "NEWTON"
    AUTO = "AUTO"


@dataclasses.dataclass(frozen=True)
class LaneSchedulerConfig:
    """Converged-lane scheduling for batched random-effect solves
    (``algorithm/lane_scheduler.py``).

    probe_iterations: every lane solves this many iterations before the
        lanes still at MAX_ITERATIONS are re-run with the remaining budget.
    freeze_coefficient_tolerance / freeze_gradient_tolerance: when both are
        > 0, entities below both after a sweep are frozen for later sweeps.
    """

    probe_iterations: int = 2
    freeze_coefficient_tolerance: float = 0.0
    freeze_gradient_tolerance: float = 0.0

    @property
    def freezes(self) -> bool:
        return (
            self.freeze_coefficient_tolerance > 0.0
            and self.freeze_gradient_tolerance > 0.0
        )


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Static solver configuration (reference OptimizerConfig.scala).

    ``rel_function_tolerance`` (None = reference behavior): a separate
    function-decrease stop threshold (optim/common.check_convergence).
    ``scheduler``: probe/rescue lane scheduling of a random effect's batched
    solves (``algorithm/lane_scheduler.py``); ``solve`` ignores it.
    """

    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    history: int = 10  # L-BFGS memory m
    max_cg_iterations: int = 20  # TRON inner loop cap
    l1_weight: float = 0.0  # OWLQN only; set by the elastic-net path
    rel_function_tolerance: float | None = None
    scheduler: LaneSchedulerConfig | None = None

    def with_l1(self, l1_weight: float) -> "OptimizerConfig":
        return dataclasses.replace(self, l1_weight=l1_weight)


def solve(
    config: OptimizerConfig,
    objective: BoundObjective,
    w0: torch.Tensor,
    *,
    lower_bounds: torch.Tensor | None = None,
    upper_bounds: torch.Tensor | None = None,
    state_observer=None,
    resume_state=None,
) -> SolverResult:
    """Run the configured solver on a bound objective. The solver's inner
    products and norms are the objective's ``vector_ops`` (a model-sharded
    vector's, ``parallel/column_sharded.py``), plain ones by default.

    ``state_observer`` / ``resume_state`` (L-BFGS, LBFGSB, OWL-QN, TRON):
    the solver-state checkpoint hooks (``io/checkpoint.SolverCheckpointer``):
    the observer sees the solver's state after every outer iteration, and
    ``resume_state`` re-enters from a restored one. The state's class is
    :func:`solver_state_class`."""
    t = config.optimizer_type
    ops = getattr(objective.objective, "vector_ops", LOCAL)
    if t == OptimizerType.AUTO:
        raise ValueError(
            "OptimizerType.AUTO must be resolved before solve() — call "
            "resolve_auto_optimizer(config, loss=..., small_dense=...) at "
            "the coordinate layer"
        )
    if (lower_bounds is not None or upper_bounds is not None) and t not in (
        OptimizerType.LBFGS, OptimizerType.LBFGSB
    ):
        raise ValueError(
            f"box constraints are only supported by the LBFGS family, not "
            f"{t.name} (the reference projects in LBFGS, LBFGS.scala:70-76)"
        )
    if (state_observer is not None or resume_state is not None) and t == OptimizerType.NEWTON:
        raise ValueError(
            "state_observer/resume_state cover the LBFGS/OWLQN/TRON solvers only "
            "(streaming solver checkpointing)")
    hooks = dict(state_observer=state_observer, resume_state=resume_state)
    if t == OptimizerType.NEWTON:
        return _solve_newton(config, objective, w0)
    if t in (OptimizerType.LBFGS, OptimizerType.LBFGSB):
        if t == OptimizerType.LBFGSB and lower_bounds is None and upper_bounds is None:
            raise ValueError("LBFGSB requires box constraints")
        return minimize_lbfgs(
            objective.value_and_grad,
            w0,
            max_iter=config.max_iterations,
            history=config.history,
            tolerance=config.tolerance,
            rel_function_tolerance=config.rel_function_tolerance,
            lower_bounds=lower_bounds,
            upper_bounds=upper_bounds,
            ops=ops,
            **hooks,
        )
    if t == OptimizerType.OWLQN:
        return minimize_owlqn(
            objective.value_and_grad,
            w0,
            l1_weight=config.l1_weight,
            max_iter=config.max_iterations,
            history=config.history,
            tolerance=config.tolerance,
            rel_function_tolerance=config.rel_function_tolerance,
            ops=ops,
            **hooks,
        )
    if t == OptimizerType.TRON:
        loss = objective.objective.loss
        if not loss.twice_differentiable:
            raise ValueError(
                f"TRON requires a twice-differentiable loss, got {type(loss).__name__}"
                " (reference restricts smoothed-hinge to the LBFGS family)"
            )
        return minimize_tron(
            objective.value_and_grad,
            objective.hessian_vector,
            w0,
            max_iter=config.max_iterations,
            tolerance=config.tolerance,
            rel_function_tolerance=config.rel_function_tolerance,
            max_cg_iter=config.max_cg_iterations,
            ops=ops,
            **hooks,
        )
    raise ValueError(f"Unknown optimizer type {t}")


def _solve_newton(config: OptimizerConfig, objective: BoundObjective,
                  w0: torch.Tensor) -> SolverResult:
    """One dense problem through the lane-batched Newton solver as a single
    lane (``optim/newton.py``); the histories hold the end points only."""
    loss = objective.objective.loss
    if not loss.twice_differentiable:
        raise ValueError(
            f"NEWTON requires a twice-differentiable loss, got {type(loss).__name__} "
            "(same restriction as TRON)")
    if not hasattr(objective.objective, "hessian_matrix"):
        raise ValueError(
            f"NEWTON needs an explicit [d, d] Hessian; {type(objective.objective).__name__} "
            "does not expose one (NEWTON is meant for small-d dense solves)")

    def value_and_grad(w):
        f, g = objective.value_and_grad(w[0])
        return f.reshape(1), g.unsqueeze(0)

    def value(candidates):  # [1, a, d] -> [1, a]
        return torch.stack([objective.value(c) for c in candidates[0]]).unsqueeze(0)

    start_f, start_g = objective.value_and_grad(w0)
    lanes = minimize_newton(
        value_and_grad, lambda w: objective.hessian_matrix(w[0]).unsqueeze(0), w0.unsqueeze(0),
        value_fn=value, max_iter=config.max_iterations, tolerance=config.tolerance,
        rel_function_tolerance=config.rel_function_tolerance)
    iterations = int(lanes.iterations[0])
    value_history = new_history(config.max_iterations, start_f)
    grad_norm_history = new_history(config.max_iterations, torch.linalg.norm(start_g))
    value_history[iterations] = lanes.value[0]
    grad_norm_history[iterations] = lanes.gradient_norm[0]
    return SolverResult(coefficients=lanes.coefficients[0], value=lanes.value[0],
                        gradient_norm=lanes.gradient_norm[0], iterations=iterations,
                        reason=int(lanes.reason[0]), value_history=value_history,
                        grad_norm_history=grad_norm_history)


def resolve_auto_optimizer(
    config: OptimizerConfig,
    *,
    loss=None,
    small_dense: bool = False,
) -> OptimizerConfig:
    """Resolve ``OptimizerType.AUTO`` into a concrete solver for one solve
    site; other configs pass through untouched.

    ``small_dense=True`` marks the batched small-d dense per-entity solve
    shape, where AUTO promotes to NEWTON for a twice-differentiable loss
    without L1. A config carrying ``l1_weight`` > 0 resolves to OWLQN;
    everything else to LBFGS.
    """
    if config.optimizer_type != OptimizerType.AUTO:
        return config
    if config.l1_weight > 0.0:
        resolved = OptimizerType.OWLQN
    else:
        eligible = (
            small_dense
            and loss is not None
            and getattr(loss, "twice_differentiable", False)
        )
        resolved = OptimizerType.NEWTON if eligible else OptimizerType.LBFGS
    return dataclasses.replace(config, optimizer_type=resolved)


def solver_state_class(config: OptimizerConfig):
    """The state class ``solve(config, ...)`` hands a ``state_observer``: the
    (de)serialization contract of ``io/checkpoint.SolverCheckpointer``. An
    elastic-net λ solves with OWL-QN, which ``optimizer_type`` says."""
    from photon_ml_torch.optim.lbfgs import LBFGSState
    from photon_ml_torch.optim.owlqn import OWLQNState
    from photon_ml_torch.optim.tron import TRONState

    t = config.optimizer_type
    if t in (OptimizerType.LBFGS, OptimizerType.LBFGSB):
        return LBFGSState
    if t == OptimizerType.OWLQN:
        return OWLQNState
    if t == OptimizerType.TRON:
        return TRONState
    raise ValueError(
        f"{t.name} has no host-loop (streaming) mode, so no checkpointable "
        "solver state")


def default_config_for(optimizer_type: OptimizerType) -> OptimizerConfig:
    """Reference defaults: LBFGS maxIter=100 tol=1e-7 (LBFGS.scala:152-157);
    TRON maxIter=15 tol=1e-5 (TRON.scala:257-262)."""
    if optimizer_type == OptimizerType.TRON:
        return OptimizerConfig(
            optimizer_type=optimizer_type, max_iterations=15, tolerance=1e-5
        )
    return OptimizerConfig(optimizer_type=optimizer_type)
