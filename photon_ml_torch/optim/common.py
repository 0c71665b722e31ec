"""Shared optimizer machinery: results, convergence, line search.

Counterpart of ``photon_ml_tpu/optim/common.py``; reference photon-lib
optimization/Optimizer.scala:135-149 (convergence by max-iter / loss-delta /
gradient-norm) and OptimizationStatesTracker.scala (per-iteration history).

The solvers are Python loops over tensors on the batch's device: the shape
of the JAX package's host-loop mode (``run_while(host=True)``), with the same
per-iteration arithmetic. Scalars stay 0-dim tensors in the solve dtype;
only the branch decisions come back to the host.

Every reduction the single-vector solvers take over the coefficient vector
(inner products, norms, the L1 sum) goes through one :class:`VectorOps`,
which the bound objective supplies (``vector_ops``). :data:`LOCAL` is the
plain ``torch.dot``/``torch.linalg.norm`` of a vector held whole; over a
model-sharded vector (``parallel/column_sharded.ModelAxisOps``) each is the
rank's local reduction plus one all-reduce over the mesh's "model" axis, so
every rank of the model group receives the same bits and takes the same
branches. Elementwise work stays local.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from photon_ml_torch.telemetry import tracing


class ConvergenceReason(enum.IntEnum):
    """Why an optimizer stopped (reference util/ConvergenceReason.scala)."""

    NOT_CONVERGED = 0
    MAX_ITERATIONS = 1
    FUNCTION_VALUES_WITHIN_TOLERANCE = 2
    GRADIENT_WITHIN_TOLERANCE = 3
    LINE_SEARCH_FAILED = 4


class VectorOps:
    """The reductions of a solver over a coefficient vector held whole."""

    @staticmethod
    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.dot(a, b)

    @staticmethod
    def norm(a: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(a)

    @staticmethod
    def abs_sum(a: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(a))


#: the reductions of a vector held whole on this rank
LOCAL = VectorOps()


def flags(*conditions: torch.Tensor) -> list[bool]:
    """Several 0-dim boolean tensors brought to the host in one transfer."""
    return torch.stack(conditions).tolist()


#: host reads of a lane mask made by the lane solvers (each one waits for
#: the device): read by ``chip_smoke.py`` beside the kernels an update issues
lane_host_reads = 0


def any_lane(mask: torch.Tensor) -> bool:
    """Whether any lane of ``mask`` is set: the lane loops' one host read."""
    global lane_host_reads
    lane_host_reads += 1
    return bool(mask.any())


class SolverState:
    """The loop state of a single-vector solver (``optim/lbfgs.LBFGSState``,
    ``owlqn.OWLQNState``, ``tron.TRONState``), with the field names of the
    JAX package's state structs: the (de)serialization contract of
    ``io/checkpoint.SolverCheckpointer``, in either direction. Integer
    fields are Python ints here and int32 scalars on disk; the others are
    tensors in the solve dtype."""

    INT_FIELDS = ("count", "head", "iteration", "reason")

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Every field as a host numpy copy (the next step updates the
        history buffers in place)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = (np.asarray(v, dtype=np.int32) if f.name in self.INT_FIELDS
                           else v.detach().to("cpu", copy=True).numpy())
        return out

    @classmethod
    def from_arrays(cls, arrays, *, dtype: torch.dtype, device) -> "SolverState":
        """A state from :meth:`to_arrays` output, or from a JAX-written one."""
        kwargs = {}
        for f in dataclasses.fields(cls):
            v = np.asarray(arrays[f.name])
            kwargs[f.name] = (int(v) if f.name in cls.INT_FIELDS
                              else torch.as_tensor(v, device=device).to(dtype).clone())
        return cls(**kwargs)


def run_while(cond, body, init, *, observer=None):
    """``state = body(state)`` while ``cond(state)``: the solvers' outer loop
    (the JAX package's ``run_while(host=True)``). ``observer`` is called
    with the state after every body step, the hook of solver-state
    checkpoints; it observes and never rewrites, so a solve with one is
    bitwise the solve without. The history buffers of a state are updated
    in place by the next step: an observer copies what it keeps."""
    state = init
    i = 0
    while cond(state):
        # a host wall-clock span an iteration: it observes only, and adds no
        # synchronization or host read
        with tracing.span("solver/iteration", cat="solver", i=i):
            state = body(state)
        if observer is not None:
            observer(state)
        i += 1
    return state


@dataclasses.dataclass
class SolverResult:
    """Final state + per-iteration history of one solve.

    ``value_history`` / ``grad_norm_history`` are [max_iter + 1] tensors,
    NaN past ``iterations`` (OptimizationStatesTracker's bounded queue).
    """

    coefficients: torch.Tensor
    value: torch.Tensor
    gradient_norm: torch.Tensor
    iterations: int
    reason: int  # ConvergenceReason code
    value_history: torch.Tensor
    grad_norm_history: torch.Tensor

    @property
    def converged(self) -> bool:
        return self.reason != ConvergenceReason.NOT_CONVERGED

    def states_table(self) -> str:
        """Printable per-iteration state table (reference
        OptimizationStatesTracker.toString, OptimizationStatesTracker.scala:
        82-101): iteration | objective value | gradient norm, ending with the
        convergence reason."""
        values = self.value_history.detach().cpu().double().numpy()
        grads = self.grad_norm_history.detach().cpu().double().numpy()
        n = int(self.iterations)
        lines = [f"{'iter':>6} {'value':>16} {'|gradient|':>16}"]
        for i in range(min(n + 1, len(values))):
            if np.isnan(values[i]):
                break
            lines.append(f"{i:>6} {values[i]:>16.8g} {grads[i]:>16.8g}")
        reason = ConvergenceReason(int(self.reason)).name
        lines.append(f"converged after {n} iterations: {reason}")
        return "\n".join(lines)


@dataclasses.dataclass
class LaneResult:
    """Final state of a lane-batched solve: one independent problem per row.

    coefficients [lanes, d]; value, gradient_norm [lanes]; iterations and
    reason [lanes] int32 (ConvergenceReason codes).
    """

    coefficients: torch.Tensor
    value: torch.Tensor
    gradient_norm: torch.Tensor
    iterations: torch.Tensor
    reason: torch.Tensor


@dataclasses.dataclass
class LaneTrace:
    """Per-lane convergence scalars of a lane-batched solve (one entry per
    random-effect entity), the skeleton of the reference's per-problem
    OptimizationStatesTracker report. ``valid`` is False on padding lanes
    (out-of-range entity rows solve all-zero-weight problems whose counts
    and reasons must not enter any tally)."""

    iterations: torch.Tensor  # [lanes] int32
    reason: torch.Tensor  # [lanes] int32 ConvergenceReason codes
    value: torch.Tensor  # [lanes]
    gradient_norm: torch.Tensor  # [lanes]
    valid: torch.Tensor  # [lanes] bool
    #: produced by the lane scheduler, which fed the lane-iteration
    #: histogram itself (telemetry does not count these lanes again)
    scheduled: bool = False

    def replace(self, **changes) -> "LaneTrace":
        return dataclasses.replace(self, **changes)


class LaneTraces:
    """The per-bucket LaneTraces of one coordinate update, kept as the
    device tensors the solves returned; a consumer merges them on the host."""

    def __init__(self, buckets):
        self.buckets: tuple[LaneTrace, ...] = tuple(buckets)


def lane_trace_of(result: LaneResult, valid: torch.Tensor | None = None) -> LaneTrace:
    if valid is None:
        valid = torch.ones_like(result.iterations, dtype=torch.bool)
    return LaneTrace(iterations=result.iterations, reason=result.reason, value=result.value,
                     gradient_norm=result.gradient_norm, valid=valid)


def new_history(max_iter: int, first: torch.Tensor) -> torch.Tensor:
    hist = torch.full((max_iter + 1,), float("nan"), dtype=first.dtype, device=first.device)
    hist[0] = first
    return hist


def check_convergence(
    *,
    value: torch.Tensor,
    prev_value: torch.Tensor,
    grad_norm: torch.Tensor,
    initial_grad_norm: torch.Tensor,
    tolerance: float,
    rel_function_tolerance: float | None = None,
) -> int:
    """Return a ConvergenceReason code (0 if not converged).

    The reference's dual test (Optimizer.scala:135-149): relative change in
    objective value below tolerance, or gradient norm below tolerance
    relative to the initial gradient norm. ``rel_function_tolerance``
    (None = use ``tolerance``) sets a separate threshold for the
    function-decrease test.
    """
    rel_delta = torch.abs(value - prev_value) / torch.clamp(
        torch.maximum(torch.abs(value), torch.abs(prev_value)), min=1.0
    )
    ftol = tolerance if rel_function_tolerance is None else rel_function_tolerance
    grad_ok, func_ok = flags(
        grad_norm <= tolerance * torch.clamp(initial_grad_norm, min=1.0),
        rel_delta <= ftol,
    )
    if grad_ok:
        return int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE)
    if func_ok:
        return int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE)
    return int(ConvergenceReason.NOT_CONVERGED)


def check_convergence_lanes(*, value, prev_value, grad_norm, initial_grad_norm,
                            tolerance: float, rel_function_tolerance: float | None = None):
    """:func:`check_convergence` per lane: an int32 [lanes] tensor of codes,
    decided on the device."""
    rel_delta = torch.abs(value - prev_value) / torch.clamp(
        torch.maximum(torch.abs(value), torch.abs(prev_value)), min=1.0)
    ftol = tolerance if rel_function_tolerance is None else rel_function_tolerance
    grad_ok = grad_norm <= tolerance * torch.clamp(initial_grad_norm, min=1.0)
    func_ok = rel_delta <= ftol
    code = torch.where(func_ok, int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE),
                       int(ConvergenceReason.NOT_CONVERGED))
    code = torch.where(grad_ok, int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE), code)
    return code.to(torch.int32)


@dataclasses.dataclass
class LineSearchResult:
    step: torch.Tensor
    value: torch.Tensor
    gradient: torch.Tensor
    success: bool


def wolfe_line_search(
    value_and_grad_fn,
    w: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    t_init: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_steps: int = 25,
    ops: VectorOps = LOCAL,
) -> LineSearchResult:
    """Weak-Wolfe bisection line search.

    Shrink on Armijo failure, expand (or bisect within the bracket) on
    curvature failure; one value_and_grad per trial. The best
    Armijo-satisfying point seen is returned if curvature never holds.
    Replaces breeze's StrongWolfeLineSearch used by the reference's LBFGS
    (optimization/LBFGS.scala:97-107).
    """
    dg0 = ops.dot(g0, direction)
    zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
    t = t_init.to(f0.dtype)
    lo, hi = zero, None  # hi None: no upper bracket yet (+inf)
    t_best, f_best, g_best, has_best = zero, f0, g0, False
    for _ in range(max_steps):
        f_t, g_t = value_and_grad_fn(w + t * direction)
        armijo, finite, curv, lower = flags(
            f_t <= f0 + c1 * t * dg0,
            torch.isfinite(f_t),
            ops.dot(g_t, direction) >= c2 * dg0,
            f_t < f_best,
        )
        armijo = armijo and finite
        if armijo and (not has_best or lower):
            t_best, f_best, g_best = t, f_t, g_t
        has_best = has_best or armijo
        if not armijo:
            hi = t
            t = 0.5 * (lo + hi)
        elif not curv:
            lo = t
            t = 2.0 * t if hi is None else 0.5 * (lo + hi)
        else:
            break
    success = has_best and bool(f_best < f0)
    return LineSearchResult(step=t_best, value=f_best, gradient=g_best, success=success)


def update_history(s_hist, y_hist, rho, count: int, head: int, s, y, sy,
                   keep_pair: bool) -> tuple[int, int]:
    """Write the pair (s, y) into the circular L-BFGS history in place when
    ``keep_pair``; returns the new (count, head). The first pair goes to
    slot 0."""
    m = s_hist.shape[0]
    if not keep_pair:
        return count, head
    slot = 0 if count == 0 else (head + 1) % m
    s_hist[slot] = s
    y_hist[slot] = y
    rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
    return min(count + 1, m), slot


def wolfe_line_search_lanes(
    value_and_grad_fn,
    w: torch.Tensor,
    f0: torch.Tensor,
    g0: torch.Tensor,
    direction: torch.Tensor,
    t_init: torch.Tensor,
    active: torch.Tensor,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_steps: int = 25,
):
    """:func:`wolfe_line_search` over a leading [lanes] axis: every lane runs
    its own bracketing search, in lock-step. A lane that is done (or not
    ``active``) keeps its state while the others go on: each trial evaluates
    all lanes and the finished ones discard the step by select. The loop ends
    when no lane is searching (one host read per trial). Returns per-lane
    (step, value, gradient, success)."""
    col = lambda v: v.unsqueeze(-1)  # noqa: E731
    dg0 = torch.sum(g0 * direction, dim=-1)
    t = t_init.to(f0.dtype)
    lo = torch.zeros_like(f0)
    hi = torch.full_like(f0, float("inf"))
    t_best, f_best, g_best = torch.zeros_like(f0), f0, g0
    has_best = torch.zeros_like(f0, dtype=torch.bool)
    done = torch.zeros_like(has_best)
    for _ in range(max_steps):
        live = active & ~done
        if not any_lane(live):
            break
        f_t, g_t = value_and_grad_fn(w + col(t) * direction)
        armijo = (f_t <= f0 + c1 * t * dg0) & torch.isfinite(f_t)
        curv = torch.sum(g_t * direction, dim=-1) >= c2 * dg0
        better = live & armijo & (~has_best | (f_t < f_best))
        t_best = torch.where(better, t, t_best)
        f_best = torch.where(better, f_t, f_best)
        g_best = torch.where(col(better), g_t, g_best)
        has_best = has_best | (live & armijo)
        new_hi = torch.where(~armijo, t, hi)
        new_lo = torch.where(armijo & ~curv, t, lo)
        mid = 0.5 * (new_lo + new_hi)
        new_t = torch.where(
            ~armijo, mid,
            torch.where(~curv, torch.where(torch.isinf(new_hi), 2.0 * t, mid), t))
        hi = torch.where(live, new_hi, hi)
        lo = torch.where(live, new_lo, lo)
        t = torch.where(live, new_t, t)
        done = done | (live & armijo & curv)
    success = has_best & (f_best < f0)
    return t_best, f_best, g_best, success
