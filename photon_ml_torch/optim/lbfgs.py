"""L-BFGS with weak-Wolfe line search and optional box projection.

Counterpart of ``photon_ml_tpu/optim/lbfgs.py``; reference photon-lib
optimization/LBFGS.scala (defaults maxIter=100, m=10, tol=1e-7,
LBFGS.scala:152-157; box projection after each step, LBFGS.scala:70-76).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_torch.optim.common import (
    LOCAL,
    ConvergenceReason,
    SolverResult,
    SolverState,
    VectorOps,
    check_convergence,
    flags,
    new_history,
    run_while,
    update_history,
    wolfe_line_search,
)

DEFAULT_MAX_ITER = 100
DEFAULT_HISTORY = 10
DEFAULT_TOLERANCE = 1e-7


def two_loop_direction(g, s_hist, y_hist, rho, count: int, head: int,
                       ops: VectorOps = LOCAL) -> torch.Tensor:
    """L-BFGS two-loop recursion over a circular history buffer.

    s_hist/y_hist: [m, d]; rho: [m] (1/sᵀy); count: number of valid pairs;
    head: slot of the most recent pair; ``ops`` the vector's reductions.
    """
    m = s_hist.shape[0]
    q = g
    alphas = {}
    for i in range(count):
        idx = (head - i) % m
        alpha = rho[idx] * ops.dot(s_hist[idx], q)
        q = q - alpha * y_hist[idx]
        alphas[idx] = alpha
    if count > 0:
        gamma = ops.dot(s_hist[head], y_hist[head]) / torch.clamp(
            ops.dot(y_hist[head], y_hist[head]), min=1e-30)
        r = gamma * q
    else:
        r = q
    for i in range(count):  # oldest to newest
        idx = (head - (count - 1 - i)) % m
        beta = rho[idx] * ops.dot(y_hist[idx], r)
        r = r + (alphas[idx] - beta) * s_hist[idx]
    return -r


@dataclasses.dataclass
class LBFGSState(SolverState):
    """The L-BFGS loop state: the fields of the JAX package's ``_LBFGSState``
    (``photon_ml_tpu/optim/lbfgs.py:80-95``)."""

    w: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    s_hist: torch.Tensor
    y_hist: torch.Tensor
    rho: torch.Tensor
    count: int
    head: int
    iteration: int
    reason: int
    prev_f: torch.Tensor
    g0_norm: torch.Tensor
    value_history: torch.Tensor
    grad_norm_history: torch.Tensor


def minimize_lbfgs(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    *,
    max_iter: int = DEFAULT_MAX_ITER,
    history: int = DEFAULT_HISTORY,
    tolerance: float = DEFAULT_TOLERANCE,
    rel_function_tolerance: float | None = None,
    lower_bounds: torch.Tensor | None = None,
    upper_bounds: torch.Tensor | None = None,
    max_line_search_steps: int = 25,
    ops: VectorOps = LOCAL,
    state_observer=None,
    resume_state: LBFGSState | None = None,
) -> SolverResult:
    """Minimize a smooth function with L-BFGS.

    With ``lower_bounds``/``upper_bounds`` set, iterates are projected onto
    the box after every accepted step, the search is projected Armijo
    backtracking, and convergence is tested on the projected gradient (the
    reference's scheme, LBFGS.scala:70-76; the LBFGSB entry point). ``ops``
    takes every inner product and norm over the vector (a model-sharded one
    over its mesh axis, ``optim/common.py``).

    ``state_observer`` sees the :class:`LBFGSState` after every outer
    iteration; ``resume_state`` re-enters the loop from a saved state
    without evaluating the start point again (``optim/common.run_while``).
    """
    dtype, device = w0.dtype, w0.device
    d = w0.shape[0]
    m = history

    has_box = lower_bounds is not None or upper_bounds is not None
    inf = torch.full((d,), float("inf"), dtype=dtype, device=device)
    lo = -inf if lower_bounds is None else torch.as_tensor(lower_bounds, dtype=dtype, device=device)
    hi = inf if upper_bounds is None else torch.as_tensor(upper_bounds, dtype=dtype, device=device)

    def project(w):
        return torch.clamp(w, lo, hi) if has_box else w

    def projected_grad_norm(w, g):
        if not has_box:
            return ops.norm(g)
        # norm of P(w - g) - w: zero iff w is box-stationary
        return ops.norm(project(w - g) - w)

    if resume_state is not None:
        init = resume_state
    else:
        w = project(w0.to(dtype))
        f, g = value_and_grad_fn(w)
        g0_norm = projected_grad_norm(w, g)
        reason = int(ConvergenceReason.NOT_CONVERGED)
        if bool(g0_norm <= tolerance):  # already stationary at the start
            reason = int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE)
        init = LBFGSState(
            w=w, f=f, g=g,
            s_hist=torch.zeros((m, d), dtype=dtype, device=device),
            y_hist=torch.zeros((m, d), dtype=dtype, device=device),
            rho=torch.zeros((m,), dtype=dtype, device=device),
            count=0, head=0, iteration=0, reason=reason,
            prev_f=torch.full((), float("inf"), dtype=dtype, device=device),
            g0_norm=g0_norm,
            value_history=new_history(max_iter, f),
            grad_norm_history=new_history(max_iter, g0_norm))

    def cond(st: LBFGSState) -> bool:
        return st.iteration < max_iter and st.reason == ConvergenceReason.NOT_CONVERGED

    def body(st: LBFGSState) -> LBFGSState:
        w, f, g = st.w, st.f, st.g
        direction = two_loop_direction(g, st.s_hist, st.y_hist, st.rho, st.count, st.head, ops)
        if has_box:
            # active-set masking: don't push into an active bound
            eps_b = 1e-10
            at_lo, at_hi = w <= lo + eps_b, w >= hi - eps_b
            direction = torch.where((at_lo & (direction < 0.0)) | (at_hi & (direction > 0.0)),
                                    torch.zeros_like(direction), direction)
            sd = -g
            sd = torch.where((at_lo & (sd < 0.0)) | (at_hi & (sd > 0.0)),
                             torch.zeros_like(sd), sd)
            if bool(ops.dot(g, direction) >= 0.0):
                direction = sd
        elif bool(ops.dot(g, direction) >= 0.0):
            direction = -g  # not a descent direction: steepest descent

        if st.count == 0:
            t_init = 1.0 / torch.clamp(ops.norm(g), min=1.0)
        else:
            t_init = torch.ones((), dtype=dtype, device=device)

        if has_box:
            # projected Armijo backtracking: trial points stay feasible, the
            # sufficient-decrease test uses the actual displacement
            c1 = 1e-4
            t, ls_success = t_init, False
            w_new, f_new, g_new = w, f, g
            for _ in range(max_line_search_steps):
                w_new = project(w + t * direction)
                f_new, g_new = value_and_grad_fn(w_new)
                decrease = ops.dot(g, w_new - w)
                ls_success = all(flags(f_new <= f + c1 * decrease,
                                       torch.isfinite(f_new), f_new < f))
                t = t * 0.5
                if ls_success:
                    break
        else:
            ls = wolfe_line_search(value_and_grad_fn, w, f, g, direction, t_init,
                                   max_steps=max_line_search_steps, ops=ops)
            w_new = w + ls.step * direction
            f_new, g_new = ls.value, ls.gradient
            ls_success = ls.success

        s = w_new - w
        y = g_new - g
        sy = ops.dot(s, y)
        keep_pair = ls_success and bool(sy > 1e-10)
        count, head = update_history(st.s_hist, st.y_hist, st.rho, st.count, st.head, s, y, sy,
                                     keep_pair)

        gnorm = projected_grad_norm(w_new, g_new)
        if ls_success:
            reason = check_convergence(
                value=f_new, prev_value=f, grad_norm=gnorm, initial_grad_norm=st.g0_norm,
                tolerance=tolerance, rel_function_tolerance=rel_function_tolerance)
            w, f, g = w_new, f_new, g_new
        else:
            reason = int(ConvergenceReason.LINE_SEARCH_FAILED)
        iteration = st.iteration + 1
        st.value_history[iteration] = f
        st.grad_norm_history[iteration] = gnorm
        return dataclasses.replace(st, w=w, f=f, g=g, count=count, head=head,
                                   iteration=iteration, reason=reason, prev_f=st.f)

    final = run_while(cond, body, init, observer=state_observer)
    reason = final.reason
    if reason == ConvergenceReason.NOT_CONVERGED:
        reason = int(ConvergenceReason.MAX_ITERATIONS)
    return SolverResult(
        coefficients=final.w,
        value=final.f,
        gradient_norm=projected_grad_norm(final.w, final.g),
        iterations=final.iteration,
        reason=reason,
        value_history=final.value_history,
        grad_norm_history=final.grad_norm_history,
    )
