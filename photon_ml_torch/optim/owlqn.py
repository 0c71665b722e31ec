"""OWL-QN: Orthant-Wise Limited-memory Quasi-Newton for L1 regularization.

Counterpart of ``photon_ml_tpu/optim/owlqn.py``; reference photon-lib
optimization/OWLQN.scala:40-86 (Andrew & Gao 2007). The L2 part of elastic
net stays in the smooth objective; this solver adds λ₁‖w‖₁ through the
pseudo-gradient and orthant projection.

:func:`minimize_owlqn_lanes` is the lane form, the torch form of
``jax.vmap`` over ``minimize_owlqn`` (an elastic-net random effect): every
state field carries a leading ``[lanes]`` axis and a per-lane done mask
freezes finished lanes by ``torch.where``, in the outer loop and in the
orthant-projected backtracking, so each lane follows the iteration it would
follow alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from photon_ml_torch.optim.common import (
    LOCAL,
    ConvergenceReason,
    VectorOps,
    LaneResult,
    SolverResult,
    SolverState,
    any_lane,
    check_convergence,
    check_convergence_lanes,
    flags,
    new_history,
    run_while,
    update_history,
)
from photon_ml_torch.optim.lanes import lane_tolerance, two_loop_direction_lanes
from photon_ml_torch.optim.lbfgs import two_loop_direction

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def pseudo_gradient(w: torch.Tensor, g: torch.Tensor, l1: torch.Tensor) -> torch.Tensor:
    """Pseudo-gradient of f(w) = L(w) + l1*‖w‖₁ (Andrew & Gao 2007, eq. 4)."""
    right = g + l1
    left = g - l1
    zero = torch.zeros_like(g)
    return torch.where(
        w > 0.0, right,
        torch.where(w < 0.0, left,
                    torch.where(right < 0.0, right, torch.where(left > 0.0, left, zero))),
    )


@dataclasses.dataclass
class OWLQNState(SolverState):
    """The OWL-QN loop state: the fields of the JAX package's
    ``_OWLQNState`` (``f`` is the smooth + L1 value, ``g`` the smooth
    gradient)."""

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
    g0_norm: torch.Tensor
    value_history: torch.Tensor
    grad_norm_history: torch.Tensor


def minimize_owlqn(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    *,
    l1_weight: float,
    max_iter: int = 100,
    history: int = 10,
    tolerance: float = 1e-7,
    rel_function_tolerance: float | None = None,
    max_line_search_steps: int = 30,
    ops: VectorOps = LOCAL,
    state_observer=None,
    resume_state: OWLQNState | None = None,
) -> SolverResult:
    """Minimize smooth(w) + l1_weight * ‖w‖₁; ``value_and_grad_fn`` covers
    only the smooth part (loss + optional L2). ``ops`` takes the vector's
    inner products, norms and the L1 sum (``optim/common.py``).
    ``state_observer``/``resume_state``: as in ``minimize_lbfgs``."""
    dtype, device = w0.dtype, w0.device
    d = w0.shape[0]
    m = history
    l1 = torch.tensor(l1_weight, dtype=dtype, device=device)

    def full_value(w, smooth_f):
        return smooth_f + l1 * ops.abs_sum(w)

    if resume_state is not None:
        init = resume_state
    else:
        w = w0.to(dtype)
        sf0, g = value_and_grad_fn(w)
        f = full_value(w, sf0)
        g0_norm = ops.norm(pseudo_gradient(w, g, l1))
        reason = int(ConvergenceReason.NOT_CONVERGED)
        if bool(g0_norm <= tolerance):
            reason = int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE)
        init = OWLQNState(
            w=w, f=f, g=g,
            s_hist=torch.zeros((m, d), dtype=dtype, device=device),
            y_hist=torch.zeros((m, d), dtype=dtype, device=device),
            rho=torch.zeros((m,), dtype=dtype, device=device),
            count=0, head=0, iteration=0, reason=reason, g0_norm=g0_norm,
            value_history=new_history(max_iter, f),
            grad_norm_history=new_history(max_iter, g0_norm))

    def cond(st: OWLQNState) -> bool:
        return st.iteration < max_iter and st.reason == ConvergenceReason.NOT_CONVERGED

    def body(st: OWLQNState) -> OWLQNState:
        w, f, g = st.w, st.f, st.g
        pg = pseudo_gradient(w, g, l1)
        direction = two_loop_direction(pg, st.s_hist, st.y_hist, st.rho, st.count, st.head,
                                       ops)
        # constrain the direction to the descent orthant of -pg
        direction = torch.where(direction * (-pg) > 0.0, direction, torch.zeros_like(direction))
        if bool(ops.dot(direction, pg) >= 0.0):
            direction = -pg  # degenerate: steepest descent on the pseudo-gradient
        # orthant of the search: sign(w), or sign(-pg) where w == 0
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))

        if st.count == 0:
            t = 1.0 / torch.clamp(ops.norm(pg), min=1.0)
        else:
            t = torch.ones((), dtype=dtype, device=device)

        # projected backtracking on the full (smooth + L1) objective at the
        # orthant-projected trial point; Armijo decrease measured against the
        # actual displacement dotted with the pseudo-gradient
        c1 = 1e-4
        ls_ok = False
        w_new, f_new, g_new = w, f, g
        for _ in range(max_line_search_steps):
            cand = w + t * direction
            w_new = torch.where(cand * xi > 0.0, cand, torch.zeros_like(cand))
            sf, g_new = value_and_grad_fn(w_new)
            f_new = full_value(w_new, sf)
            decrease = ops.dot(pg, w_new - w)
            ls_ok = all(flags(f_new <= f + c1 * decrease, torch.isfinite(f_new), f_new < f))
            t = t * 0.5
            if ls_ok:
                break

        s = w_new - w
        y = g_new - g  # smooth gradients, per Andrew & Gao
        sy = ops.dot(s, y)
        keep_pair = ls_ok and bool(sy > 1e-10)
        count, head = update_history(st.s_hist, st.y_hist, st.rho, st.count, st.head, s, y, sy,
                                     keep_pair)

        gnorm = ops.norm(pseudo_gradient(w_new, g_new, l1))
        if ls_ok:
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
                                   iteration=iteration, reason=reason)

    final = run_while(cond, body, init, observer=state_observer)
    reason = final.reason
    if reason == ConvergenceReason.NOT_CONVERGED:
        reason = int(ConvergenceReason.MAX_ITERATIONS)
    return SolverResult(
        coefficients=final.w,
        value=final.f,
        gradient_norm=ops.norm(pseudo_gradient(final.w, final.g, l1)),
        iterations=final.iteration,
        reason=reason,
        value_history=final.value_history,
        grad_norm_history=final.grad_norm_history,
    )


def minimize_owlqn_lanes(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    *,
    l1_weight: "float | torch.Tensor",
    max_iter: int = 100,
    history: int = 10,
    tolerance: "float | torch.Tensor" = 1e-7,
    rel_function_tolerance: float | None = None,
    max_line_search_steps: int = 30,
) -> LaneResult:
    """Minimize smooth(w) + l1_weight·‖w‖₁ for ``lanes`` independent
    problems at once. ``value_and_grad_fn`` maps [lanes, d] to ([lanes],
    [lanes, d]) over the smooth part only. ``l1_weight`` and ``tolerance``
    are scalars or [lanes] tensors (a uniform vector gives a scalar's
    bits). The host reads one flag per outer iteration and one per
    backtracking step."""
    lanes, d = w0.shape
    dtype, device = w0.dtype, w0.device
    m = history
    tolerance = lane_tolerance(tolerance, w0)
    l1 = torch.as_tensor(l1_weight, dtype=dtype, device=device)
    col = lambda v: v.unsqueeze(-1)  # noqa: E731
    # the pseudo-gradient's per-lane weight broadcasts over the columns
    l1_cols = col(l1) if l1.dim() == 1 else l1

    def full_value(w, smooth_f):
        return smooth_f + l1 * torch.sum(torch.abs(w), dim=-1)

    w = w0
    sf0, g = value_and_grad_fn(w)
    f = full_value(w, sf0)
    g0_norm = torch.linalg.norm(pseudo_gradient(w, g, l1_cols), dim=-1)
    s_hist = torch.zeros((lanes, m, d), dtype=dtype, device=device)
    y_hist = torch.zeros((lanes, m, d), dtype=dtype, device=device)
    rho = torch.zeros((lanes, m), dtype=dtype, device=device)
    count = torch.zeros((lanes,), dtype=torch.int64, device=device)
    head = torch.zeros((lanes,), dtype=torch.int64, device=device)
    iteration = torch.zeros((lanes,), dtype=torch.int32, device=device)
    reason = torch.where(g0_norm <= tolerance, int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
                         _NOT_CONVERGED).to(torch.int32)
    slots = torch.arange(m, device=device)
    c1 = 1e-4

    for step in range(max_iter):
        active = (iteration < max_iter) & (reason == _NOT_CONVERGED)
        if not any_lane(active):
            break
        pg = pseudo_gradient(w, g, l1_cols)
        direction = two_loop_direction_lanes(pg, s_hist, y_hist, rho, count, head, min(step, m))
        # constrain the direction to the descent orthant of -pg; degenerate:
        # steepest descent on the pseudo-gradient
        direction = torch.where(direction * (-pg) > 0.0, direction, torch.zeros_like(direction))
        direction = torch.where(col(torch.sum(direction * pg, dim=-1) >= 0.0), -pg, direction)
        # orthant of the search: sign(w), or sign(-pg) where w == 0
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))
        t = torch.where(count == 0, 1.0 / torch.clamp(torch.linalg.norm(pg, dim=-1), min=1.0),
                        torch.ones((), dtype=dtype, device=device)).to(dtype)

        # projected backtracking on the full objective at the orthant-projected
        # trial point; a lane stops at its first acceptable trial
        w_new, f_new, g_new = w, f, g
        ls_ok = torch.zeros_like(active)
        for _ in range(max_line_search_steps):
            live = active & ~ls_ok
            if not any_lane(live):
                break
            cand = w + col(t) * direction
            cand = torch.where(cand * xi > 0.0, cand, torch.zeros_like(cand))
            sf, sg = value_and_grad_fn(cand)
            f_t = full_value(cand, sf)
            decrease = torch.sum(pg * (cand - w), dim=-1)
            ok = (f_t <= f + c1 * decrease) & torch.isfinite(f_t) & (f_t < f)
            w_new = torch.where(col(live), cand, w_new)
            f_new = torch.where(live, f_t, f_new)
            g_new = torch.where(col(live), sg, g_new)
            ls_ok = ls_ok | (live & ok)
            t = torch.where(live, t * 0.5, t)

        s = w_new - w
        y = g_new - g  # smooth gradients, per Andrew & Gao
        sy = torch.sum(s * y, dim=-1)
        keep = active & ls_ok & (sy > 1e-10)
        new_head = torch.where(keep, torch.where(count == 0, 0, (head + 1) % m), head)
        write = col(keep) & (slots.unsqueeze(0) == col(new_head))
        s_hist = torch.where(col(write), s.unsqueeze(1), s_hist)
        y_hist = torch.where(col(write), y.unsqueeze(1), y_hist)
        rho = torch.where(write, col(1.0 / torch.clamp(sy, min=1e-30)), rho)
        count = torch.where(keep, torch.clamp(count + 1, max=m), count)
        head = new_head

        gnorm = torch.linalg.norm(pseudo_gradient(w_new, g_new, l1_cols), dim=-1)
        new_reason = torch.where(
            ls_ok,
            check_convergence_lanes(value=f_new, prev_value=f, grad_norm=gnorm,
                                    initial_grad_norm=g0_norm, tolerance=tolerance,
                                    rel_function_tolerance=rel_function_tolerance),
            int(ConvergenceReason.LINE_SEARCH_FAILED)).to(torch.int32)
        accept = active & ls_ok
        w = torch.where(col(accept), w_new, w)
        f = torch.where(accept, f_new, f)
        g = torch.where(col(accept), g_new, g)
        reason = torch.where(active, new_reason, reason)
        iteration = iteration + active.to(torch.int32)

    reason = torch.where(reason == _NOT_CONVERGED, int(ConvergenceReason.MAX_ITERATIONS),
                         reason).to(torch.int32)
    return LaneResult(coefficients=w, value=f,
                      gradient_norm=torch.linalg.norm(pseudo_gradient(w, g, l1_cols), dim=-1),
                      iterations=iteration, reason=reason)
