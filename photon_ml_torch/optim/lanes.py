"""Lane-batched L-BFGS: many independent small solves advancing in lock-step.

The torch form of ``jax.vmap`` over ``minimize_lbfgs``
(``photon_ml_tpu/algorithm/coordinates.py`` ``_solve_bucket_entities``):
every state field carries a leading ``[lanes]`` axis, each lane follows
exactly the iteration it would follow alone (``optim/lbfgs.py``), and a
per-lane done mask freezes finished lanes by ``torch.where`` in the outer
loop and in the Wolfe line search. The loop ends when every lane is done;
the host reads one flag per outer iteration and one per line-search trial.

The tolerance may be a per-lane ``[lanes]`` tensor, and box bounds ``[d]``
(shared) or ``[lanes, d]`` (per lane, ±inf where a lane has none): the
configuration lanes of ``algorithm/lane_search.py`` vmap the single-vector
solver with those per-lane arguments. A scalar and a uniform vector give
the same bits.
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_torch.optim.common import (
    ConvergenceReason,
    LaneResult,
    any_lane,
    check_convergence_lanes,
    wolfe_line_search_lanes,
)

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def _rows(hist: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """hist[lane, idx[lane]] for a [lanes, m, ...] history."""
    return hist[torch.arange(hist.shape[0], device=hist.device), idx]


def two_loop_direction_lanes(g, s_hist, y_hist, rho, count, head, pairs: int) -> torch.Tensor:
    """The L-BFGS two-loop recursion per lane. s_hist/y_hist [lanes, m, d],
    rho [lanes, m], count/head [lanes] int64. Slots beyond a lane's ``count``
    are masked; ``pairs`` bounds every lane's count (the iterations run so
    far), so the loops stop there."""
    m = s_hist.shape[1]
    lanes = torch.arange(g.shape[0], device=g.device)
    q = g
    alphas = torch.zeros_like(rho)
    for i in range(pairs):
        idx = (head - i) % m
        valid = i < count
        alpha = torch.where(valid, rho[lanes, idx] * torch.sum(s_hist[lanes, idx] * q, dim=-1),
                            0.0)
        q = q - alpha.unsqueeze(-1) * y_hist[lanes, idx]
        alphas[lanes, idx] = alpha
    s_head, y_head = _rows(s_hist, head), _rows(y_hist, head)
    gamma = torch.where(
        count > 0,
        torch.sum(s_head * y_head, dim=-1) / torch.clamp(torch.sum(y_head * y_head, dim=-1),
                                                         min=1e-30),
        1.0)
    r = gamma.unsqueeze(-1) * q
    for i in range(pairs):  # oldest to newest among a lane's valid pairs
        idx = (head - (count - 1 - i)) % m
        valid = i < count
        beta = rho[lanes, idx] * torch.sum(y_hist[lanes, idx] * r, dim=-1)
        r = r + torch.where(valid, alphas[lanes, idx] - beta, 0.0).unsqueeze(-1) \
            * s_hist[lanes, idx]
    return -r


def lane_tolerance(tolerance, like: torch.Tensor):
    """A per-lane tolerance as a tensor of the solve's dtype; a Python
    scalar stays as it is."""
    if isinstance(tolerance, torch.Tensor):
        return tolerance.to(dtype=like.dtype, device=like.device)
    return tolerance


def minimize_lbfgs_lanes(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    w0: torch.Tensor,
    *,
    max_iter: int = 100,
    history: int = 10,
    tolerance: "float | torch.Tensor" = 1e-7,
    rel_function_tolerance: float | None = None,
    max_line_search_steps: int = 25,
    lower_bounds: torch.Tensor | None = None,
    upper_bounds: torch.Tensor | None = None,
) -> LaneResult:
    """Minimize ``lanes`` smooth functions at once. ``value_and_grad_fn``
    maps [lanes, d] coefficients to ([lanes] values, [lanes, d] gradients),
    lane by lane independent. ``tolerance`` is a scalar or [lanes]. With
    box bounds ([d] or [lanes, d]) every lane takes ``optim/lbfgs.py``'s
    projected path: iterates projected onto the box, projected Armijo
    backtracking and the projected-gradient convergence test."""
    lanes, d = w0.shape
    dtype, device = w0.dtype, w0.device
    m = history
    tolerance = lane_tolerance(tolerance, w0)
    has_box = lower_bounds is not None or upper_bounds is not None
    if has_box:
        inf = torch.full((lanes, d), float("inf"), dtype=dtype, device=device)
        lo = -inf if lower_bounds is None else torch.as_tensor(
            lower_bounds, dtype=dtype, device=device).expand(lanes, d)
        hi = inf if upper_bounds is None else torch.as_tensor(
            upper_bounds, dtype=dtype, device=device).expand(lanes, d)

    def project(v):
        return torch.clamp(v, lo, hi) if has_box else v

    def grad_norm(w, g):
        if not has_box:
            return torch.linalg.norm(g, dim=-1)
        # norm of P(w - g) - w: zero iff w is box-stationary
        return torch.linalg.norm(project(w - g) - w, dim=-1)

    w = project(w0)
    f, g = value_and_grad_fn(w)
    g0_norm = grad_norm(w, g)
    s_hist = torch.zeros((lanes, m, d), dtype=dtype, device=device)
    y_hist = torch.zeros((lanes, m, d), dtype=dtype, device=device)
    rho = torch.zeros((lanes, m), dtype=dtype, device=device)
    count = torch.zeros((lanes,), dtype=torch.int64, device=device)
    head = torch.zeros((lanes,), dtype=torch.int64, device=device)
    iteration = torch.zeros((lanes,), dtype=torch.int32, device=device)
    reason = torch.where(g0_norm <= tolerance,
                         int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
                         _NOT_CONVERGED).to(torch.int32)
    slots = torch.arange(m, device=device)
    col = lambda v: v.unsqueeze(-1)  # noqa: E731

    for step in range(max_iter):
        active = (iteration < max_iter) & (reason == _NOT_CONVERGED)
        if not any_lane(active):
            break
        direction = two_loop_direction_lanes(g, s_hist, y_hist, rho, count, head, min(step, m))
        t_init = torch.where(count == 0,
                             1.0 / torch.clamp(torch.linalg.norm(g, dim=-1), min=1.0), 1.0)
        if has_box:
            direction, w_new, f_new, g_new, ls_ok = _projected_step(
                value_and_grad_fn, project, w, f, g, direction, t_init.to(dtype), active, lo,
                hi, max_line_search_steps)
        else:
            # not a descent direction: steepest descent
            direction = torch.where(col(torch.sum(g * direction, dim=-1) >= 0.0), -g, direction)
            ls_step, f_new, g_new, ls_ok = wolfe_line_search_lanes(
                value_and_grad_fn, w, f, g, direction, t_init.to(dtype), active,
                max_steps=max_line_search_steps)
            w_new = w + col(ls_step) * direction
        s = w_new - w
        y = g_new - g
        sy = torch.sum(s * y, dim=-1)
        keep = active & ls_ok & (sy > 1e-10)
        # the first pair goes to slot 0, later ones to the slot after head
        new_head = torch.where(count == 0, 0, torch.where(keep, (head + 1) % m, head))
        write = col(keep) & (slots.unsqueeze(0) == col(new_head))
        s_hist = torch.where(col(write), s.unsqueeze(1), s_hist)
        y_hist = torch.where(col(write), y.unsqueeze(1), y_hist)
        rho = torch.where(write, col(1.0 / torch.clamp(sy, min=1e-30)), rho)
        count = torch.where(keep, torch.clamp(count + 1, max=m), count)
        head = torch.where(active, new_head, head)

        gnorm = grad_norm(w_new, g_new)
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
    return LaneResult(coefficients=w, value=f, gradient_norm=grad_norm(w, g),
                      iterations=iteration, reason=reason)


def _projected_step(value_and_grad_fn, project, w, f, g, direction, t, active, lo, hi,
                    max_steps: int):
    """One box-constrained step per lane (``optim/lbfgs.py``'s projected
    path): the direction masked where it pushes into an active bound, with
    the masked steepest descent where it is no descent direction, then
    projected Armijo backtracking in which a lane stops at its first
    acceptable trial. Returns (direction, w_new, f_new, g_new, success)."""
    col = lambda v: v.unsqueeze(-1)  # noqa: E731
    eps_b = 1e-10
    at_lo, at_hi = w <= lo + eps_b, w >= hi - eps_b

    def unblocked(v):
        return torch.where((at_lo & (v < 0.0)) | (at_hi & (v > 0.0)), torch.zeros_like(v), v)

    direction = unblocked(direction)
    direction = torch.where(col(torch.sum(g * direction, dim=-1) >= 0.0), unblocked(-g),
                            direction)
    c1 = 1e-4
    w_new, f_new, g_new = w, f, g
    ok_any = torch.zeros_like(active)
    for _ in range(max_steps):
        live = active & ~ok_any
        if not any_lane(live):
            break
        cand = project(w + col(t) * direction)
        f_t, g_t = value_and_grad_fn(cand)
        decrease = torch.sum(g * (cand - w), dim=-1)
        ok = (f_t <= f + c1 * decrease) & torch.isfinite(f_t) & (f_t < f)
        w_new = torch.where(col(live), cand, w_new)
        f_new = torch.where(live, f_t, f_new)
        g_new = torch.where(col(live), g_t, g_new)
        ok_any = ok_any | (live & ok)
        t = torch.where(live, t * 0.5, t)
    return direction, w_new, f_new, g_new, ok_any
