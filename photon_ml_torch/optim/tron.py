"""TRON: trust-region Newton method with a truncated conjugate-gradient inner loop.

Counterpart of ``photon_ml_tpu/optim/tron.py``; reference photon-lib
optimization/TRON.scala (a LIBLINEAR port): the trust-region loop with its
eta/sigma update rules (TRON.scala:152-253) and truncated CG calling the
Hessian-vector product once per step (TRON.scala:278-338).

:func:`minimize_tron_lanes` is the lane form (``jax.vmap`` over
``minimize_tron`` in the JAX package): every state field carries a leading
``[lanes]`` axis and per-lane masks freeze finished lanes, in the outer loop
and in the truncated CG, so each lane follows the iteration it would follow
alone. The host reads one flag per outer iteration; the CG runs its cap of
steps with finished lanes frozen, which changes no lane's result.
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
    flags,
    new_history,
    run_while,
)

# LIBLINEAR trust-region constants (TRON.scala:168-175)
ETA0, ETA1, ETA2 = 1e-4, 0.25, 0.75
SIGMA1, SIGMA2, SIGMA3 = 0.25, 0.5, 4.0


def _boundary_step(z, dvec, delta, ops: VectorOps = LOCAL):
    """z + tau*d with tau >= 0 and ‖z + tau*d‖ = delta."""
    zz = ops.dot(z, z)
    zd = ops.dot(z, dvec)
    dd = torch.clamp(ops.dot(dvec, dvec), min=1e-30)
    rad = torch.sqrt(torch.clamp(zd * zd + dd * (delta * delta - zz), min=0.0))
    tau = (-zd + rad) / dd
    return z + tau * dvec


def _truncated_cg(hv_fn, g, delta, max_cg: int, cg_tol, ops: VectorOps = LOCAL):
    """Solve H z ≈ -g within the trust region ‖z‖ <= delta (Steihaug-Toint,
    reference TRON.truncatedConjugateGradientMethod, TRON.scala:278-338).
    Returns (z, hit_boundary, cg_iters)."""
    z = torch.zeros_like(g)
    r = -g
    dvec = -g
    hit = False
    i = 0
    while i < max_cg:
        hd = hv_fn(dvec)
        dhd = ops.dot(dvec, hd)
        rr = ops.dot(r, r)
        alpha = rr / torch.clamp(dhd, min=1e-30)
        z_try = z + alpha * dvec
        r_new = r - alpha * hd
        rr_new = ops.dot(r_new, r_new)
        neg_curv, outside, converged = flags(
            dhd <= 0.0, ops.norm(z_try) >= delta, torch.sqrt(rr_new) <= cg_tol)
        # negative curvature (non-convex edge case) or leaving the region:
        # go to the boundary
        hit = neg_curv or outside
        z = _boundary_step(z, dvec, delta, ops) if hit else z_try
        beta = rr_new / torch.clamp(rr, min=1e-30)
        dvec = r_new + beta * dvec
        r = r_new
        i += 1
        if hit or converged:
            break
    return z, hit, i


@dataclasses.dataclass
class TRONState(SolverState):
    """The TRON loop state: the fields of the JAX package's ``_TRONState``
    (the initial gradient norm is ``grad_norm_history[0]``)."""

    w: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    delta: torch.Tensor
    iteration: int
    reason: int
    value_history: torch.Tensor
    grad_norm_history: torch.Tensor


def minimize_tron(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    hessian_vector_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    w0: torch.Tensor,
    *,
    max_iter: int = 15,
    tolerance: float = 1e-5,
    rel_function_tolerance: float | None = None,
    max_cg_iter: int = 20,
    cg_forcing: float = 0.1,
    ops: VectorOps = LOCAL,
    state_observer=None,
    resume_state: TRONState | None = None,
) -> SolverResult:
    """Minimize a twice-differentiable convex objective with TRON.

    ``hessian_vector_fn(w, v)`` returns H(w) @ v. Convergence when
    ‖g‖ <= tolerance * ‖g0‖ (LIBLINEAR's test, TRON.scala:208).
    ``rel_function_tolerance`` (None = no function test): relative
    function-decrease stop on accepted rounds. ``ops`` takes the vector's
    inner products and norms (``optim/common.py``).
    ``state_observer``/``resume_state``: as in ``minimize_lbfgs``.
    """
    dtype = w0.dtype
    if resume_state is not None:
        init = resume_state
    else:
        w = w0.to(dtype)
        f, g = value_and_grad_fn(w)
        g0_norm = ops.norm(g)
        reason = int(ConvergenceReason.NOT_CONVERGED)
        if bool(g0_norm <= tolerance):
            # warm starts may arrive stationary: stop before paying a CG loop
            reason = int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE)
        init = TRONState(w=w, f=f, g=g, delta=g0_norm, iteration=0, reason=reason,
                         value_history=new_history(max_iter, f),
                         grad_norm_history=new_history(max_iter, g0_norm))

    def cond(st: TRONState) -> bool:
        return st.iteration < max_iter and st.reason == ConvergenceReason.NOT_CONVERGED

    def body(st: TRONState) -> TRONState:
        w, f, g, delta = st.w, st.f, st.g, st.delta
        gnorm = ops.norm(g)
        w_cur = w
        hv = lambda v: hessian_vector_fn(w_cur, v)  # noqa: E731
        step, hit_boundary, _ = _truncated_cg(hv, g, delta, max_cg_iter, cg_forcing * gnorm,
                                              ops)

        gs = ops.dot(g, step)
        shs = ops.dot(step, hv(step))
        prered = -(gs + 0.5 * shs)
        f_new, g_new = value_and_grad_fn(w + step)
        actred = f - f_new
        snorm = ops.norm(step)

        below0, below1, below2, no_interp, gain, finite = flags(
            actred < ETA0 * prered, actred < ETA1 * prered, actred < ETA2 * prered,
            f_new - f - gs <= 0.0, actred > ETA0 * prered, torch.isfinite(f_new))
        # interpolation factor for severe failures
        if no_interp:
            alpha = torch.full_like(snorm, SIGMA3)
        else:
            alpha = torch.clamp(-0.5 * (gs / torch.clamp(f_new - f - gs, max=-1e-30)), min=SIGMA1)
        # trust-region radius update (LIBLINEAR-style, TRON.scala:214-236)
        if below0:
            delta = torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm, SIGMA2 * delta)
        elif below1:
            delta = torch.maximum(SIGMA1 * delta, torch.minimum(alpha * snorm, SIGMA2 * delta))
        elif below2:
            delta = torch.maximum(SIGMA1 * delta, torch.minimum(alpha * snorm, SIGMA3 * delta))
        elif hit_boundary:
            delta = torch.minimum(SIGMA3 * delta, torch.maximum(delta, snorm))
        else:
            delta = torch.maximum(delta, torch.minimum(alpha * snorm, SIGMA3 * delta))

        accept = gain and finite
        f_prev = f
        if accept:
            w, f, g = w + step, f_new, g_new
        gnorm_acc = ops.norm(g)
        grad_ok, collapsed = flags(
            gnorm_acc <= tolerance * torch.clamp(st.grad_norm_history[0], min=1e-30),
            delta < 1e-12)
        reason = int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE if grad_ok
                     else ConvergenceReason.NOT_CONVERGED)
        if collapsed:
            # a collapsed trust region means no further progress is possible
            reason = int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE)
        if (rel_function_tolerance is not None and accept
                and reason == ConvergenceReason.NOT_CONVERGED):
            rel_delta = torch.abs(f - f_prev) / torch.clamp(
                torch.maximum(torch.abs(f), torch.abs(f_prev)), min=1.0)
            if bool(rel_delta <= rel_function_tolerance):
                reason = int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE)

        iteration = st.iteration + 1
        st.value_history[iteration] = f
        st.grad_norm_history[iteration] = gnorm_acc
        return dataclasses.replace(st, w=w, f=f, g=g, delta=delta, iteration=iteration,
                                   reason=reason)

    final = run_while(cond, body, init, observer=state_observer)
    reason = final.reason
    if reason == ConvergenceReason.NOT_CONVERGED:
        reason = int(ConvergenceReason.MAX_ITERATIONS)
    return SolverResult(
        coefficients=final.w,
        value=final.f,
        gradient_norm=ops.norm(final.g),
        iterations=final.iteration,
        reason=reason,
        value_history=final.value_history,
        grad_norm_history=final.grad_norm_history,
    )


def _boundary_step_lanes(z, dvec, delta):
    """:func:`_boundary_step` per lane: z, dvec [lanes, d], delta [lanes]."""
    zz = torch.sum(z * z, dim=-1)
    zd = torch.sum(z * dvec, dim=-1)
    dd = torch.clamp(torch.sum(dvec * dvec, dim=-1), min=1e-30)
    rad = torch.sqrt(torch.clamp(zd * zd + dd * (delta * delta - zz), min=0.0))
    tau = (-zd + rad) / dd
    return z + tau.unsqueeze(-1) * dvec


def _truncated_cg_lanes(hv_fn, g, delta, max_cg: int, cg_tol, active):
    """:func:`_truncated_cg` per lane, ``max_cg`` steps with a lane frozen
    from the step after it hits the boundary or converges (and throughout
    when not ``active``). Returns (z, hit_boundary) per lane."""
    col = lambda v: v.unsqueeze(-1)  # noqa: E731
    z = torch.zeros_like(g)
    r = -g
    dvec = -g
    hit = torch.zeros_like(active)
    done = ~active
    for _ in range(max_cg):
        live = ~done
        hd = hv_fn(dvec)
        dhd = torch.sum(dvec * hd, dim=-1)
        rr = torch.sum(r * r, dim=-1)
        # negative curvature (non-convex edge case) or leaving the region:
        # go to the boundary
        alpha = rr / torch.clamp(dhd, min=1e-30)
        z_try = z + col(alpha) * dvec
        take_boundary = (dhd <= 0.0) | (torch.linalg.norm(z_try, dim=-1) >= delta)
        z_new = torch.where(col(take_boundary), _boundary_step_lanes(z, dvec, delta), z_try)
        r_new = r - col(alpha) * hd
        rr_new = torch.sum(r_new * r_new, dim=-1)
        converged = torch.sqrt(rr_new) <= cg_tol
        d_new = r_new + col(rr_new / torch.clamp(rr, min=1e-30)) * dvec
        z = torch.where(col(live), z_new, z)
        r = torch.where(col(live), r_new, r)
        dvec = torch.where(col(live), d_new, dvec)
        hit = torch.where(live, take_boundary, hit)
        done = done | (live & (take_boundary | converged))
    return z, hit


def minimize_tron_lanes(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    hessian_vector_at: Callable[[torch.Tensor], Callable[[torch.Tensor], torch.Tensor]],
    w0: torch.Tensor,
    *,
    max_iter: int = 15,
    tolerance: float = 1e-5,
    rel_function_tolerance: float | None = None,
    max_cg_iter: int = 20,
    cg_forcing: float = 0.1,
) -> LaneResult:
    """Minimize ``lanes`` twice-differentiable convex objectives with TRON.
    ``value_and_grad_fn`` maps [lanes, d] to ([lanes], [lanes, d]);
    ``hessian_vector_at(w)`` returns the map v -> H(w) v over [lanes, d].
    Convergence and the radius rules are :func:`minimize_tron`'s, per lane."""
    col = lambda v: v.unsqueeze(-1)  # noqa: E731
    w = w0
    f, g = value_and_grad_fn(w)
    g0_norm = torch.linalg.norm(g, dim=-1)
    delta = g0_norm
    iteration = torch.zeros(g0_norm.shape, dtype=torch.int32, device=w0.device)
    # warm starts may arrive stationary: stop before paying a CG loop
    reason = torch.where(g0_norm <= tolerance, int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
                         int(ConvergenceReason.NOT_CONVERGED)).to(torch.int32)

    for _ in range(max_iter):
        active = (iteration < max_iter) & (reason == ConvergenceReason.NOT_CONVERGED)
        if not any_lane(active):
            break
        gnorm = torch.linalg.norm(g, dim=-1)
        hv = hessian_vector_at(w)
        step, hit_boundary = _truncated_cg_lanes(hv, g, delta, max_cg_iter, cg_forcing * gnorm,
                                                 active)
        gs = torch.sum(g * step, dim=-1)
        shs = torch.sum(step * hv(step), dim=-1)
        prered = -(gs + 0.5 * shs)
        f_new, g_new = value_and_grad_fn(w + step)
        actred = f - f_new
        snorm = torch.linalg.norm(step, dim=-1)
        # interpolation factor for severe failures
        alpha = torch.where(
            f_new - f - gs <= 0.0, SIGMA3,
            torch.clamp(-0.5 * (gs / torch.clamp(f_new - f - gs, max=-1e-30)), min=SIGMA1))
        # trust-region radius update (LIBLINEAR-style, TRON.scala:214-236)
        new_delta = torch.where(
            actred < ETA0 * prered,
            torch.minimum(torch.clamp(alpha, min=SIGMA1) * snorm, SIGMA2 * delta),
            torch.where(
                actred < ETA1 * prered,
                torch.maximum(SIGMA1 * delta, torch.minimum(alpha * snorm, SIGMA2 * delta)),
                torch.where(
                    actred < ETA2 * prered,
                    torch.maximum(SIGMA1 * delta, torch.minimum(alpha * snorm, SIGMA3 * delta)),
                    torch.where(
                        hit_boundary,
                        torch.minimum(SIGMA3 * delta, torch.maximum(delta, snorm)),
                        torch.maximum(delta, torch.minimum(alpha * snorm, SIGMA3 * delta))))))
        accept = (actred > ETA0 * prered) & torch.isfinite(f_new)
        w_acc = torch.where(col(accept), w + step, w)
        f_acc = torch.where(accept, f_new, f)
        g_acc = torch.where(col(accept), g_new, g)
        gnorm_acc = torch.linalg.norm(g_acc, dim=-1)
        new_reason = torch.where(
            gnorm_acc <= tolerance * torch.clamp(g0_norm, min=1e-30),
            int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
            int(ConvergenceReason.NOT_CONVERGED))
        # a collapsed trust region means no further progress is possible
        new_reason = torch.where(new_delta < 1e-12,
                                 int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE),
                                 new_reason)
        if rel_function_tolerance is not None:
            rel_delta = torch.abs(f_acc - f) / torch.clamp(
                torch.maximum(torch.abs(f_acc), torch.abs(f)), min=1.0)
            new_reason = torch.where(
                accept & (rel_delta <= rel_function_tolerance)
                & (new_reason == ConvergenceReason.NOT_CONVERGED),
                int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE), new_reason)
        w = torch.where(col(active), w_acc, w)
        f = torch.where(active, f_acc, f)
        g = torch.where(col(active), g_acc, g)
        delta = torch.where(active, new_delta, delta)
        reason = torch.where(active, new_reason.to(torch.int32), reason)
        iteration = iteration + active.to(torch.int32)

    reason = torch.where(reason == ConvergenceReason.NOT_CONVERGED,
                         int(ConvergenceReason.MAX_ITERATIONS), reason).to(torch.int32)
    return LaneResult(coefficients=w, value=f, gradient_norm=torch.linalg.norm(g, dim=-1),
                      iterations=iteration, reason=reason)
