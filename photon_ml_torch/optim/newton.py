"""Damped Newton (IRLS) with an explicit Cholesky solve, lane-batched: the
solver of the small dense per-entity problems.

Counterpart of ``photon_ml_tpu/optim/newton.py`` (``minimize_newton`` under
``jax.vmap``); no analogue in the reference, whose per-entity solves use the
iterative L-BFGS/TRON family. Per iteration and lane: one Hessian, one
positive-definite solve, one fixed five-point step-shrink evaluated in a
single batched value pass (the candidates share every feature read), one
gradient pass. For the squared loss a full step is exact.

The JAX package solves the damped system by unpivoted Gauss-Jordan
elimination because batched decompositions serialize on its hardware; here
it is one batched ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``.
:func:`solve_pd_gauss_jordan` keeps the elimination as the plain yardstick
the Cholesky solve is held against.

Every state field carries a leading ``[lanes]`` axis; a finished lane is
frozen by ``torch.where`` and the loop ends when every lane is done (one
host read per iteration).
"""

from __future__ import annotations

from typing import Callable

import torch

from photon_ml_torch.optim.common import ConvergenceReason, LaneResult, any_lane

#: fixed step candidates: the current point (the baseline every accept and
#: convergence decision compares against, through the same value path), a
#: full Newton step and three shrinks. A step that overshoots beyond the 16x
#: range is handled by the Levenberg damping, not by more candidates.
_ALPHAS = (0.0, 1.0, 0.5, 0.25, 0.0625)

_NOT_CONVERGED = int(ConvergenceReason.NOT_CONVERGED)


def solve_pd(h: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve H p = g for batched positive-definite H [..., d, d] by Cholesky.
    Returns (p, ok): ``ok`` is False where the factorization met a
    non-positive pivot or the solution is not finite."""
    factor, info = torch.linalg.cholesky_ex(h)
    p = torch.cholesky_solve(g.unsqueeze(-1), factor).squeeze(-1)
    return p, (info == 0) & torch.isfinite(p).all(dim=-1)


def solve_pd_gauss_jordan(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The same solve by unpivoted Gauss-Jordan elimination over the
    columns, vectorized over the batch dims (the JAX package's ``_solve_pd``)."""
    d = h.shape[-1]
    a = torch.cat([h, g.unsqueeze(-1)], dim=-1)  # [..., d, d+1]
    for i in range(d):
        piv = a[..., i, :] / a[..., i, i].unsqueeze(-1)
        factors = a[..., :, i]
        a = a - factors.unsqueeze(-1) * piv.unsqueeze(-2)
        a[..., i, :] = piv
    return a[..., :, d]


def minimize_newton(
    value_and_grad_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    hessian_matrix_fn: Callable[[torch.Tensor], torch.Tensor],
    w0: torch.Tensor,
    *,
    value_fn: Callable[[torch.Tensor], torch.Tensor],
    max_iter: int = 15,
    tolerance: float = 1e-7,
    rel_function_tolerance: float | None = None,
) -> LaneResult:
    """Minimize ``lanes`` twice-differentiable convex objectives by damped
    Newton (Levenberg-Marquardt safeguarded).

    ``w0`` is [lanes, d]. ``value_and_grad_fn`` maps [lanes, d] to
    ([lanes], [lanes, d]); ``hessian_matrix_fn`` to the [lanes, d, d]
    Hessians including any regularizer; ``value_fn`` maps step candidates
    [lanes, a, d] to [lanes, a] values in one pass.

    A lane converges when ‖g‖ <= tolerance * max(‖g0‖, 1) or on a clean
    accepted round whose best step changes the value by <= the function
    tolerance, relative. A round where even the 16x-shrunk step fails to
    improve grows the damping x64 and retries; an accepted round decays it
    x0.25.
    """
    dtype, device = w0.dtype, w0.device
    lanes, d = w0.shape
    w = w0
    f, g = value_and_grad_fn(w)
    g0_norm = torch.linalg.norm(g, dim=-1)
    alphas = torch.tensor(_ALPHAS, dtype=dtype, device=device)
    ftol = tolerance if rel_function_tolerance is None else rel_function_tolerance
    eye = torch.eye(d, dtype=dtype, device=device)
    damping = torch.zeros((lanes,), dtype=dtype, device=device)
    iteration = torch.zeros((lanes,), dtype=torch.int32, device=device)
    # a warm start may arrive stationary: stop before the first solve
    reason = torch.where(g0_norm <= tolerance,
                         int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
                         _NOT_CONVERGED).to(torch.int32)
    col = lambda v: v.unsqueeze(-1)  # noqa: E731

    for _ in range(max_iter):
        active = (iteration < max_iter) & (reason == _NOT_CONVERGED)
        if not any_lane(active):
            break
        h = hessian_matrix_fn(w)
        # trace-scaled Levenberg jitter plus the adaptive damping; the scale
        # is floored so the damping still regularizes a zero-trace Hessian
        scale = torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1).sum(-1) / d, min=1e-12)
        jitter = (1e-7 + damping) * scale + 1e-30
        p, ok = solve_pd(h + jitter[:, None, None] * eye, g)
        # degenerate Hessian (only on non-finite input): steepest descent
        # scaled by the largest curvature
        fallback = -g / col(torch.clamp(torch.diagonal(h, dim1=-2, dim2=-1).amax(-1), min=1e-12))
        p = torch.where(col(ok), -p, fallback)

        vals = value_fn(w.unsqueeze(1) + alphas[None, :, None] * p.unsqueeze(1))
        vals = torch.where(torch.isfinite(vals), vals, float("inf"))
        best = torch.argmin(vals[:, 1:], dim=1) + 1  # best nonzero step
        val_best = vals.gather(1, col(best)).squeeze(1)
        improved = val_best < vals[:, 0]
        f_delta_small = torch.abs(vals[:, 0] - val_best) <= ftol * (torch.abs(vals[:, 0]) + 1e-30)
        w_new = torch.where(col(improved), w + col(alphas[best]) * p, w)
        # a rejected round keeps its point, whose value and gradient it holds
        f_eval, g_eval = value_and_grad_fn(w_new)
        f_new = torch.where(improved, f_eval, f)
        g_new = torch.where(col(improved), g_eval, g)
        new_damping = torch.where(improved, damping * 0.25,
                                  torch.clamp(damping * 64.0, min=1e-6))
        gnorm = torch.linalg.norm(g_new, dim=-1)
        # converged only on a clean accepted flat round: heavy damping makes
        # steps artificially small, and a rejected flat round takes one
        # damped retry first
        flat_round = f_delta_small & improved & (damping <= 1e-3)
        new_reason = torch.where(
            gnorm <= tolerance * torch.clamp(g0_norm, min=1.0),
            int(ConvergenceReason.GRADIENT_WITHIN_TOLERANCE),
            torch.where(flat_round, int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE),
                        _NOT_CONVERGED)).to(torch.int32)
        w = torch.where(col(active), w_new, w)
        f = torch.where(active, f_new, f)
        g = torch.where(col(active), g_new, g)
        damping = torch.where(active, new_damping, damping)
        reason = torch.where(active, new_reason, reason)
        iteration = iteration + active.to(torch.int32)

    reason = torch.where(reason == _NOT_CONVERGED, int(ConvergenceReason.MAX_ITERATIONS),
                         reason).to(torch.int32)
    return LaneResult(coefficients=w, value=f, gradient_norm=torch.linalg.norm(g, dim=-1),
                      iterations=iteration, reason=reason)
