"""Coefficient-variance estimation for trained GLMs.

Counterpart of ``photon_ml_tpu/ops/variance.py``; reference photon-api
optimization/DistributedOptimizationProblem.scala:82-96 and
SingleNodeOptimizationProblem.scala:58-69 (computeVariances: the full
Hessian at the optimum, diag(H⁻¹) by Cholesky inverse, photon-lib
util/Linalg.scala choleskyInverse).

H = LLᵀ gives diag(H⁻¹)ᵢ = Σⱼ (L⁻¹)ⱼᵢ², one triangular solve against I:
O(d³) work and O(d²) memory, so "full" is gated to small d. Above
``FULL_VARIANCE_MAX_DIM`` the "auto" mode takes the diagonal approximation
1/diag(H), the only option for a sparse objective, whose Hessian is never
materialized.

``torch.linalg.cholesky`` raises on a matrix that is not positive definite,
where ``jnp.linalg.cholesky`` returns NaN; the port factors with
``cholesky_ex`` and keeps the JAX package's guard: non-finite entries fall
back to the clamped diagonal approximation.
"""

from __future__ import annotations

import torch

#: "auto" uses the full Cholesky inverse up to this many coefficients
#: (a d² Hessian of 64 MB in f32 at the boundary), the diagonal beyond
FULL_VARIANCE_MAX_DIM = 4096

_MODES = ("auto", "full", "diagonal")


def validate_variance_mode(mode: str) -> str:
    """Fail fast on typos, before any solve."""
    if mode not in _MODES:
        raise ValueError(f"variance mode must be one of {_MODES}, got {mode!r}")
    return mode


def resolve_variance_mode(mode: str, dim: int, num_problems: int = 1) -> str:
    """Resolve "auto" to a concrete mode; ``num_problems`` d×d Hessians
    materialize at once and share the budget."""
    validate_variance_mode(mode)
    if mode == "auto":
        budget = FULL_VARIANCE_MAX_DIM * FULL_VARIANCE_MAX_DIM
        return "full" if num_problems * dim * dim <= budget else "diagonal"
    return mode


def resolve_variance_mode_for(objective, mode: str, dim: int, num_problems: int = 1) -> str:
    """Like :func:`resolve_variance_mode`, for an objective that may not
    materialize a dense Hessian (no ``hessian_matrix``): "auto" falls back
    to the diagonal, an explicit "full" raises."""
    resolved = resolve_variance_mode(mode, dim, num_problems)
    if resolved == "full" and not hasattr(objective, "hessian_matrix"):
        if mode == "full":
            raise ValueError(
                "variance_mode='full' requires a dense Hessian; this "
                f"objective ({type(objective).__name__}) only supports the "
                "diagonal approximation"
            )
        resolved = "diagonal"
    return resolved


def inverse_of_diagonal(diag: torch.Tensor) -> torch.Tensor:
    """The diagonal approximation's clamped inverse."""
    return 1.0 / torch.clamp(diag, min=1e-12)


def _inverse_cholesky_factor(h: torch.Tensor) -> torch.Tensor:
    """L⁻¹ for H = LLᵀ ([..., d, d], batched over leading axes); NaN in
    every matrix whose factorization failed (H not positive definite), as
    ``jnp.linalg.cholesky`` gives."""
    chol, info = torch.linalg.cholesky_ex(h)
    chol = torch.where((info != 0)[..., None, None], float("nan"), chol)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    return torch.linalg.solve_triangular(chol, eye.expand_as(h), upper=False)


def diag_inverse_from_hessian(h: torch.Tensor) -> torch.Tensor:
    """diag(H⁻¹) via Cholesky without forming H⁻¹, for one [d, d] Hessian
    or a stack [..., d, d]. Entries that come out non-finite (H not positive
    definite: λ=0 with collinear features) fall back elementwise to the
    clamped 1/diag(H)."""
    linv = _inverse_cholesky_factor(h)
    full = torch.sum(linv * linv, dim=-2)
    approx = inverse_of_diagonal(torch.diagonal(h, dim1=-2, dim2=-1))
    return torch.where(torch.isfinite(full), full, approx)


def full_inverse_from_hessian(h: torch.Tensor) -> torch.Tensor:
    """Full H⁻¹ via Cholesky, for one [d, d] Hessian or a stack
    [..., d, d] (the propagation of a variance through a projection needs
    the off-diagonal entries); a non-PD H falls back to the clamped
    diagonal-only inverse as a whole."""
    linv = _inverse_cholesky_factor(h)
    full = linv.mT @ linv
    approx = torch.diag_embed(inverse_of_diagonal(torch.diagonal(h, dim1=-2, dim2=-1)))
    finite = torch.isfinite(full).flatten(-2).all(dim=-1)
    return torch.where(finite[..., None, None], full, approx)


def coefficient_variances(objective, coefficients: torch.Tensor, batch,
                          mode: str = "auto") -> torch.Tensor:
    """Per-coefficient variances at the optimum, in the objective's space.

    mode: "full" = diag(H⁻¹) (H positive definite, guaranteed with
    l2_weight > 0); "diagonal" = 1/diag(H); "auto" picks by dimension.
    """
    resolved = resolve_variance_mode_for(objective, mode, int(coefficients.shape[-1]))
    if resolved == "full":
        return diag_inverse_from_hessian(objective.hessian_matrix(coefficients, batch))
    return inverse_of_diagonal(objective.hessian_diagonal(coefficients, batch))
