"""The GLM objective over a block of independent lanes (one per entity).

The batched form of ``ops/objective.py``'s ``GLMObjective`` bound to one
entity bucket: where the JAX package maps the single-problem objective over
the entity axis with ``jax.vmap``, the port writes the leading ``[lanes]``
axis out. Value, gradient, Hessian and Hessian diagonal are the closed forms
of ``ops/objective.py`` under the same normalization algebra, lane by lane.
The lane solvers call plain tensor operations only (no hand-written kernel:
the JAX package keeps its kernel off every mapped solve too).
"""

from __future__ import annotations

import torch

from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization


class LaneObjective:
    """Sum_c ws[l, c] * loss(margin[l, c], y[l, c]) + (l2/2) ‖w[l]‖² for
    every lane l, over features [lanes, cap, k] and labels/offsets/weights
    [lanes, cap]; weight 0 marks a padding slot."""

    def __init__(self, loss: PointwiseLoss, features, labels, offsets, weights, *,
                 l2_weight: float = 0.0, normalization: NormalizationContext | None = None):
        self.loss = loss
        self.l2_weight = float(l2_weight)
        self.normalization = normalization if normalization is not None else no_normalization()
        self.features = features.to(labels.dtype)
        self.labels, self.offsets, self.weights = labels, offsets, weights
        self._normalized = None

    def margins(self, w: torch.Tensor) -> torch.Tensor:
        """[lanes, cap] for w [lanes, k], or [lanes, a, cap] for step
        candidates w [lanes, a, k]."""
        norm = self.normalization
        eff = w if norm.factors is None else w * norm.factors
        if w.dim() == 3:
            m = torch.einsum("lck,lak->lac", self.features, eff) + self.offsets.unsqueeze(1)
        else:
            m = torch.einsum("lck,lk->lc", self.features, eff) + self.offsets
        if norm.shifts is not None:
            m = m - (eff @ norm.shifts).unsqueeze(-1)
        return m

    def _l2(self, w: torch.Tensor) -> torch.Tensor:
        return 0.5 * self.l2_weight * torch.sum(w * w, dim=-1)

    def value(self, w: torch.Tensor) -> torch.Tensor:
        """[lanes] values, or [lanes, a] for candidates [lanes, a, k] (one
        pass: the candidates share every feature read)."""
        m = self.margins(w)
        labels, weights = self.labels, self.weights
        if w.dim() == 3:
            labels, weights = labels.unsqueeze(1), weights.unsqueeze(1)
        total = torch.sum(weights * self.loss.loss(m, labels), dim=-1)
        return total + self._l2(w) if self.l2_weight > 0.0 else total

    def value_and_grad(self, w: torch.Tensor):
        norm = self.normalization
        l, dz = self.loss.loss_and_dz(self.margins(w), self.labels)
        r = self.weights * dz
        value = torch.sum(self.weights * l, dim=-1)
        grad = torch.einsum("lc,lck->lk", r, self.features)
        if norm.shifts is not None:
            grad = grad - torch.sum(r, dim=-1, keepdim=True) * norm.shifts
        if norm.factors is not None:
            grad = grad * norm.factors
        if self.l2_weight > 0.0:
            value = value + self._l2(w)
            grad = grad + self.l2_weight * w
        return value, grad

    def _normalized_features(self) -> torch.Tensor:
        """X' = (X - shifts) * factors, built once per bucket binding."""
        if self._normalized is None:
            x, norm = self.features, self.normalization
            if norm.factors is not None:
                x = x * norm.factors
            if norm.shifts is not None:
                x = x - norm.shifts * (norm.factors if norm.factors is not None else 1.0)
            self._normalized = x
        return self._normalized

    def _curvature(self, w: torch.Tensor) -> torch.Tensor:
        return self.loss.d2z(self.margins(w), self.labels) * self.weights

    def hessian_matrix(self, w: torch.Tensor) -> torch.Tensor:
        """[lanes, k, k]: X'ᵀ D X' + l2·I per lane."""
        x = self._normalized_features()
        h = torch.einsum("lck,lc,lcj->lkj", x, self._curvature(w), x)
        if self.l2_weight > 0.0:
            h = h + self.l2_weight * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
        return h

    def hessian_vector_at(self, w: torch.Tensor):
        """The per-lane Hessian-vector product at w, v [lanes, k] ->
        X'ᵀ D X' v + l2·v [lanes, k], with D computed once for every
        product at this w (TRON's CG makes many)."""
        x, curvature = self._normalized_features(), self._curvature(w)

        def hv(v: torch.Tensor) -> torch.Tensor:
            out = torch.einsum("lc,lck->lk", curvature * torch.einsum("lck,lk->lc", x, v), x)
            return out + self.l2_weight * v if self.l2_weight > 0.0 else out

        return hv

    def hessian_diagonal(self, w: torch.Tensor) -> torch.Tensor:
        x = self._normalized_features()
        diag = torch.einsum("lc,lck,lck->lk", self._curvature(w), x, x)
        return diag + self.l2_weight if self.l2_weight > 0.0 else diag
