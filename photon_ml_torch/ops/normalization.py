"""Feature normalization folded into the objective algebra.

Counterpart of ``photon_ml_tpu/ops/normalization.py``; reference photon-lib
function/glm/ValueAndGradientAggregator.scala:36-49 (effectiveCoefficients +
marginShift) and normalization/NormalizationContext.scala.

The data is never rewritten: with x' = (x - shift) * factor,

    margin = w . x' = (w * factor) . x  -  (w * factor) . shift

so normalization is two elementwise operations on the coefficient vector
and the feature block stays untouched. The intercept coordinate is exempt
(factor 1, shift 0).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch


class NormalizationType(enum.Enum):
    """Reference: photon-lib normalization/NormalizationType.scala:26-41."""

    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"


def _require_intercept(intercept_index):
    if intercept_index is None:
        raise ValueError(
            "Normalization with shifts (STANDARDIZATION) requires an "
            "intercept column to absorb the margin shift"
        )


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Per-feature factors and shifts: [dim] tensors, or None for identity."""

    factors: torch.Tensor | None = None
    shifts: torch.Tensor | None = None

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def effective_coefficients(self, coefficients: torch.Tensor) -> torch.Tensor:
        if self.factors is None:
            return coefficients
        return coefficients * self.factors

    def margin_shift(self, effective_coefficients: torch.Tensor) -> torch.Tensor:
        """The constant subtracted from every margin: (w*factor) . shift."""
        if self.shifts is None:
            return torch.zeros((), dtype=effective_coefficients.dtype,
                               device=effective_coefficients.device)
        return torch.dot(effective_coefficients, self.shifts)

    def to_model_space(self, coefficients: torch.Tensor,
                       intercept_index: int | None = None) -> torch.Tensor:
        """Map coefficients trained in normalized space to original space:
        w = w'*factor, with -(w'*factor).shift absorbed into the intercept
        (reference NormalizationContext modelToOriginalSpace)."""
        if self.is_identity:
            return coefficients
        eff = coefficients * self.factors if self.factors is not None else coefficients.clone()
        if self.shifts is not None:
            _require_intercept(intercept_index)
            shift_total = eff @ self.shifts
            eff[..., intercept_index] -= shift_total
        return eff

    def from_model_space(self, coefficients: torch.Tensor,
                         intercept_index: int | None = None) -> torch.Tensor:
        """Inverse of ``to_model_space``: warm-start a normalized-space solve
        from an original-space model."""
        if self.is_identity:
            return coefficients
        w = coefficients.clone()
        if self.shifts is not None:
            _require_intercept(intercept_index)
            # eff_j = w_j off the intercept (its shift is 0), so the
            # intercept recovers as w_int + sum_j w_j * shift_j
            w[..., intercept_index] += coefficients @ self.shifts
        if self.factors is not None:
            w = w / self.factors
        return w

    def variances_to_model_space(self, variances: torch.Tensor) -> torch.Tensor:
        """Diagonal-approximation variance scaling: var(w_i) = var(w'_i)·f_i²."""
        if self.factors is None:
            return variances
        return variances * self.factors * self.factors

    # -- compact ([E, K] active-column) table variants -----------------------
    # Compact coordinates store per-entity tables over active_cols [E, K]
    # (pad = dim); the [dim] factor vector is gathered per slot. SCALE-only:
    # mean shifts would densify a sparse shard.

    def _compact_factors(self, active_cols: torch.Tensor) -> torch.Tensor:
        fac = torch.cat([self.factors, self.factors.new_ones(1)])
        # the pad slot (col == dim) keeps factor 1
        return fac[torch.clamp(active_cols.long(), max=self.factors.shape[0])]

    def _check_compact(self):
        if self.shifts is not None:
            raise ValueError(
                "compact (sparse-shard) coordinates support SCALE-only "
                "normalization; mean shifts (STANDARDIZATION) would densify "
                "the feature space"
            )

    def to_model_space_compact(self, table: torch.Tensor,
                               active_cols: torch.Tensor) -> torch.Tensor:
        self._check_compact()
        if self.factors is None:
            return table
        return table * self._compact_factors(active_cols)

    def from_model_space_compact(self, table: torch.Tensor,
                                 active_cols: torch.Tensor) -> torch.Tensor:
        self._check_compact()
        if self.factors is None:
            return table
        return table / self._compact_factors(active_cols)

    def variances_to_model_space_compact(self, variances: torch.Tensor,
                                         active_cols: torch.Tensor) -> torch.Tensor:
        self._check_compact()
        if self.factors is None:
            return variances
        f = self._compact_factors(active_cols)
        return variances * f * f


def host_factors(ctx: NormalizationContext) -> np.ndarray | None:
    """Host copy of ``ctx.factors`` (None when identity), for the builders
    that rewrite projected entity blocks into normalized space."""
    return None if ctx.factors is None else ctx.factors.detach().cpu().numpy()


def host_shifts(ctx: NormalizationContext) -> np.ndarray | None:
    """Host copy of ``ctx.shifts`` (None when there are none)."""
    return None if ctx.shifts is None else ctx.shifts.detach().cpu().numpy()


_NO_NORMALIZATION = NormalizationContext(factors=None, shifts=None)


def no_normalization() -> NormalizationContext:
    """The identity context."""
    return _NO_NORMALIZATION


def build_normalization(
    norm_type: NormalizationType,
    *,
    mean: torch.Tensor,
    variance: torch.Tensor,
    max_magnitude: torch.Tensor,
    intercept_index: int | None = None,
) -> NormalizationContext:
    """Build a NormalizationContext from feature summary statistics, on the
    statistics' device.

    Reference: NormalizationContext.apply over BasicStatisticalSummary. Zero
    std / zero magnitude features get factor 1, so constant columns are
    left alone.
    """
    if norm_type == NormalizationType.NONE:
        return no_normalization()

    one = torch.ones_like(variance)
    std = torch.sqrt(variance)
    inv_std = torch.where(std > 0.0, 1.0 / torch.clamp(std, min=1e-30), one)
    inv_mag = torch.where(max_magnitude > 0.0,
                          1.0 / torch.clamp(max_magnitude, min=1e-30), one)

    if norm_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
        factors, shifts = inv_std, None
    elif norm_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
        factors, shifts = inv_mag, None
    elif norm_type == NormalizationType.STANDARDIZATION:
        factors, shifts = inv_std, mean.clone()
    else:  # pragma: no cover
        raise ValueError(f"Unknown normalization type {norm_type}")

    if intercept_index is not None:
        factors[intercept_index] = 1.0
        if shifts is not None:
            shifts[intercept_index] = 0.0
    return NormalizationContext(factors=factors, shifts=shifts)
