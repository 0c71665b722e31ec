"""Hosmer-Lemeshow calibration test for logistic models (the port's own
copy).

Counterpart of ``photon_ml_tpu/diagnostics/hosmer_lemeshow.py``; reference
photon-diagnostics diagnostics/hl/ — bin scored samples by predicted
probability into deciles, compare observed and expected positives per bin,
a chi-square statistic with (bins - 2) degrees of freedom, plus the per-bin
table the report renders. Host numpy and scipy over host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.stats import chi2


@dataclasses.dataclass(frozen=True)
class HosmerLemeshowBin:
    lower: float
    upper: float
    count: float
    observed_positives: float
    expected_positives: float


@dataclasses.dataclass
class HosmerLemeshowReport:
    bins: list[HosmerLemeshowBin]
    chi_square: float
    degrees_of_freedom: int
    p_value: float

    @property
    def well_calibrated(self) -> bool:
        """p > 0.05: no evidence of miscalibration."""
        return self.p_value > 0.05


def hosmer_lemeshow(
    scores: np.ndarray,
    labels: np.ndarray,
    weights: np.ndarray | None = None,
    *,
    num_bins: int = 10,
    scores_are_probabilities: bool = False,
) -> HosmerLemeshowReport:
    """HL test. ``scores`` are margins unless ``scores_are_probabilities``."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    weights = (
        np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)
    )
    probs = scores if scores_are_probabilities else 1.0 / (1.0 + np.exp(-scores))

    # equal-count (decile) bin edges on the predicted probabilities
    quantiles = np.quantile(probs, np.linspace(0.0, 1.0, num_bins + 1))
    quantiles[0], quantiles[-1] = 0.0, 1.0
    edges = np.unique(quantiles)
    bin_idx = np.clip(np.searchsorted(edges, probs, side="right") - 1, 0, len(edges) - 2)

    bins = []
    chi_sq = 0.0
    for b in range(len(edges) - 1):
        sel = bin_idx == b
        w = weights[sel]
        count = float(w.sum())
        observed = float((w * labels[sel]).sum())
        expected = float((w * probs[sel]).sum())
        bins.append(
            HosmerLemeshowBin(
                lower=float(edges[b]),
                upper=float(edges[b + 1]),
                count=count,
                observed_positives=observed,
                expected_positives=expected,
            )
        )
        if count > 0:
            variance = max(expected * (1.0 - expected / count), 1e-12)
            chi_sq += (observed - expected) ** 2 / variance

    dof = max(len(bins) - 2, 1)
    return HosmerLemeshowReport(
        bins=bins,
        chi_square=chi_sq,
        degrees_of_freedom=dof,
        p_value=float(chi2.sf(chi_sq, dof)),
    )
