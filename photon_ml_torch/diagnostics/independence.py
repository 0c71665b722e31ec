"""Prediction-error independence analysis, Kendall's tau (the port's own
copy).

Counterpart of ``photon_ml_tpu/diagnostics/independence.py``; reference
photon-diagnostics diagnostics/independence/ — rank correlation between
prediction errors and predictions; a significant correlation is structure
the model missed. Host numpy and scipy over host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.stats import kendalltau


@dataclasses.dataclass
class IndependenceReport:
    tau: float
    p_value: float
    num_samples: int

    @property
    def independent(self) -> bool:
        """p > 0.05: no evidence of dependence."""
        return self.p_value > 0.05


def kendall_tau_independence(
    scores: np.ndarray,
    labels: np.ndarray,
    *,
    max_samples: int = 5000,
    seed: int = 0,
) -> IndependenceReport:
    """Kendall tau between predictions and their errors. Subsampled above
    ``max_samples`` (tau is O(n²) pairs; the reference subsamples too)."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels, dtype=np.float64).ravel()
    n = len(scores)
    if n > max_samples:
        sel = np.random.default_rng(seed).choice(n, size=max_samples, replace=False)
        scores, labels = scores[sel], labels[sel]
    errors = labels - scores
    tau, p = kendalltau(scores, errors)
    return IndependenceReport(
        tau=float(tau), p_value=float(p), num_samples=len(scores)
    )
