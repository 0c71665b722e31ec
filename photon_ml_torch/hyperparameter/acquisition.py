"""Acquisition functions for Bayesian hyperparameter search.

Reference parity: photon-lib hyperparameter/criteria/
ExpectedImprovement.scala and ConfidenceBound.scala. Both are phrased for
*minimization* (the searcher negates metrics whose direction is
maximize-is-better, matching the reference's betterThan handling).

The port's own copy of ``photon_ml_tpu/hyperparameter/acquisition.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import norm


def expected_improvement(
    mean: np.ndarray, variance: np.ndarray, best_value: float, xi: float = 0.0
) -> np.ndarray:
    """EI(x) = E[max(best − f(x) − ξ, 0)] under f(x) ~ N(mean, variance)."""
    std = np.sqrt(np.maximum(variance, 1e-18))
    improvement = best_value - mean - xi
    z = improvement / std
    return improvement * norm.cdf(z) + std * norm.pdf(z)


def confidence_bound(
    mean: np.ndarray, variance: np.ndarray, beta: float = 2.0
) -> np.ndarray:
    """Lower confidence bound, returned as a to-maximize score:
    −(mean − β·std), so argmax picks the most optimistic minimizer."""
    std = np.sqrt(np.maximum(variance, 1e-18))
    return -(mean - beta * std)
