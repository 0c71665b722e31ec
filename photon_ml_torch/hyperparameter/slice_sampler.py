"""Univariate-step slice sampler (reference photon-lib
hyperparameter/SliceSampler.scala — Neal 2003, stepping-out + shrinkage),
used to sample GP kernel hyperparameters from their posterior.

The port's own copy of ``photon_ml_tpu/hyperparameter/slice_sampler.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def _sample_dim(
    log_prob: Callable[[np.ndarray], float],
    x: np.ndarray,
    logp_x: float,
    dim: int,
    rng: np.random.Generator,
    width: float,
    max_steps: int,
) -> tuple[np.ndarray, float]:
    """One stepping-out + shrinkage slice-sampling update of x[dim].

    ``logp_x`` is log_prob(x), threaded through so the (expensive) current
    point density is never recomputed. Returns (new_x, log_prob(new_x)).
    """
    y = logp_x + np.log(rng.uniform(1e-300, 1.0))

    lower = x.copy()
    upper = x.copy()
    offset = rng.uniform()
    lower[dim] -= offset * width
    upper[dim] += (1.0 - offset) * width

    for _ in range(max_steps):
        if log_prob(lower) <= y:
            break
        lower[dim] -= width
    for _ in range(max_steps):
        if log_prob(upper) <= y:
            break
        upper[dim] += width

    for _ in range(100):
        candidate = x.copy()
        candidate[dim] = rng.uniform(lower[dim], upper[dim])
        logp_candidate = log_prob(candidate)
        if logp_candidate > y:
            return candidate, logp_candidate
        # shrink
        if candidate[dim] < x[dim]:
            lower[dim] = candidate[dim]
        else:
            upper[dim] = candidate[dim]
    return x, logp_x  # degenerate slice; keep the current point


def slice_sample(
    log_prob: Callable[[np.ndarray], float],
    x0: np.ndarray,
    rng: np.random.Generator,
    *,
    num_samples: int = 1,
    burn_in: int = 0,
    width: float = 1.0,
    max_step_out: int = 32,
) -> np.ndarray:
    """Draw ``num_samples`` points from ``exp(log_prob)`` starting at x0.

    Coordinates are updated one at a time (random scan), matching the
    reference's per-dimension sampling. Returns [num_samples, d].
    """
    x = np.array(x0, dtype=np.float64, copy=True)
    logp = log_prob(x)
    d = x.shape[0]
    out = np.empty((num_samples, d))
    total = burn_in + num_samples
    for i in range(total):
        for dim in rng.permutation(d):
            x, logp = _sample_dim(log_prob, x, logp, int(dim), rng, width, max_step_out)
        if i >= burn_in:
            out[i - burn_in] = x
    return out
