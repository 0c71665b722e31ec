"""Deterministic down-sampling as a weight transform (host numpy; the
port's own copy).

Counterpart of ``photon_ml_tpu/sampling/down_sampler.py``; reference
photon-lib sampling/DownSampler.scala, DefaultDownSampler.scala (uniform
sample of all rows, no reweighting) and
BinaryClassificationDownSampler.scala:31-68 (keep every positive, thin
negatives at ``rate`` and rescale their weights by 1/rate).

Down-sampling zeroes weights instead of dropping rows: a zero-weight sample
contributes nothing to any weighted aggregate, and the batch keeps its
shape. Selection is keyed on stable sample ids through a splitmix64 hash,
so the same (ids, seed) always selects the same rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from photon_ml_torch.types import TaskType

_U64 = np.uint64


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: uint64 -> well-mixed uint64."""
    x = x.astype(_U64)
    with np.errstate(over="ignore"):
        x = (x + _U64(0x9E3779B97F4A7C15)) & _U64(0xFFFFFFFFFFFFFFFF)
        x = ((x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)) & _U64(0xFFFFFFFFFFFFFFFF)
        x = ((x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)) & _U64(0xFFFFFFFFFFFFFFFF)
        x = x ^ (x >> _U64(31))
    return x


def stable_uniform(unique_ids: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic per-sample uniform in [0, 1) keyed on (id, seed)."""
    ids = np.asarray(unique_ids).astype(np.int64).view(_U64)
    seed_key = _splitmix64(np.asarray([seed], dtype=np.int64).view(_U64))[0]
    mixed = _splitmix64(ids ^ seed_key)
    return (mixed >> _U64(11)).astype(np.float64) * (1.0 / float(1 << 53))


@dataclasses.dataclass(frozen=True)
class DownSampler:
    """Base: subclasses map (labels, weights, ids) to new weights with
    dropped rows at 0."""

    down_sampling_rate: float

    def __post_init__(self):
        if not (0.0 < self.down_sampling_rate < 1.0):
            raise ValueError(
                f"down-sampling rate must be in (0, 1), got {self.down_sampling_rate}"
            )

    def down_sample_weights(
        self, labels: np.ndarray, weights: np.ndarray, unique_ids: np.ndarray, seed: int = 0
    ) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class DefaultDownSampler(DownSampler):
    """Uniform sampling of all rows with weights left untouched (the
    reference's DefaultDownSampler is a plain sample with no reweighting)."""

    def down_sample_weights(self, labels, weights, unique_ids, seed: int = 0) -> np.ndarray:
        weights = np.asarray(weights, dtype=np.float64)
        keep = stable_uniform(unique_ids, seed) < self.down_sampling_rate
        return np.where(keep, weights, 0.0)


@dataclasses.dataclass(frozen=True)
class BinaryClassificationDownSampler(DownSampler):
    """Keep all positives; sample negatives at ``rate`` with weights
    rescaled by 1/rate."""

    def down_sample_weights(self, labels, weights, unique_ids, seed: int = 0) -> np.ndarray:
        labels = np.asarray(labels, dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        positive = labels > 0.5
        keep_neg = stable_uniform(unique_ids, seed) < self.down_sampling_rate
        return np.where(
            positive,
            weights,
            np.where(keep_neg, weights / self.down_sampling_rate, 0.0),
        )


def down_sampler_for_task(task: TaskType, rate: float) -> DownSampler:
    """Classification tasks thin only negatives; regression tasks sample
    uniformly (reference DownSamplerHelper)."""
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        return BinaryClassificationDownSampler(rate)
    return DefaultDownSampler(rate)
