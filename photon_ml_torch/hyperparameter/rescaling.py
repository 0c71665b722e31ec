"""Unit-cube <-> hyperparameter-space rescaling.

Reference parity: photon-client hyperparameter/VectorRescaling.scala —
candidates live in [0,1]^d for the searchers; each dimension maps to a real
range, linearly or log-scale (regularization weights are log-scale), with
optional discrete snapping.

The port's own copy of ``photon_ml_tpu/hyperparameter/rescaling.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DimensionSpec:
    name: str
    low: float
    high: float
    log_scale: bool = False
    discrete: bool = False

    def __post_init__(self):
        if not self.high > self.low:
            raise ValueError(f"{self.name}: need high > low, got [{self.low}, {self.high}]")
        if self.log_scale and self.low <= 0:
            raise ValueError(f"{self.name}: log-scale needs low > 0, got {self.low}")


@dataclasses.dataclass(frozen=True)
class VectorRescaling:
    dims: Sequence[DimensionSpec]

    @property
    def dim(self) -> int:
        return len(self.dims)

    def to_hyperparameters(self, unit: np.ndarray) -> np.ndarray:
        """[0,1]^d -> real hyperparameter values."""
        unit = np.asarray(unit, dtype=np.float64)
        out = np.empty_like(unit)
        for i, spec in enumerate(self.dims):
            u = np.clip(unit[..., i], 0.0, 1.0)
            if spec.log_scale:
                lo, hi = np.log(spec.low), np.log(spec.high)
                v = np.exp(lo + u * (hi - lo))
            else:
                v = spec.low + u * (spec.high - spec.low)
            if spec.discrete:
                v = np.round(v)
            out[..., i] = v
        return out

    def to_unit(self, values: np.ndarray) -> np.ndarray:
        """Real hyperparameter values -> [0,1]^d (for seeding priors)."""
        values = np.asarray(values, dtype=np.float64)
        out = np.empty_like(values)
        for i, spec in enumerate(self.dims):
            v = values[..., i]
            if spec.log_scale:
                lo, hi = np.log(spec.low), np.log(spec.high)
                u = (np.log(np.maximum(v, spec.low)) - lo) / (hi - lo)
            else:
                u = (v - spec.low) / (spec.high - spec.low)
            out[..., i] = np.clip(u, 0.0, 1.0)
        return out
