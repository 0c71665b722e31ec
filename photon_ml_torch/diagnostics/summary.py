"""Per-coefficient distribution summary (the port's own copy).

Counterpart of ``photon_ml_tpu/diagnostics/summary.py``; reference
photon-diagnostics supervised/model/CoefficientSummary.scala — min/max/mean/
std and quartile estimates of one coefficient across bootstrap retrains.
Host numpy over host samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CoefficientSummary:
    min: float
    q1: float
    median: float
    q3: float
    max: float
    mean: float
    std: float

    @classmethod
    def from_samples(cls, samples: np.ndarray) -> "CoefficientSummary":
        samples = np.asarray(samples, dtype=np.float64)
        q1, med, q3 = np.percentile(samples, [25, 50, 75])
        return cls(
            min=float(samples.min()),
            q1=float(q1),
            median=float(med),
            q3=float(q3),
            max=float(samples.max()),
            mean=float(samples.mean()),
            std=float(samples.std()),
        )

    def straddles_zero(self) -> bool:
        """True if the IQR contains 0 — the bootstrap instability signal the
        reference's report flags."""
        return self.q1 <= 0.0 <= self.q3
