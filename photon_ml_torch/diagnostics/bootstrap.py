"""Bootstrap diagnostics: retrain on resamples, aggregate distributions
(the port's own copy).

Counterpart of ``photon_ml_tpu/diagnostics/bootstrap.py``; reference
photon-diagnostics BootstrapTraining.scala — k sample-with-replacement
retrains aggregated into per-coefficient distributions (CoefficientSummary)
and per-metric distributions (diagnostics/bootstrap/BootstrapReport.scala).

A resample is a weight transform: a multinomial draw of counts over the
samples, from ``np.random.default_rng(seed)`` exactly as in the JAX
package, becomes the batch's weight vector on its device, so every retrain
runs the same solver on the same shapes and both packages refit on the same
weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.diagnostics.metrics import evaluate_model
from photon_ml_torch.diagnostics.summary import CoefficientSummary
from photon_ml_torch.models.glm import GeneralizedLinearModel

TrainFn = Callable[[LabeledPointBatch], GeneralizedLinearModel]


@dataclasses.dataclass
class BootstrapReport:
    coefficient_summaries: list[CoefficientSummary]
    metric_distributions: dict[str, CoefficientSummary]
    num_samples: int

    @property
    def unstable_coefficients(self) -> list[int]:
        """Indices whose IQR straddles zero (the reference report's
        'coefficients indistinguishable from 0' table)."""
        return [j for j, s in enumerate(self.coefficient_summaries) if s.straddles_zero()]


def reweighted(batch: LabeledPointBatch, weights: np.ndarray) -> LabeledPointBatch:
    """``batch`` with host ``weights`` in place of its own, on its device
    and in its weights' dtype."""
    w = torch.as_tensor(weights, device=batch.weights.device).to(batch.weights.dtype)
    return dataclasses.replace(batch, weights=w)


def bootstrap_training(train_fn: TrainFn, batch: LabeledPointBatch,
                       validation_batch: LabeledPointBatch, *, num_bootstraps: int = 10,
                       seed: int = 0) -> BootstrapReport:
    """Run ``num_bootstraps`` weighted-resample retrains."""
    if num_bootstraps < 2:
        raise ValueError("need at least 2 bootstrap rounds")
    rng = np.random.default_rng(seed)
    n = batch.num_samples
    base_weights = batch.weights.cpu().numpy()

    coeffs = []
    metric_rows: list[Mapping[str, float]] = []
    for _ in range(num_bootstraps):
        counts = rng.multinomial(n, np.full(n, 1.0 / n))
        model = train_fn(reweighted(batch, (base_weights * counts).astype(base_weights.dtype)))
        coeffs.append(model.coefficients.means.detach().cpu().numpy())
        metric_rows.append(evaluate_model(model, validation_batch))

    coeff_matrix = np.stack(coeffs)  # [k, d]
    summaries = [CoefficientSummary.from_samples(coeff_matrix[:, j])
                 for j in range(coeff_matrix.shape[1])]
    metric_dists = {name: CoefficientSummary.from_samples(
        np.array([row[name] for row in metric_rows])) for name in metric_rows[0]}
    return BootstrapReport(coefficient_summaries=summaries, metric_distributions=metric_dists,
                           num_samples=num_bootstraps)
