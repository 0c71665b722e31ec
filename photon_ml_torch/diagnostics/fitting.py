"""Fitting (learning-curve) diagnostic (the port's own copy).

Counterpart of ``photon_ml_tpu/diagnostics/fitting.py``; reference
photon-diagnostics diagnostics/fitting/FittingDiagnostic.scala:1-131 —
train on growing portions of the data and record train and held-out
metrics per portion; diverging curves indicate over- or under-fitting.

A portion is a weight mask over the whole batch (a prefix of one shuffled
order drawn from ``np.random.default_rng(seed)``, as in the JAX package),
so every portion runs the same solver on the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.diagnostics.bootstrap import reweighted
from photon_ml_torch.diagnostics.metrics import evaluate_model
from photon_ml_torch.models.glm import GeneralizedLinearModel

TrainFn = Callable[[LabeledPointBatch], GeneralizedLinearModel]

DEFAULT_PORTIONS = (0.125, 0.25, 0.5, 0.75, 1.0)


@dataclasses.dataclass
class FittingReport:
    portions: list[float]
    train_metrics: list[dict[str, float]]
    test_metrics: list[dict[str, float]]

    def metric_curve(self, metric: str) -> tuple[list[float], list[float], list[float]]:
        """(portion, train, test) series for one metric."""
        return (self.portions,
                [m.get(metric, float("nan")) for m in self.train_metrics],
                [m.get(metric, float("nan")) for m in self.test_metrics])


def fitting_diagnostic(train_fn: TrainFn, batch: LabeledPointBatch,
                       validation_batch: LabeledPointBatch, *,
                       portions: Sequence[float] = DEFAULT_PORTIONS,
                       seed: int = 0) -> FittingReport:
    rng = np.random.default_rng(seed)
    n = batch.num_samples
    order = rng.permutation(n)
    base_weights = batch.weights.cpu().numpy()

    train_metrics, test_metrics = [], []
    for portion in portions:
        if not 0.0 < portion <= 1.0:
            raise ValueError(f"portion must be in (0, 1], got {portion}")
        k = max(1, int(round(portion * n)))
        mask = np.zeros(n, dtype=base_weights.dtype)
        mask[order[:k]] = 1.0
        sub = reweighted(batch, base_weights * mask)
        model = train_fn(sub)
        train_metrics.append(evaluate_model(model, sub))
        test_metrics.append(evaluate_model(model, validation_batch))
    return FittingReport(portions=list(portions), train_metrics=train_metrics,
                         test_metrics=test_metrics)
