"""Feature importance diagnostics (the port's own copy).

Counterpart of ``photon_ml_tpu/diagnostics/feature_importance.py``;
reference photon-diagnostics diagnostics/featureimportance/ —
expected-magnitude importance (|w_j|·E|x_j|, the feature's contribution
scale to the margin) and variance-based importance (w_j²·Var[x_j], its
contribution to the margin's variance), ranked descending. The weighted
column sums run in float64 on the batch's device; the [d] scores come to
the host once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.io.index_map import IndexMap
from photon_ml_torch.models.glm import GeneralizedLinearModel


@dataclasses.dataclass(frozen=True)
class FeatureImportance:
    index: int
    name: str
    importance: float


@dataclasses.dataclass
class FeatureImportanceReport:
    kind: str  # "expected_magnitude" | "variance"
    ranked: list[FeatureImportance]

    def top(self, k: int) -> list[FeatureImportance]:
        return self.ranked[:k]


def feature_importance(model: GeneralizedLinearModel, batch: LabeledPointBatch, *,
                       kind: str = "expected_magnitude",
                       index_map: IndexMap | None = None) -> FeatureImportanceReport:
    device = batch.features.device
    w = model.coefficients.means.detach().to(device, torch.float64)
    x = batch.features.to(torch.float64)
    sw = batch.weights.to(torch.float64)
    total = sw.sum()
    if kind == "expected_magnitude":
        scores = w.abs() * (sw @ x.abs()) / total
    elif kind == "variance":
        mean = (sw @ x) / total
        var = (sw @ (x - mean) ** 2) / total
        scores = w ** 2 * var
    else:
        raise ValueError(f"unknown importance kind {kind!r}")
    scores = scores.cpu().numpy()

    order = np.argsort(-scores)
    ranked = [
        FeatureImportance(
            index=int(j),
            name=(index_map.get_feature_name(int(j)) or str(j)) if index_map else str(j),
            importance=float(scores[j]),
        )
        for j in order
    ]
    return FeatureImportanceReport(kind=kind, ranked=ranked)
