"""Metrics suite: evaluate a GLM on a labeled batch (the port's copy).

Counterpart of ``photon_ml_tpu/diagnostics/metrics.py``; reference
photon-diagnostics Evaluation.scala — ``Evaluation.evaluate(model, data)``
returns a MetricsMap with every metric applicable to the task (RMSE always
for regression; AUC/AUPR + losses for classification), and
metric/MetricMetadata.scala's per-metric direction. Scores are computed on
the batch's device and evaluated on the host.
"""

from __future__ import annotations

import numpy as np

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.evaluation import local_metrics as lm
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType


def evaluate_model(model: GeneralizedLinearModel, batch: LabeledPointBatch) -> dict[str, float]:
    """Compute the task-appropriate metrics map."""
    means = model.coefficients.means
    scores = model.score(batch.features.to(means.device), batch.offsets.to(means.device))
    scores = scores.detach().cpu().numpy()
    labels = batch.labels.cpu().numpy()
    weights = batch.weights.cpu().numpy()
    task = model.task

    metrics: dict[str, float] = {}
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        metrics["AUC"] = lm.area_under_roc_curve(scores, labels, weights)
        metrics["AUPR"] = lm.area_under_precision_recall_curve(scores, labels, weights)
        if task == TaskType.LOGISTIC_REGRESSION:
            metrics["LOGISTIC_LOSS"] = lm.logistic_loss(scores, labels, weights)
        else:
            metrics["SMOOTHED_HINGE_LOSS"] = lm.smoothed_hinge_loss(scores, labels, weights)
    elif task == TaskType.POISSON_REGRESSION:
        metrics["POISSON_LOSS"] = lm.poisson_loss(scores, labels, weights)
        metrics["RMSE"] = lm.root_mean_squared_error(np.exp(scores), labels, weights)
    else:
        metrics["RMSE"] = lm.root_mean_squared_error(scores, labels, weights)
        metrics["MAE"] = lm.mean_absolute_error(scores, labels, weights)
        metrics["SQUARED_LOSS"] = lm.squared_loss(scores, labels, weights)
    return metrics


#: larger-is-better direction per metric (reference MetricMetadata)
METRIC_DIRECTIONS = {
    "AUC": True,
    "AUPR": True,
    "RMSE": False,
    "MAE": False,
    "SQUARED_LOSS": False,
    "LOGISTIC_LOSS": False,
    "POISSON_LOSS": False,
    "SMOOTHED_HINGE_LOSS": False,
}
