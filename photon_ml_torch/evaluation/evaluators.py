"""Evaluator objects: metric + comparison direction + per-query variants.

Counterpart of ``photon_ml_tpu/evaluation/evaluators.py``; reference
photon-lib evaluation/Evaluator.scala:39-49, EvaluatorType.scala:35-43,
photon-api evaluation/MultiEvaluator.scala:40-88 (per-query grouping and the
mean of the local metric) and EvaluatorFactory.scala.

Evaluators consume raw scores (margins including offsets) as host arrays;
classification metrics read them as ranking scores, regression metrics as
predictions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from photon_ml_torch.evaluation import local_metrics as lm
from photon_ml_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class EvaluationData:
    """Host-side labels, offsets, weights and optional id columns."""

    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    ids: dict = dataclasses.field(default_factory=dict)


class Evaluator:
    """A named metric with a preference direction."""

    name: str
    #: True if larger metric values are better (AUC)
    larger_is_better: bool

    def evaluate(self, scores: np.ndarray, data: EvaluationData) -> float:
        raise NotImplementedError

    def better_than(self, a: float, b: float) -> bool:
        if np.isnan(b):
            return True
        if np.isnan(a):
            return False
        return a > b if self.larger_is_better else a < b


@dataclasses.dataclass(frozen=True)
class _GlobalEvaluator(Evaluator):
    name: str
    larger_is_better: bool
    fn: Callable[..., float]

    def evaluate(self, scores: np.ndarray, data: EvaluationData) -> float:
        return self.fn(scores, data.labels, data.weights)


@dataclasses.dataclass(frozen=True)
class MultiEvaluator(Evaluator):
    """Per-query metric: group rows by an id column, compute the local
    metric per group, return the unweighted mean over the groups that give a
    value (reference MultiEvaluator.scala:40-88)."""

    name: str
    larger_is_better: bool
    id_column: str
    local_fn: Callable[..., float]
    #: groups must contain both classes for ranking metrics to be defined
    requires_both_classes: bool = False

    def evaluate(self, scores: np.ndarray, data: EvaluationData) -> float:
        ids = data.ids.get(self.id_column)
        if ids is None:
            raise KeyError(
                f"id column '{self.id_column}' not present in evaluation data"
            )
        scores = np.asarray(scores).reshape(-1)
        order = np.argsort(ids, kind="stable")
        sorted_ids = np.asarray(ids)[order]
        boundaries = np.concatenate(
            [[0], np.nonzero(sorted_ids[1:] != sorted_ids[:-1])[0] + 1, [len(sorted_ids)]]
        )
        values = []
        for start, end in zip(boundaries[:-1], boundaries[1:]):
            sel = order[start:end]
            y = data.labels[sel]
            if self.requires_both_classes and (np.all(y > 0.5) or np.all(y <= 0.5)):
                continue
            v = self.local_fn(scores[sel], y, data.weights[sel])
            if not np.isnan(v):
                values.append(v)
        return float(np.mean(values)) if values else float("nan")


_GLOBALS = {
    "AUC": ("AUC", True, lm.area_under_roc_curve),
    "AUPR": ("AUPR", True, lm.area_under_precision_recall_curve),
    "RMSE": ("RMSE", False, lm.root_mean_squared_error),
    "MAE": ("MAE", False, lm.mean_absolute_error),
    "LOGISTIC_LOSS": ("LOGISTIC_LOSS", False, lm.logistic_loss),
    "SQUARED_LOSS": ("SQUARED_LOSS", False, lm.squared_loss),
    "POISSON_LOSS": ("POISSON_LOSS", False, lm.poisson_loss),
    "SMOOTHED_HINGE_LOSS": ("SMOOTHED_HINGE_LOSS", False, lm.smoothed_hinge_loss),
}

_LOCAL_FOR_MULTI = {
    "AUC": (True, lm.area_under_roc_curve, True),
    "RMSE": (False, lm.root_mean_squared_error, False),
}


def parse_evaluator(spec: str) -> Evaluator:
    """Parse an evaluator spec: global "AUC", "RMSE", ...; per-query
    "AUC:queryId" or "PRECISION@5:queryId"."""
    spec = spec.strip()
    if ":" in spec:
        metric, id_col = spec.split(":", 1)
        metric = metric.strip().upper()
        id_col = id_col.strip()
        if not id_col:
            raise ValueError(f"Per-query evaluator '{spec}' is missing an id column")
        if metric.startswith("PRECISION@"):
            k_str = metric.split("@", 1)[1]
            if not k_str.isdigit() or int(k_str) < 1:
                raise ValueError(
                    f"Bad precision@k spec '{spec}': k must be a positive integer"
                )
            k = int(k_str)
            return MultiEvaluator(
                name=f"PRECISION@{k}:{id_col}",
                larger_is_better=True,
                id_column=id_col,
                local_fn=lambda s, y, w, _k=k: lm.precision_at_k(_k, s, y, w),
            )
        if metric not in _LOCAL_FOR_MULTI:
            raise ValueError(f"Unsupported per-query metric '{metric}'")
        larger, fn, both = _LOCAL_FOR_MULTI[metric]
        return MultiEvaluator(
            name=f"{metric}:{id_col}",
            larger_is_better=larger,
            id_column=id_col,
            local_fn=fn,
            requires_both_classes=both,
        )
    metric = spec.upper()
    if metric not in _GLOBALS:
        raise ValueError(f"Unknown evaluator '{spec}'")
    name, larger, fn = _GLOBALS[metric]
    return _GlobalEvaluator(name=name, larger_is_better=larger, fn=fn)


def default_evaluator_for_task(task: TaskType) -> Evaluator:
    """The training-loss evaluator of a task (reference
    GameEstimator.prepareTrainingLossEvaluator, GameEstimator.scala:592-614)."""
    mapping = {
        TaskType.LOGISTIC_REGRESSION: "LOGISTIC_LOSS",
        TaskType.LINEAR_REGRESSION: "SQUARED_LOSS",
        TaskType.POISSON_REGRESSION: "POISSON_LOSS",
        TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "SMOOTHED_HINGE_LOSS",
    }
    return parse_evaluator(mapping[task])
