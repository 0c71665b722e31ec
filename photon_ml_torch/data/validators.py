"""Input-data sanity validation (the port's own copy).

Counterpart of ``photon_ml_tpu/data/validators.py``. Reference parity:
photon-client data/DataValidators.scala — per-row checks (finite
label/offset/weight/features; binary labels for logistic; non-negative
labels for Poisson) with DataValidationType {VALIDATE_FULL, VALIDATE_SAMPLE,
VALIDATE_DISABLED}; validation failures abort training with a summary of
every failed check.

Checks are vectorized numpy reductions over the host columns of a
GameDataset (or raw arrays) instead of per-row RDD filters: one pass, no
Python loop, nothing read back from the device.
"""

from __future__ import annotations

import enum
import logging
from typing import Mapping, Sequence

import numpy as np

from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)


class DataValidationType(enum.Enum):
    """Reference: DataValidationType.scala."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class DataValidationError(ValueError):
    """Raised when validation fails; message lists every failed check."""


_SAMPLE_FRACTION = 0.1  # reference samples 10% for VALIDATE_SAMPLE
_MIN_SAMPLE = 1024


def _subsample(n: int, validation_type: DataValidationType) -> np.ndarray | slice:
    if validation_type == DataValidationType.VALIDATE_SAMPLE and n > _MIN_SAMPLE:
        k = max(_MIN_SAMPLE, int(n * _SAMPLE_FRACTION))
        # deterministic evenly-spaced subsample
        return np.linspace(0, n - 1, k).astype(np.intp)
    return slice(None)


def validate_arrays(
    *,
    labels: np.ndarray,
    task: TaskType,
    offsets: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    feature_shards: Mapping[str, np.ndarray] | None = None,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
    extra_failures: Sequence[str] = (),
) -> None:
    """Run the reference's sanityCheckData checks; raise DataValidationError
    listing all failures (DataValidators.scala aggregates before throwing).
    extra_failures: pre-computed failure strings (e.g. sparse-shard checks)
    aggregated into the same report."""
    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return

    labels = np.asarray(labels)
    sel = _subsample(len(labels), validation_type)
    labels = labels[sel]
    failures: list[str] = list(extra_failures)

    if not np.all(np.isfinite(labels)):
        failures.append("labels contain NaN/Inf")
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        if not np.all((labels == 0.0) | (labels == 1.0)):
            failures.append(f"{task.name} requires binary labels in {{0, 1}}")
    if task == TaskType.POISSON_REGRESSION and np.any(labels < 0.0):
        failures.append("POISSON_REGRESSION requires non-negative labels")

    if offsets is not None:
        offsets = np.asarray(offsets)[sel]
        if not np.all(np.isfinite(offsets)):
            failures.append("offsets contain NaN/Inf")
    if weights is not None:
        weights = np.asarray(weights)[sel]
        if not np.all(np.isfinite(weights)):
            failures.append("weights contain NaN/Inf")
        elif np.any(weights < 0.0):
            failures.append("weights contain negative values")
    for shard_id, features in (feature_shards or {}).items():
        if not np.all(np.isfinite(np.asarray(features)[sel])):
            failures.append(f"feature shard '{shard_id}' contains NaN/Inf")

    if failures:
        raise DataValidationError(
            "input data failed validation: " + "; ".join(failures)
        )
    logger.debug("data validation passed (%s)", validation_type.value)


def validate_game_dataset(
    dataset,
    task: TaskType,
    validation_type: DataValidationType = DataValidationType.VALIDATE_FULL,
) -> None:
    """Validate a GameDataset (reference sanityCheckDataFrameForTraining,
    GameTrainingDriver.scala:400-417)."""
    from photon_ml_torch.data.sparse_batch import SparseShard

    if validation_type == DataValidationType.VALIDATE_DISABLED:
        return
    dense_shards: dict = {}
    sparse_failures: list[str] = []
    for k, v in dataset.feature_shards.items():
        if isinstance(v, SparseShard):
            # COO values are the entire feature content; O(nnz) full check
            # regardless of sample-level validation mode
            if not np.all(np.isfinite(v.vals)):
                sparse_failures.append(
                    f"feature shard '{k}' contains NaN/Inf"
                )
        else:
            dense_shards[k] = dataset.host_array(f"shard/{k}")
    validate_arrays(
        labels=dataset.host_array("labels"),
        task=task,
        offsets=dataset.host_array("offsets"),
        weights=dataset.host_array("weights"),
        feature_shards=dense_shards,
        validation_type=validation_type,
        extra_failures=sparse_failures,
    )
