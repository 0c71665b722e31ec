"""Carry data, normalization and models into the port from numpy arrays.

The port never imports the JAX package, so what crosses between the two
crosses as numpy: a caller holding JAX objects passes ``np.asarray`` of
their fields. Every converter takes ``device=`` with the port's policy
(CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.device import resolve_device
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops.normalization import NormalizationContext
from photon_ml_torch.types import TaskType


def _opt_tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def batch_from_numpy(features, labels, offsets=None, weights=None, *,
                     dtype: torch.dtype | None = None, device=None) -> LabeledPointBatch:
    """A LabeledPointBatch from numpy columns (``dtype=None`` keeps the
    features' dtype; ``torch.bfloat16`` rounds the feature block)."""
    return LabeledPointBatch.create(np.asarray(features), np.asarray(labels),
                                    None if offsets is None else np.asarray(offsets),
                                    None if weights is None else np.asarray(weights),
                                    dtype=dtype, device=device)


def sparse_batch_from_numpy(rows, cols, vals, labels, *, dim: int, offsets=None, weights=None,
                            dtype: torch.dtype | None = None, ell="auto", hybrid=None,
                            column_sorted_gradient: bool = False,
                            device=None) -> SparseLabeledPointBatch:
    """A SparseLabeledPointBatch from numpy COO triples, built like the JAX
    package's ``from_coo`` (``dtype=None`` keeps the values' float dtype;
    ``torch.bfloat16`` rounds them)."""
    vals = np.asarray(vals)
    if dtype is None:
        dtype = torch.from_numpy(vals[:0]).dtype
    return SparseLabeledPointBatch.from_coo(
        np.asarray(rows), np.asarray(cols), vals, np.asarray(labels), dim=dim,
        offsets=None if offsets is None else np.asarray(offsets),
        weights=None if weights is None else np.asarray(weights), dtype=dtype, ell=ell,
        hybrid=hybrid, column_sorted_gradient=column_sorted_gradient, device=device)


def normalization_from_numpy(factors, shifts, *, device=None) -> NormalizationContext:
    """A NormalizationContext from numpy factors/shifts (None = identity)."""
    device = resolve_device(device)
    return NormalizationContext(factors=_opt_tensor(factors, device),
                                shifts=_opt_tensor(shifts, device))


def coefficients_from_numpy(means, variances=None, *, device=None) -> Coefficients:
    device = resolve_device(device)
    return Coefficients(means=_opt_tensor(means, device),
                        variances=_opt_tensor(variances, device))


def glm_from_numpy(means, variances, task, *, device=None) -> GeneralizedLinearModel:
    """A GeneralizedLinearModel; ``task`` is a TaskType, its name, or any
    enum whose value is the name."""
    task = task if isinstance(task, TaskType) else TaskType(getattr(task, "value", task))
    return GeneralizedLinearModel(coefficients_from_numpy(means, variances, device=device), task)
