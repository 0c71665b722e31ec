"""Dense batched training data: the port's LabeledPoint block.

Counterpart of ``photon_ml_tpu/data/batch.py``; reference photon-lib
data/LabeledPoint.scala (per-sample label, features, offset, weight).

``weights`` double as the padding mask: padded rows carry weight 0 and so
contribute nothing to any weighted aggregate (value, gradient,
Hessian-vector, evaluator).

Only the feature block may be bfloat16. Labels, offsets, weights and the
solver's coefficients stay float32 for a bf16 block (the loss arithmetic
and every accumulation are float32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.device import resolve_device


def device_tensor(a, dtype, device) -> torch.Tensor:
    """``a`` (numpy array or tensor) as a contiguous ``dtype`` tensor on ``device``."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return torch.as_tensor(a, dtype=dtype, device=device).contiguous()


@dataclasses.dataclass(frozen=True)
class LabeledPointBatch:
    """A dense block of labeled samples.

    features: [n, d] float tensor
    labels:   [n] float tensor
    offsets:  [n] float tensor, prior scores added to the margin
              (reference data/DataSet.scala addScoresToOffsets)
    weights:  [n] float tensor, sample weights; 0 marks padding
    """

    features: torch.Tensor
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor

    @property
    def num_samples(self) -> int:
        return self.features.shape[0]

    @property
    def dim(self) -> int:
        return self.features.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.features.dtype

    @property
    def device(self) -> torch.device:
        return self.features.device

    @property
    def solve_dtype(self) -> torch.dtype:
        """Dtype of coefficients and optimizer state: a bf16 feature block
        still solves in float32."""
        return solve_dtype_of(self.features.dtype)

    def with_offsets(self, offsets: torch.Tensor) -> "LabeledPointBatch":
        return dataclasses.replace(self, offsets=offsets)

    def add_scores_to_offsets(self, scores: torch.Tensor) -> "LabeledPointBatch":
        """Residual update used by coordinate descent (DataSet.addScoresToOffsets)."""
        return dataclasses.replace(self, offsets=self.offsets + scores)

    @classmethod
    def create(
        cls,
        features,
        labels,
        offsets=None,
        weights=None,
        dtype: torch.dtype | None = None,
        *,
        device=None,
    ) -> "LabeledPointBatch":
        """Build a batch on ``device`` (CUDA unless ``device="cpu"``).

        ``dtype=None`` keeps the features' float dtype (float64 in the
        parity tests, float32 in production). ``dtype=torch.bfloat16``
        rounds the feature block to bf16 and keeps the other columns f32.
        """
        device = resolve_device(device)
        features = device_tensor(features, dtype, device)
        dtype = features.dtype
        if dtype == torch.bfloat16:
            dtype = torch.float32
        labels = device_tensor(labels, dtype, device)
        n = features.shape[0]
        if offsets is None:
            offsets = torch.zeros((n,), dtype=dtype, device=device)
        else:
            offsets = device_tensor(offsets, dtype, device)
        if weights is None:
            weights = torch.ones((n,), dtype=dtype, device=device)
        else:
            weights = device_tensor(weights, dtype, device)
        return cls(features=features, labels=labels, offsets=offsets, weights=weights)

    def pad_to(self, n: int) -> "LabeledPointBatch":
        """Pad to n rows with zero-weight rows."""
        cur = self.num_samples
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad {cur} rows down to {n}")
        pad = n - cur
        return LabeledPointBatch(
            features=torch.nn.functional.pad(self.features, (0, 0, 0, pad)),
            labels=torch.nn.functional.pad(self.labels, (0, pad)),
            offsets=torch.nn.functional.pad(self.offsets, (0, pad)),
            weights=torch.nn.functional.pad(self.weights, (0, pad)),
        )


def solve_dtype_of(feature_dtype: torch.dtype) -> torch.dtype:
    """Coefficient/optimizer-state dtype for a feature-block dtype: bf16
    blocks still solve in float32."""
    return torch.float32 if feature_dtype == torch.bfloat16 else feature_dtype


def compute_margins(batch: LabeledPointBatch, coefficients: torch.Tensor) -> torch.Tensor:
    """margin_i = x_i . w + offset_i (reference DataPoint.computeMargin)."""
    return batch.features @ coefficients + batch.offsets


def summarize(features: np.ndarray, weights: np.ndarray | None = None) -> dict:
    """Weighted feature summary (reference stat/BasicStatisticalSummary.scala).

    Host-side float64 numpy: mean, variance (unbiased, weighted), max, min,
    max_magnitude, norm_l1, norm_l2, num_nonzeros per feature column.
    """
    features = np.asarray(features, dtype=np.float64)
    n = features.shape[0]
    if weights is None:
        weights = np.ones((n,), dtype=np.float64)
    else:
        weights = np.asarray(weights, dtype=np.float64)
    wsum = weights.sum()
    mean = (weights[:, None] * features).sum(axis=0) / wsum
    centered = features - mean
    var = (weights[:, None] * centered * centered).sum(axis=0) / np.maximum(wsum - 1.0, 1.0)
    return {
        "count": n,
        "weight_sum": wsum,
        "mean": mean,
        "variance": var,
        "max": features.max(axis=0) if n else np.zeros(features.shape[1]),
        "min": features.min(axis=0) if n else np.zeros(features.shape[1]),
        "max_magnitude": np.abs(features).max(axis=0) if n else np.zeros(features.shape[1]),
        "norm_l1": np.abs(features).sum(axis=0),
        "norm_l2": np.sqrt((features * features).sum(axis=0)),
        "num_nonzeros": (features != 0).sum(axis=0).astype(np.float64),
    }
