"""Shared fixtures of the PyTorch port's parity tests.

One numpy fixture, made from a seed, feeds the JAX package and the port
(through ``photon_ml_torch.convert``); the tests compare the two on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from photon_ml_tpu.data.batch import LabeledPointBatch as JaxBatch
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops.normalization import NormalizationType as JaxNormType
from photon_ml_tpu.ops.normalization import build_normalization as jax_build_normalization
from photon_ml_torch import convert
from photon_ml_torch.ops import losses as torch_losses
from tests.torch_jax_cache import lock_persistent_cache

# every worker imports this while collecting: the JAX calls of the parity
# tests then read and write the shared compilation cache under its lock
lock_persistent_cache()

#: (name, binary labels) of the four pointwise losses
LOSSES = [
    ("LogisticLoss", True),
    ("SquaredLoss", False),
    ("PoissonLoss", False),
    ("SmoothedHingeLoss", True),
]
NORMS = ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"]


def loss_pair(name: str):
    return getattr(jax_losses, name)(), getattr(torch_losses, name)()


def make_data(seed: int, n: int, d: int, binary: bool, *, dtype=np.float64,
              zero_weight_every: int = 7, intercept: bool = True):
    """(x, y, offsets, weights) with an intercept column last, shifted and
    scaled columns, and every ``zero_weight_every``-th row at weight 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, size=d) + rng.normal(size=d)
    if intercept:
        x[:, -1] = 1.0
    w_true = rng.normal(size=d) / np.sqrt(d)
    z = (x - x.mean(axis=0)) @ w_true
    if binary:
        y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = np.abs(z + 0.3 * rng.normal(size=n))  # nonnegative: valid for Poisson too
    offsets = rng.normal(scale=0.1, size=n)
    weights = rng.uniform(0.2, 2.0, size=n)
    if zero_weight_every:
        weights[::zero_weight_every] = 0.0
    return tuple(a.astype(dtype) for a in (x, y, offsets, weights))


def batches(x, y, offsets, weights, *, bf16: bool = False):
    """The same data as a JAX batch and a port batch on the CPU."""
    if bf16:
        jb = JaxBatch.create(jnp.asarray(x, jnp.bfloat16), y, offsets=offsets, weights=weights)
        tb = convert.batch_from_numpy(x, y, offsets, weights, dtype=torch.bfloat16, device="cpu")
    else:
        jb = JaxBatch.create(x, y, offsets=offsets, weights=weights)
        tb = convert.batch_from_numpy(x, y, offsets, weights, device="cpu")
    return jb, tb


def normalizations(kind: str, x: np.ndarray, *, intercept_index: int | None, dtype=None):
    """(JAX context, port context) of one NormalizationType built from x's
    column statistics; ``dtype`` casts the statistics first."""
    mean = x.mean(axis=0)
    var = x.var(axis=0, ddof=1)
    mag = np.abs(x).max(axis=0)
    if dtype is not None:
        mean, var, mag = (a.astype(dtype) for a in (mean, var, mag))
    jn = jax_build_normalization(
        JaxNormType[kind], mean=jnp.asarray(mean), variance=jnp.asarray(var),
        max_magnitude=jnp.asarray(mag), intercept_index=intercept_index)
    tn = convert.normalization_from_numpy(
        None if jn.factors is None else np.asarray(jn.factors),
        None if jn.shifts is None else np.asarray(jn.shifts), device="cpu")
    return jn, tn


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, dtype=np.float64)
