"""Shared fixtures of the lane-solver parity tests: one bucket of small
per-entity problems as numpy arrays, solved by the JAX package's vmapped
``_solve_bucket_entities`` and by the port's lane-batched solvers."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.ops.objective import GLMObjective as TObjective
from tests.torch_parity import loss_pair, normalizations


def bucket(seed: int, loss_name: str, *, lanes: int = 9, cap: int = 24, k: int = 4,
           nan_lane: int | None = None):
    """(features [e, cap, k], labels, weights, offsets [e, cap], w0 [e, k]):
    lanes with different sample counts and signal strengths (so they finish
    at different iterations), lane 1 all padding (weights 0), an intercept
    column last, warm starts away from zero."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lanes, cap, k)) * rng.uniform(0.5, 2.0, size=k) + 0.3
    x[:, :, -1] = 1.0
    w_true = rng.normal(size=(lanes, k)) * rng.uniform(0.1, 2.0, size=(lanes, 1))
    z = np.einsum("eck,ek->ec", x, w_true)
    if loss_name in ("LogisticLoss", "SmoothedHingeLoss"):
        y = (rng.uniform(size=z.shape) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif loss_name == "PoissonLoss":
        y = rng.poisson(np.exp(np.clip(0.4 * z, -3, 2))).astype(np.float64)
    else:
        y = z + 0.1 * rng.normal(size=z.shape)
    weights = rng.uniform(0.5, 1.5, size=z.shape)
    counts = rng.integers(3, cap + 1, size=lanes)
    weights *= np.arange(cap)[None, :] < counts[:, None]
    if lanes > 1:
        weights[1] = 0.0
    offsets = 0.1 * rng.normal(size=z.shape)
    w0 = 0.05 * rng.normal(size=(lanes, k))
    w0[0] = 0.0
    if nan_lane is not None:
        y[nan_lane, 0] = np.nan  # every value is NaN: the line search fails
    return x, y, weights, offsets, w0


def objectives(loss_name: str, l2: float, norm_kind: str, x: np.ndarray):
    jl, tl = loss_pair(loss_name)
    flat = x.reshape(-1, x.shape[-1])
    jn, tn = normalizations(norm_kind, flat, intercept_index=x.shape[-1] - 1)
    return (JObjective(jl, l2_weight=l2, normalization=jn, use_pallas=False),
            TObjective(tl, l2_weight=l2, normalization=tn, use_kernel=False))


def solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0):
    """((coefficients, trace) of the JAX vmapped solve, of the port's)."""
    ref = jcoord._solve_bucket_entities(jobj, jopt, *(jnp.asarray(a) for a in
                                                      (x, y, weights, offsets, w0)))
    t = torch.from_numpy
    got = tcoord._solve_bucket_entities(tobj, topt, t(x), t(y), t(weights), t(offsets), t(w0))
    return ref, got


def assert_lanes_equal(ref, got, *, skip: tuple = (), tol: float = 1e-9):
    """Iterations and reasons equal in every lane; coefficients and values
    within ``tol`` (relative to the bucket's largest); gradient norms within
    1e-7 absolute (at an optimum they are rounding noise)."""
    (rw, rt), (gw, gt) = ref, got
    keep = np.array([i not in skip for i in range(rw.shape[0])])
    assert np.array_equal(np.asarray(rt.iterations), gt.iterations.numpy())
    assert np.array_equal(np.asarray(rt.reason), gt.reason.numpy())
    rw, gw = np.asarray(rw)[keep], gw.numpy()[keep]
    np.testing.assert_allclose(gw, rw, rtol=tol, atol=tol * max(1.0, np.abs(rw).max()))
    np.testing.assert_allclose(gt.value.numpy()[keep], np.asarray(rt.value)[keep], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(gt.gradient_norm.numpy()[keep],
                               np.asarray(rt.gradient_norm)[keep], rtol=1e-6, atol=1e-7)
