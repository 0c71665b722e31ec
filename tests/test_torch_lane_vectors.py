"""The lane solvers' per-lane arguments (tolerance, L1 weight, box bounds):
a scalar and a uniform vector give the same bits, and per-lane vectors
match ``jax.vmap`` of the JAX package's single-vector ``minimize_lbfgs`` and
``minimize_owlqn`` (the configuration lanes of
``photon_ml_tpu/algorithm/lane_search.py``) on the CPU in float64:
iterations and reasons equal, coefficients within 1e-10·max|w|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.optim.lbfgs import minimize_lbfgs as jminimize_lbfgs
from photon_ml_tpu.optim.owlqn import minimize_owlqn as jminimize_owlqn
from photon_ml_torch.optim.lanes import minimize_lbfgs_lanes
from photon_ml_torch.optim.owlqn import minimize_owlqn_lanes

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

TOL = 1e-10


def _problem(seed: int, lanes: int = 6, n: int = 80, d: int = 5):
    """A logistic problem shared by every lane, with a per-lane L2 weight."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, -1] = 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ rng.normal(size=d)))).astype(np.float64)
    l2 = np.geomspace(1e-2, 10.0, lanes)
    return x, y, l2


def _torch_vg(x, y, l2, dtype=torch.float64):
    xt, yt = torch.tensor(x, dtype=dtype), torch.tensor(y, dtype=dtype)
    l2t = torch.tensor(l2, dtype=dtype)

    def vg(w):
        z = w @ xt.T
        value = torch.sum(torch.nn.functional.softplus(z) - yt * z, dim=-1)
        grad = (torch.sigmoid(z) - yt) @ xt
        return value + 0.5 * l2t * torch.sum(w * w, dim=-1), grad + l2t.unsqueeze(-1) * w

    return vg


def _jax_vg(x, y):
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    def vg_for(l2):
        def vg(w):
            z = xj @ w
            value = jnp.sum(jax.nn.softplus(z) - yj * z)
            grad = xj.T @ (jax.nn.sigmoid(z) - yj)
            return value + 0.5 * l2 * jnp.vdot(w, w), grad + l2 * w
        return vg

    return vg_for


def _assert_match(ref, got):
    assert np.array_equal(np.asarray(ref.iterations), got.iterations.numpy())
    assert np.array_equal(np.asarray(ref.reason), got.reason.numpy())
    rw = np.asarray(ref.coefficients)
    np.testing.assert_allclose(got.coefficients.numpy(), rw, rtol=0,
                               atol=TOL * max(1.0, np.abs(rw).max()))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value), rtol=TOL, atol=0)


def _assert_bitwise(a, b):
    for field in ("coefficients", "value", "gradient_norm", "iterations", "reason"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("solver", ["lbfgs", "owlqn"])
def test_scalar_and_uniform_vectors_are_bitwise(solver, dtype):
    x, y, l2 = _problem(0)
    lanes, d = len(l2), x.shape[1]
    vg = _torch_vg(x, y, l2, dtype)
    w0 = torch.zeros((lanes, d), dtype=dtype)
    tol = torch.full((lanes,), 1e-6, dtype=dtype)
    if solver == "lbfgs":
        a = minimize_lbfgs_lanes(vg, w0, max_iter=30, tolerance=1e-6)
        b = minimize_lbfgs_lanes(vg, w0, max_iter=30, tolerance=tol)
    else:
        a = minimize_owlqn_lanes(vg, w0, l1_weight=0.5, max_iter=30, tolerance=1e-6)
        b = minimize_owlqn_lanes(vg, w0, l1_weight=torch.full((lanes,), 0.5, dtype=dtype),
                                 max_iter=30, tolerance=tol)
    _assert_bitwise(a, b)


def test_per_lane_tolerance_matches_vmapped_lbfgs():
    x, y, l2 = _problem(1)
    lanes, d = len(l2), x.shape[1]
    tol = np.geomspace(1e-2, 1e-9, lanes)
    vg_for = _jax_vg(x, y)
    ref = jax.vmap(lambda l, t, w0: jminimize_lbfgs(vg_for(l), w0, max_iter=40, tolerance=t))(
        jnp.asarray(l2), jnp.asarray(tol), jnp.zeros((lanes, d)))
    got = minimize_lbfgs_lanes(_torch_vg(x, y, l2), torch.zeros((lanes, d), dtype=torch.float64),
                               max_iter=40, tolerance=torch.tensor(tol))
    _assert_match(ref, got)
    assert len(set(got.iterations.tolist())) > 1


@pytest.mark.parametrize("shared", [True, False], ids=["shared-box", "per-lane-box"])
def test_box_lanes_match_vmapped_projected_lbfgs(shared):
    x, y, l2 = _problem(2)
    lanes, d = len(l2), x.shape[1]
    rng = np.random.default_rng(3)
    lo = np.full((lanes, d), -0.15)
    hi = np.full((lanes, d), 0.2)
    if not shared:
        off = rng.uniform(size=lanes) < 0.5  # box-off lanes carry ±inf rows
        off[0], off[1] = True, False
        lo[off], hi[off] = -np.inf, np.inf
        lo[:, -1] = -np.inf
    vg_for = _jax_vg(x, y)
    w0 = 0.1 * rng.normal(size=(lanes, d))
    if shared:
        ref = jax.vmap(lambda l, w: jminimize_lbfgs(
            vg_for(l), w, max_iter=30, tolerance=1e-9, lower_bounds=jnp.asarray(lo[0]),
            upper_bounds=jnp.asarray(hi[0])))(jnp.asarray(l2), jnp.asarray(w0))
        bounds = (torch.tensor(lo[0]), torch.tensor(hi[0]))
    else:
        ref = jax.vmap(lambda l, w, a, b: jminimize_lbfgs(
            vg_for(l), w, max_iter=30, tolerance=1e-9, lower_bounds=a, upper_bounds=b))(
            jnp.asarray(l2), jnp.asarray(w0), jnp.asarray(lo), jnp.asarray(hi))
        bounds = (torch.tensor(lo), torch.tensor(hi))
    got = minimize_lbfgs_lanes(_torch_vg(x, y, l2), torch.tensor(w0), max_iter=30,
                               tolerance=1e-9, lower_bounds=bounds[0], upper_bounds=bounds[1])
    _assert_match(ref, got)
    w = got.coefficients.numpy()
    assert np.all(w >= (lo if not shared else lo[0]) - 1e-12)
    assert np.all(w <= (hi if not shared else hi[0]) + 1e-12)


def test_per_lane_l1_and_tolerance_match_vmapped_owlqn():
    x, y, l2 = _problem(4)
    lanes, d = len(l2), x.shape[1]
    l1 = np.geomspace(1e-2, 40.0, lanes)
    tol = np.geomspace(1e-3, 1e-9, lanes)
    vg_for = _jax_vg(x, y)
    ref = jax.vmap(lambda a, b, t, w: jminimize_owlqn(vg_for(a), w, l1_weight=b, max_iter=40,
                                                      tolerance=t))(
        jnp.asarray(l2), jnp.asarray(l1), jnp.asarray(tol), jnp.zeros((lanes, d)))
    got = minimize_owlqn_lanes(_torch_vg(x, y, l2), torch.zeros((lanes, d), dtype=torch.float64),
                               l1_weight=torch.tensor(l1), max_iter=40,
                               tolerance=torch.tensor(tol))
    _assert_match(ref, got)
    assert (got.coefficients.numpy() == 0).sum() > 0  # the heavy lanes are sparse
