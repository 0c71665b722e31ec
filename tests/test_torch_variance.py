"""The port's ops/variance.py against the JAX package's, in f64 on the CPU:
mode resolution, the Cholesky paths and their non-PD guard, and the
variances that train_glm attaches to dense models."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.estimators import train_glm as jax_train_glm
from photon_ml_tpu.ops import variance as jvar
from photon_ml_tpu.ops.objective import GLMObjective as JaxObjective
from photon_ml_tpu.ops.sparse_objective import SparseGLMObjective as JaxSparseObjective
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JaxConfig
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_torch.estimators import train_glm
from photon_ml_torch.ops import variance as tvar
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.optim.optimizer import OptimizerConfig
from photon_ml_torch.types import TaskType
from tests.torch_parity import batches, loss_pair, make_data, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _spd(d, seed, collinear=False):
    rng = np.random.default_rng(seed)
    if collinear:
        # two equal columns of 16 ones and no ridge: every entry of H is an
        # integer and the second Cholesky pivot is exactly 16 - 4·4 = 0
        a = rng.integers(-3, 4, size=(16, d)).astype(np.float64)
        a[:, 0] = a[:, 1] = 1.0
        return a.T @ a
    a = rng.normal(size=(3 * d, d))
    return a.T @ a + 0.1 * np.eye(d)


def test_mode_resolution_matches():
    assert tvar.FULL_VARIANCE_MAX_DIM == jvar.FULL_VARIANCE_MAX_DIM
    for mode in ("auto", "full", "diagonal"):
        assert tvar.validate_variance_mode(mode) == mode
        for dim, problems in ((10, 1), (4096, 1), (4097, 1), (2048, 4), (2048, 5)):
            assert tvar.resolve_variance_mode(mode, dim, problems) == \
                jvar.resolve_variance_mode(mode, dim, problems)
    for bad in ("Full", "", "none"):
        with pytest.raises(ValueError, match="variance mode"):
            tvar.validate_variance_mode(bad)
    _, tl = loss_pair("LogisticLoss")
    jl, _ = loss_pair("LogisticLoss")
    dense, sparse = GLMObjective(tl), SparseGLMObjective(tl)
    jdense, jsparse = JaxObjective(jl), JaxSparseObjective(jl)
    for mode in ("auto", "diagonal"):
        for dim in (8, 5000):
            assert tvar.resolve_variance_mode_for(dense, mode, dim) == \
                jvar.resolve_variance_mode_for(jdense, mode, dim)
            assert tvar.resolve_variance_mode_for(sparse, mode, dim) == \
                jvar.resolve_variance_mode_for(jsparse, mode, dim) == "diagonal"
    assert tvar.resolve_variance_mode_for(dense, "full", 5000) == "full"
    for objective in (sparse, jsparse):
        mod = tvar if objective is sparse else jvar
        with pytest.raises(ValueError, match="dense Hessian"):
            mod.resolve_variance_mode_for(objective, "full", 8)


@pytest.mark.parametrize("collinear", [False, True], ids=["pd", "not_pd"])
def test_cholesky_paths_match(collinear):
    h = _spd(6, seed=1, collinear=collinear)
    ht, hj = torch.from_numpy(h), jnp.asarray(h)
    got = tvar.diag_inverse_from_hessian(ht)
    want = jvar.diag_inverse_from_hessian(hj)
    np.testing.assert_allclose(got.numpy(), to_np(want), rtol=1e-9)
    full = tvar.full_inverse_from_hessian(ht)
    np.testing.assert_allclose(full.numpy(), to_np(jvar.full_inverse_from_hessian(hj)), rtol=1e-9,
                               atol=1e-12)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(full).all())
    if collinear:  # the guard: the clamped diagonal approximation
        np.testing.assert_allclose(got.numpy(), 1.0 / np.diag(h), rtol=1e-12)
        np.testing.assert_allclose(full.numpy(), np.diag(1.0 / np.diag(h)), rtol=1e-12)
    else:
        np.testing.assert_allclose(got.numpy(), np.diag(np.linalg.inv(h)), rtol=1e-9)
    d = np.array([4.0, 0.0, -1.0, 1e-13])
    np.testing.assert_allclose(tvar.inverse_of_diagonal(torch.from_numpy(d)).numpy(),
                               to_np(jvar.inverse_of_diagonal(jnp.asarray(d))), rtol=1e-15)


@pytest.mark.parametrize("mode", ["auto", "full", "diagonal"])
@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
def test_coefficient_variances_match(mode, norm):
    x, y, o, ws = make_data(3, 120, 6, True)
    jb, tb = batches(x, y, o, ws)
    jn, tn = normalizations(norm, x, intercept_index=5)
    jl, tl = loss_pair("LogisticLoss")
    w = np.random.default_rng(4).normal(size=6) * 0.3
    got = tvar.coefficient_variances(GLMObjective(tl, 0.7, tn), torch.from_numpy(w), tb, mode)
    want = jvar.coefficient_variances(JaxObjective(jl, 0.7, jn), jnp.asarray(w), jb, mode)
    np.testing.assert_allclose(got.numpy(), to_np(want), rtol=1e-9)


@pytest.mark.parametrize("mode", ["auto", "diagonal"])
def test_dense_train_glm_variances_match(mode):
    x, y, o, ws = make_data(5, 200, 7, True)
    jb, tb = batches(x, y, o, ws)
    jn, tn = normalizations("SCALE_WITH_STANDARD_DEVIATION", x, intercept_index=6)
    kw = dict(regularization_weights=(0.0, 1.0, 10.0), intercept_index=6, compute_variance=True,
              variance_mode=mode)
    ref = jax_train_glm(jb, JaxTask.LOGISTIC_REGRESSION, normalization=jn,
                        optimizer=JaxConfig(max_iterations=100, tolerance=1e-9), **kw)
    port = train_glm(tb, TaskType.LOGISTIC_REGRESSION, normalization=tn,
                     optimizer=OptimizerConfig(max_iterations=100, tolerance=1e-9), **kw)
    for lam in (0.0, 1.0, 10.0):
        pv, rv = port[lam].coefficients.variances, ref[lam].coefficients.variances
        assert pv is not None and pv.shape == (7,)
        np.testing.assert_allclose(to_np(port[lam].coefficients.means),
                                   to_np(ref[lam].coefficients.means), rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(to_np(pv), to_np(rv), rtol=1e-6)


def test_singular_unregularized_variances_fall_back():
    """λ=0 with a column that holds no data (collinear with every other):
    H is singular, and both packages fall back to the clamped diagonal
    instead of storing NaN."""
    x, y, o, ws = make_data(6, 150, 5, True)
    x[:, 1] = 0.0
    jb, tb = batches(x, y, o, ws)
    kw = dict(regularization_weights=(0.0,), compute_variance=True, variance_mode="full")
    ref = jax_train_glm(jb, JaxTask.LOGISTIC_REGRESSION,
                        optimizer=JaxConfig(max_iterations=50), **kw)
    port = train_glm(tb, TaskType.LOGISTIC_REGRESSION,
                     optimizer=OptimizerConfig(max_iterations=50), **kw)
    pv = port[0.0].coefficients.variances
    assert bool(torch.isfinite(pv).all()) and float(pv[1]) == 1e12
    np.testing.assert_allclose(to_np(pv), to_np(ref[0.0].coefficients.variances), rtol=1e-6)
