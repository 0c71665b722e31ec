"""The port's SparseGLMObjective against the JAX package's, in f64 on the
CPU: value, gradient, Hessian-vector product and Hessian diagonal for the
four losses, three normalizations and every view of the same entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.ops import sparse_objective as jso
from photon_ml_torch.data import sparse_batch as tsb
from photon_ml_torch.ops import sparse_objective as tso
from tests.test_torch_sparse_batch import D, N, _policy, coo
from tests.torch_parity import LOSSES, NORMS, loss_pair, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

RTOL = 1e-10

VIEWS = {
    "flat": dict(ell=False),
    "flat_padded": dict(ell=False, pad_nnz_to=512),
    "ell_tail": dict(ell=3),
    "column_sorted": dict(column_sorted_gradient=True, pad_nnz_to=512),
    "hybrid": dict(hybrid=dict(hot_cols=4, pad_multiple=8), ell=2),
}


def sparse_problem(seed=0, binary=True, n=N, d=D):
    """COO entries over d-1 columns plus a constant-1 intercept column last
    (STANDARDIZATION needs it), labels for the loss, and the dense matrix
    the normalization statistics come from."""
    rows, cols, vals, labels, offsets, weights = coo(seed, n=n, d=d)
    keep = cols < d - 1
    rows = np.concatenate([rows[keep], np.arange(n)])
    cols = np.concatenate([cols[keep], np.full(n, d - 1)])
    vals = np.concatenate([vals[keep], np.ones(n)])
    x = np.zeros((n, d))
    np.add.at(x, (rows, cols), vals)
    if not binary:
        w_true = np.random.default_rng(seed + 5).normal(size=d) * 0.3
        labels = np.abs(x @ w_true + 0.3 * np.random.default_rng(seed + 6).normal(size=n))
    return rows, cols, vals, labels, offsets, weights, x


def batch_pair(view, problem, dtype=np.float64):
    rows, cols, vals, labels, offsets, weights, _ = problem
    d = problem[-1].shape[1]
    kw = VIEWS[view]
    tdtype = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    port = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=d, offsets=offsets,
                                                weights=weights, dtype=tdtype, device="cpu",
                                                **_policy(tsb, kw))
    ref = jsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=d, offsets=offsets,
                                               weights=weights, dtype=dtype, **_policy(jsb, kw))
    return port, ref


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_objective_matches_jax(name, binary, norm, view):
    problem = sparse_problem(binary=binary)
    port_b, ref_b = batch_pair(view, problem)
    jn, tn = normalizations(norm, problem[-1], intercept_index=D - 1)
    jl, tl = loss_pair(name)
    jo = jso.SparseGLMObjective(jl, l2_weight=0.3, normalization=jn)
    to = tso.SparseGLMObjective(tl, l2_weight=0.3, normalization=tn)
    rng = np.random.default_rng(11)
    w, v = rng.normal(size=D) * 0.2, rng.normal(size=D)
    wj, wt, vj, vt = jnp.asarray(w), torch.from_numpy(w), jnp.asarray(v), torch.from_numpy(v)

    ref_v, ref_g = jo.value_and_gradient(wj, ref_b)
    np.testing.assert_allclose(float(to.value(wt, port_b)), float(ref_v), rtol=RTOL)
    for use_kernel in (None, True, False):  # all the plain version on a CPU batch
        to.use_kernel = use_kernel
        val, grad = to.value_and_gradient(wt, port_b)
        assert val.dtype == grad.dtype == torch.float64
        np.testing.assert_allclose(float(val), float(ref_v), rtol=RTOL)
        np.testing.assert_allclose(grad.numpy(), to_np(ref_g), rtol=RTOL, atol=1e-11)
    np.testing.assert_allclose(to.gradient(wt, port_b).numpy(), to_np(ref_g), rtol=RTOL,
                               atol=1e-11)
    if tl.twice_differentiable:
        hv = to.hessian_vector(wt, vt, port_b)
        np.testing.assert_allclose(hv.numpy(), to_np(jo.hessian_vector(wj, vj, ref_b)),
                                   rtol=RTOL, atol=1e-11)
        np.testing.assert_allclose(to.hessian_diagonal(wt, port_b).numpy(),
                                   to_np(jo.hessian_diagonal(wj, ref_b)), rtol=RTOL, atol=1e-11)
    bound = to.bind(port_b)
    np.testing.assert_allclose(float(bound.value_and_grad(wt)[0]), float(ref_v), rtol=RTOL)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_views_agree_with_dense_hessian(view):
    """Hv and diag(H) of every view against the dense Hessian of the same
    entries (the algebra, independently of the JAX package)."""
    problem = sparse_problem(seed=2)
    port_b, _ = batch_pair(view, problem)
    x = problem[-1]
    _, tn = normalizations("STANDARDIZATION", x, intercept_index=D - 1)
    _, tl = loss_pair("LogisticLoss")
    to = tso.SparseGLMObjective(tl, l2_weight=0.5, normalization=tn)
    w = torch.from_numpy(np.random.default_rng(3).normal(size=D) * 0.3)
    xn = (torch.from_numpy(x) - tn.shifts) * tn.factors
    d2 = tl.d2z(to.margins(w, port_b), port_b.labels) * port_b.weights
    h = xn.T @ (d2[:, None] * xn) + 0.5 * torch.eye(D, dtype=torch.float64)
    v = torch.from_numpy(np.random.default_rng(4).normal(size=D))
    torch.testing.assert_close(to.hessian_vector(w, v, port_b), h @ v, rtol=1e-10, atol=1e-11)
    torch.testing.assert_close(to.hessian_diagonal(w, port_b), torch.diagonal(h), rtol=1e-10,
                               atol=1e-11)
    assert not hasattr(to, "hessian_matrix")


@pytest.mark.parametrize("view", ["flat_padded", "ell_tail", "hybrid"])
def test_tail_gradient_update_matches_jax(view):
    """The ELL and flat-tail scatter into a gradient that already holds
    something, against the JAX package's (the hybrid head is not its part)."""
    port_b, ref_b = batch_pair(view, sparse_problem(seed=6))
    jl, tl = loss_pair("LogisticLoss")
    rng = np.random.default_rng(7)
    g0, dzw = rng.normal(size=D), rng.normal(size=N)
    got = tso.SparseGLMObjective(tl)._tail_gradient_update(
        torch.from_numpy(g0.copy()), torch.from_numpy(dzw), port_b)
    want = jso.SparseGLMObjective(jl)._tail_gradient_update(jnp.asarray(g0), jnp.asarray(dzw),
                                                            ref_b)
    np.testing.assert_allclose(got.numpy(), to_np(want), rtol=RTOL, atol=1e-12)


def test_padded_nnz_is_inert():
    problem = sparse_problem(seed=4)
    for view in ("flat", "column_sorted", "ell_tail"):
        port_b, _ = batch_pair(view, problem)
        padded = port_b.pad_nnz(port_b.nnz + 100)
        _, tl = loss_pair("PoissonLoss")
        to = tso.SparseGLMObjective(tl, l2_weight=0.1)
        w = torch.from_numpy(np.random.default_rng(5).normal(size=D) * 0.1)
        for a, b in zip(to.value_and_gradient(w, port_b), to.value_and_gradient(w, padded)):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_sorted_run_sums_across_chunk_boundaries(dtype):
    rng = np.random.default_rng(6)
    nnz, dim = 10_000, 9
    # runs that start before and end after the 4096- and 8192-entry chunk
    # edges, an empty run, and runs inside one chunk
    cuts = np.array([0, 10, 4000, 4100, 4100, 8000, 8300, 9000, 9999, nnz])
    contrib = rng.normal(size=nnz).astype(dtype)
    got = tso._sorted_run_sums(torch.from_numpy(contrib), torch.from_numpy(cuts.astype(np.int32)))
    want = jso._sorted_run_sums(jnp.asarray(contrib), jnp.asarray(cuts, dtype=jnp.int32))
    exact = np.add.reduceat(contrib.astype(np.float64), cuts[:-1])
    exact[cuts[:-1] == cuts[1:]] = 0.0
    assert got.shape == (dim,) and float(got[3]) == 0.0
    tol = 1e-12 if dtype == np.float64 else 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), exact, rtol=tol, atol=tol)
    empty = tso._sorted_run_sums(torch.zeros(0, dtype=torch.float64),
                                 torch.zeros(4, dtype=torch.int32))
    assert empty.tolist() == [0.0, 0.0, 0.0]


def test_f32_objective_matches_jax():
    problem = sparse_problem(seed=7)
    port_b, ref_b = batch_pair("ell_tail", problem, dtype=np.float32)
    jl, tl = loss_pair("LogisticLoss")
    w = (np.random.default_rng(8).normal(size=D) * 0.2).astype(np.float32)
    rv, rg = jax.jit(jso.SparseGLMObjective(jl, l2_weight=1.0).value_and_gradient)(
        jnp.asarray(w), ref_b)
    v, g = tso.SparseGLMObjective(tl, l2_weight=1.0).value_and_gradient(torch.from_numpy(w),
                                                                         port_b)
    assert g.dtype == torch.float32
    np.testing.assert_allclose(float(v), float(rv), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-5)
