"""The port's GLMObjective against the JAX package's, in f64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import GLMObjective as JaxObjective
from photon_ml_torch.ops import fused_glm
from photon_ml_torch.ops.objective import GLMObjective
from tests.torch_parity import LOSSES, NORMS, batches, loss_pair, make_data, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

RTOL = 1e-10


def _pair(name, binary, norm, *, l2=0.3, seed=0, n=257, d=9):
    x, y, o, ws = make_data(seed, n, d, binary)
    jb, tb = batches(x, y, o, ws)
    jn, tn = normalizations(norm, x, intercept_index=d - 1)
    jl, tl = loss_pair(name)
    rng = np.random.default_rng(seed + 1)
    w = rng.normal(size=d) * 0.2
    v = rng.normal(size=d)
    return (JaxObjective(jl, l2_weight=l2, normalization=jn), jb,
            GLMObjective(tl, l2_weight=l2, normalization=tn), tb, w, v)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_value_and_gradient_f64(name, binary, norm):
    jo, jb, to, tb, w, _ = _pair(name, binary, norm)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    ref_v, ref_g = jax.value_and_grad(jo.value)(wj, jb)
    np.testing.assert_allclose(float(to.value(wt, tb)), float(ref_v), rtol=RTOL)
    for use_kernel in (None, False):  # None on a CPU batch is the closed form
        to.use_kernel = use_kernel
        v, g = to.value_and_gradient(wt, tb)
        assert v.dtype == torch.float64 and g.dtype == torch.float64
        np.testing.assert_allclose(float(v), float(ref_v), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), to_np(ref_g), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,binary", LOSSES, ids=[n for n, _ in LOSSES])
def test_second_order_f64(name, binary, norm):
    jo, jb, to, tb, w, v = _pair(name, binary, norm, seed=5)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    hv = to.hessian_vector(wt, torch.from_numpy(v), tb)
    np.testing.assert_allclose(hv.numpy(), to_np(jo.hessian_vector(wj, jnp.asarray(v), jb)),
                               rtol=RTOL, atol=1e-12)
    h = to.hessian_matrix(wt, tb)
    np.testing.assert_allclose(h.numpy(), to_np(jo.hessian_matrix(wj, jb)), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(to.hessian_diagonal(wt, tb).numpy(),
                               to_np(jo.hessian_diagonal(wj, jb)), rtol=RTOL, atol=1e-12)
    # the closed-form Hv is the Hessian matrix applied to v
    np.testing.assert_allclose(hv.numpy(), (h @ torch.from_numpy(v)).numpy(), rtol=1e-9,
                               atol=1e-10)


def test_use_kernel_true_on_cpu_takes_the_plain_f32_version():
    """use_kernel=True on a CPU batch is the kernel's plain version: f32
    arithmetic, like the JAX use_pallas=True path in interpret mode."""
    jo, jb, to, tb, w, _ = _pair("LogisticLoss", True, "STANDARDIZATION")
    to.use_kernel = True
    wt = torch.from_numpy(w)
    v, g = to.value_and_gradient(wt, tb)
    ref = fused_glm.fused_value_and_gradient_reference(
        to.loss, wt, tb, l2_weight=to.l2_weight, normalization=to.normalization)
    assert torch.equal(v, ref[0]) and torch.equal(g, ref[1])
    ref_v, ref_g = jax.value_and_grad(jo.value)(jnp.asarray(w), jb)
    np.testing.assert_allclose(float(v), float(ref_v), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), to_np(ref_g), rtol=2e-4, atol=2e-4)


def test_bf16_margins_path():
    """A bf16 feature block keeps f32 coefficients, value and gradient, and
    agrees with the JAX bf16 autodiff path to bf16 tolerance."""
    x, y, o, ws = make_data(8, 200, 12, False, dtype=np.float32)
    jb, tb = batches(x, y, o, ws, bf16=True)
    assert tb.features.dtype == torch.bfloat16 and tb.labels.dtype == torch.float32
    assert tb.solve_dtype == torch.float32
    jl, tl = loss_pair("SquaredLoss")
    w = (np.random.default_rng(8).normal(size=12) * 0.3).astype(np.float32)
    jo = JaxObjective(jl, l2_weight=0.2, use_pallas=False)
    to = GLMObjective(tl, l2_weight=0.2, use_kernel=False)
    np.testing.assert_allclose(to.margins(torch.from_numpy(w), tb).numpy(),
                               to_np(jo.margins(jnp.asarray(w), jb)), rtol=1e-6, atol=1e-5)
    v, g = to.value_and_gradient(torch.from_numpy(w), tb)
    ref_v, ref_g = jo.value_and_gradient(jnp.asarray(w), jb)
    assert v.dtype == torch.float32 and g.dtype == torch.float32
    np.testing.assert_allclose(float(v), float(ref_v), rtol=1e-6)
    # JAX rounds X'r to bf16 through its bf16 matmul transpose; the port
    # keeps X'r in f32 (tests/test_pallas_glm.py:172-174 tolerance)
    np.testing.assert_allclose(g.numpy(), to_np(ref_g), rtol=5e-2, atol=5e-2)


def test_bound_objective():
    jo, jb, to, tb, w, v = _pair("PoissonLoss", False, "NONE")
    bound = to.bind(tb)
    wt, vt = torch.from_numpy(w), torch.from_numpy(v)
    assert torch.equal(bound.value(wt), to.value(wt, tb))
    assert torch.equal(bound.value_and_grad(wt)[1], to.gradient(wt, tb))
    assert torch.equal(bound.hessian_vector(wt, vt), to.hessian_vector(wt, vt, tb))
    assert torch.equal(bound.hessian_matrix(wt), to.hessian_matrix(wt, tb))
