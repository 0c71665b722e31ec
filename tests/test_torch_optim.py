"""The port's solvers against the JAX package's, in f64 on the CPU.

The JAX solvers run in their host-loop mode (``host_loop=True``), the shape
of the port's Python loops; iteration counts and convergence reasons must be
equal, value histories and coefficients within rtol 1e-8.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops.objective import GLMObjective as JaxObjective
from photon_ml_tpu.optim import common as jax_common
from photon_ml_tpu.optim.lbfgs import minimize_lbfgs as jax_lbfgs
from photon_ml_tpu.optim.lbfgs import two_loop_direction as jax_two_loop
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JaxConfig
from photon_ml_tpu.optim.optimizer import OptimizerType as JaxType
from photon_ml_tpu.optim.optimizer import default_config_for as jax_default_config_for
from photon_ml_tpu.optim.optimizer import resolve_auto_optimizer as jax_resolve_auto
from photon_ml_tpu.optim.owlqn import minimize_owlqn as jax_owlqn
from photon_ml_tpu.optim.owlqn import pseudo_gradient as jax_pseudo_gradient
from photon_ml_tpu.optim.tron import minimize_tron as jax_tron
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim import common
from photon_ml_torch.optim.lbfgs import minimize_lbfgs, two_loop_direction
from photon_ml_torch.optim.optimizer import (
    OptimizerConfig,
    OptimizerType,
    default_config_for,
    resolve_auto_optimizer,
    solve,
)
from photon_ml_torch.optim.owlqn import minimize_owlqn, pseudo_gradient
from photon_ml_torch.optim.tron import minimize_tron
from tests.torch_parity import batches, loss_pair, make_data, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

RTOL = 1e-8


def _bound(name, binary, norm="NONE", l2=0.5, seed=0, n=200, d=8):
    x, y, o, ws = make_data(seed, n, d, binary)
    jb, tb = batches(x, y, o, ws)
    jn, tn = normalizations(norm, x, intercept_index=d - 1)
    jl, tl = loss_pair(name)
    return (JaxObjective(jl, l2_weight=l2, normalization=jn).bind(jb),
            GLMObjective(tl, l2_weight=l2, normalization=tn).bind(tb), d)


def _assert_same_result(port, ref):
    assert port.iterations == int(ref.iterations)
    assert port.reason == int(ref.reason)
    k = port.iterations + 1
    np.testing.assert_allclose(to_np(port.value_history)[:k], to_np(ref.value_history)[:k],
                               rtol=RTOL)
    assert np.isnan(to_np(port.value_history)[k:]).all()
    np.testing.assert_allclose(to_np(port.coefficients), to_np(ref.coefficients),
                               rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(float(port.value), float(ref.value), rtol=RTOL)
    np.testing.assert_allclose(float(port.gradient_norm), float(ref.gradient_norm),
                               rtol=1e-6, atol=1e-9)


SMOOTH_CASES = [
    ("LogisticLoss", True, "NONE"),
    ("SquaredLoss", False, "SCALE_WITH_STANDARD_DEVIATION"),
    ("PoissonLoss", False, "STANDARDIZATION"),
    ("SmoothedHingeLoss", True, "NONE"),
]


@pytest.mark.parametrize("name,binary,norm", SMOOTH_CASES, ids=[c[0] for c in SMOOTH_CASES])
def test_lbfgs_matches(name, binary, norm):
    jo, to, d = _bound(name, binary, norm)
    ref = jax_lbfgs(jo.value_and_grad, jnp.zeros(d), max_iter=40, host_loop=True)
    port = minimize_lbfgs(to.value_and_grad, torch.zeros(d, dtype=torch.float64), max_iter=40)
    _assert_same_result(port, ref)


@pytest.mark.parametrize("name,binary", [("LogisticLoss", True), ("SquaredLoss", False)])
def test_lbfgsb_matches(name, binary):
    jo, to, d = _bound(name, binary, l2=0.1, seed=3)
    lo = np.full(d, -0.15)
    hi = np.full(d, 0.25)
    ref = jax_lbfgs(jo.value_and_grad, jnp.zeros(d), max_iter=30, host_loop=True,
                    lower_bounds=jnp.asarray(lo), upper_bounds=jnp.asarray(hi))
    port = minimize_lbfgs(to.value_and_grad, torch.zeros(d, dtype=torch.float64), max_iter=30,
                          lower_bounds=torch.from_numpy(lo), upper_bounds=torch.from_numpy(hi))
    _assert_same_result(port, ref)
    w = to_np(port.coefficients)
    assert (w >= lo - 1e-12).all() and (w <= hi + 1e-12).all()
    assert ((w <= lo + 1e-9) | (w >= hi - 1e-9)).any()  # some bound is active


@pytest.mark.parametrize("name,binary,l1", [("LogisticLoss", True, 30.0),
                                            ("SquaredLoss", False, 20.0)])
def test_owlqn_matches(name, binary, l1):
    jo, to, d = _bound(name, binary, l2=0.1, seed=4)
    ref = jax_owlqn(jo.value_and_grad, jnp.zeros(d), l1_weight=l1, max_iter=40, host_loop=True)
    port = minimize_owlqn(to.value_and_grad, torch.zeros(d, dtype=torch.float64), l1_weight=l1,
                          max_iter=40)
    _assert_same_result(port, ref)
    assert (to_np(port.coefficients) == 0.0).any()  # L1 zeroes some coefficients


@pytest.mark.parametrize("name,binary,norm", SMOOTH_CASES[:3], ids=[c[0] for c in SMOOTH_CASES[:3]])
def test_tron_matches(name, binary, norm):
    jo, to, d = _bound(name, binary, norm, seed=6)
    ref = jax_tron(jo.value_and_grad, jo.hessian_vector, jnp.zeros(d), host_loop=True)
    port = minimize_tron(to.value_and_grad, to.hessian_vector, torch.zeros(d, dtype=torch.float64))
    _assert_same_result(port, ref)


def test_tron_rel_function_tolerance_matches():
    jo, to, d = _bound("LogisticLoss", True, seed=7)
    ref = jax_tron(jo.value_and_grad, jo.hessian_vector, jnp.zeros(d), tolerance=1e-12,
                   rel_function_tolerance=1e-6, host_loop=True)
    port = minimize_tron(to.value_and_grad, to.hessian_vector, torch.zeros(d, dtype=torch.float64),
                         tolerance=1e-12, rel_function_tolerance=1e-6)
    _assert_same_result(port, ref)
    assert port.reason == common.ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE


def test_two_loop_direction_matches():
    rng = np.random.default_rng(0)
    m, d = 5, 7
    s, y = rng.normal(size=(m, d)), rng.normal(size=(m, d))
    y += 2.0 * s  # positive curvature pairs
    rho = 1.0 / np.einsum("ij,ij->i", s, y)
    g = rng.normal(size=d)
    for count, head in [(0, 0), (3, 2), (5, 1)]:
        ref = jax_two_loop(jnp.asarray(g), jnp.asarray(s), jnp.asarray(y), jnp.asarray(rho),
                           jnp.int32(count), jnp.int32(head))
        got = two_loop_direction(torch.from_numpy(g), torch.from_numpy(s), torch.from_numpy(y),
                                 torch.from_numpy(rho), count, head)
        np.testing.assert_allclose(got.numpy(), to_np(ref), rtol=1e-12, atol=1e-14)


def test_wolfe_line_search_matches():
    jo, to, d = _bound("LogisticLoss", True, seed=9)
    w = np.zeros(d)
    f0j, g0j = jo.value_and_grad(jnp.asarray(w))
    f0t, g0t = to.value_and_grad(torch.from_numpy(w))
    for scale in (1.0, 50.0, 1e-4):  # accepted, shrunk, expanded
        ref = jax_common.wolfe_line_search(jo.value_and_grad, jnp.asarray(w), f0j, g0j,
                                           -scale * g0j, jnp.asarray(1.0), host_loop=True)
        got = common.wolfe_line_search(to.value_and_grad, torch.from_numpy(w), f0t, g0t,
                                       -scale * g0t, torch.tensor(1.0, dtype=torch.float64))
        assert got.success == bool(ref.success)
        np.testing.assert_allclose(float(got.step), float(ref.step), rtol=1e-12)
        np.testing.assert_allclose(float(got.value), float(ref.value), rtol=1e-12)


def test_check_convergence_and_pseudo_gradient():
    cases = [(1.0, 1.0 + 1e-9, 1e-9, 5.0), (1.0, 2.0, 1e-9, 5.0), (1.0, 2.0, 3.0, 5.0),
             (0.0, 0.0, 0.0, 0.0)]
    for v, pv, gn, g0 in cases:
        for rft in (None, 1e-3):
            ref = jax_common.check_convergence(
                value=jnp.asarray(v), prev_value=jnp.asarray(pv), grad_norm=jnp.asarray(gn),
                initial_grad_norm=jnp.asarray(g0), tolerance=1e-7, rel_function_tolerance=rft)
            t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
            got = common.check_convergence(value=t(v), prev_value=t(pv), grad_norm=t(gn),
                                           initial_grad_norm=t(g0), tolerance=1e-7,
                                           rel_function_tolerance=rft)
            assert got == int(ref)
    w = np.array([1.0, -1.0, 0.0, 0.0, 0.0])
    g = np.array([0.5, 0.5, -3.0, 3.0, 0.1])
    ref = jax_pseudo_gradient(jnp.asarray(w), jnp.asarray(g), jnp.asarray(1.0))
    got = pseudo_gradient(torch.from_numpy(w), torch.from_numpy(g), torch.tensor(1.0,
                          dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), to_np(ref))


def test_states_table_matches():
    jo, to, d = _bound("SquaredLoss", False, seed=2)
    ref = jax_lbfgs(jo.value_and_grad, jnp.zeros(d), max_iter=5, host_loop=True)
    port = minimize_lbfgs(to.value_and_grad, torch.zeros(d, dtype=torch.float64), max_iter=5)
    assert port.states_table() == ref.states_table()
    assert port.converged


def test_solve_dispatch():
    _, to, d = _bound("SmoothedHingeLoss", True)
    w0 = torch.zeros(d, dtype=torch.float64)
    with pytest.raises(ValueError, match="resolve_auto_optimizer"):
        solve(OptimizerConfig(OptimizerType.AUTO), to, w0)
    with pytest.raises(ValueError, match="twice-differentiable"):
        solve(OptimizerConfig(OptimizerType.NEWTON), to, w0)
    with pytest.raises(ValueError, match="twice-differentiable"):
        solve(OptimizerConfig(OptimizerType.TRON), to, w0)
    with pytest.raises(ValueError, match="LBFGSB requires"):
        solve(OptimizerConfig(OptimizerType.LBFGSB), to, w0)
    with pytest.raises(ValueError, match="LBFGS family"):
        solve(OptimizerConfig(OptimizerType.OWLQN), to, w0, lower_bounds=w0 - 1.0)
    res = solve(OptimizerConfig(OptimizerType.LBFGS, max_iterations=3), to, w0)
    assert res.iterations == 3


def test_optimizer_config_helpers_match():
    for t in OptimizerType:
        port, ref = default_config_for(t), jax_default_config_for(JaxType[t.name])
        assert (port.max_iterations, port.tolerance) == (ref.max_iterations, ref.tolerance)
    for l1 in (0.0, 0.5):
        for small, loss in ((False, None), (True, loss_pair("LogisticLoss")),
                            (True, loss_pair("SmoothedHingeLoss"))):
            port = resolve_auto_optimizer(OptimizerConfig(OptimizerType.AUTO, l1_weight=l1),
                                          loss=None if loss is None else loss[1],
                                          small_dense=small)
            ref = jax_resolve_auto(JaxConfig(JaxType.AUTO, l1_weight=l1),
                                   loss=None if loss is None else loss[0], small_dense=small)
            assert port.optimizer_type.name == ref.optimizer_type.name
    cfg = OptimizerConfig().with_l1(0.25)
    assert cfg.l1_weight == 0.25 and dataclasses.replace(cfg, l1_weight=0.0).l1_weight == 0.0
