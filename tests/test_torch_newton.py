"""The port's lane-batched Newton solver against the JAX package's
``minimize_newton`` under ``jax.vmap`` (``_solve_bucket_entities``), on the
CPU in float64: per-lane coefficients within 1e-9, iterations and reasons
equal; and the Cholesky solve against the Gauss-Jordan elimination."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.optim import newton as jnewton
from photon_ml_tpu.optim.optimizer import solve as jsolve
from photon_ml_torch.optim import newton as tnewton
from photon_ml_torch.optim.common import ConvergenceReason
from photon_ml_torch.optim.optimizer import solve as tsolve
from tests.torch_game_parity import optimizer_pair
from tests.torch_lane_parity import assert_lanes_equal, bucket, objectives, solve_both
from tests.torch_parity import batches, loss_pair, make_data, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _pd_systems(seed, batch, d):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(batch, d + 3, d))
    h = np.einsum("bnd,bne->bde", a, a) + 0.5 * np.eye(d)
    return h, rng.normal(size=(batch, d))


@pytest.mark.parametrize("batch,d", [(1, 1), (7, 4), (50, 16)])
def test_solve_pd_matches_gauss_jordan(batch, d):
    h, g = _pd_systems(0, batch, d)
    ref = np.asarray(jnewton._solve_pd(jnp.asarray(h), jnp.asarray(g)))
    p, ok = tnewton.solve_pd(torch.from_numpy(h), torch.from_numpy(g))
    assert bool(ok.all())
    np.testing.assert_allclose(p.numpy(), ref, rtol=1e-9, atol=1e-12)
    gj = tnewton.solve_pd_gauss_jordan(torch.from_numpy(h), torch.from_numpy(g))
    np.testing.assert_allclose(gj.numpy(), ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.einsum("bde,be->bd", h, p.numpy()), g, rtol=1e-8, atol=1e-10)


def test_solve_pd_flags_a_matrix_that_is_not_positive_definite():
    h = np.stack([np.eye(3), -np.eye(3), np.full((3, 3), np.nan)])
    p, ok = tnewton.solve_pd(torch.from_numpy(h), torch.ones((3, 3), dtype=torch.float64))
    assert ok.tolist() == [True, False, False]
    assert p.shape == (3, 3)


def test_alphas_match():
    assert tnewton._ALPHAS == jnewton._ALPHAS


@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
@pytest.mark.parametrize("loss_name", ["LogisticLoss", "SquaredLoss", "PoissonLoss"])
def test_newton_lanes_match(loss_name, norm):
    x, y, weights, offsets, w0 = bucket(3, loss_name)
    jobj, tobj = objectives(loss_name, 1.0, norm, x)
    jopt, topt = optimizer_pair("NEWTON", 10)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got)
    its = got[1].iterations.numpy()
    if loss_name != "SquaredLoss":
        assert len(set(its.tolist())) > 1  # lanes finish at different iterations
    assert got[1].valid.all()


@pytest.mark.parametrize("kw", [dict(max_iterations=2), dict(max_iterations=15, tolerance=1e-9),
                                dict(max_iterations=8, rel_function_tolerance=1e-3)],
                         ids=["cut-at-2", "tight", "function-stop"])
def test_newton_lanes_stopping_rules_match(kw):
    x, y, weights, offsets, w0 = bucket(4, "LogisticLoss", lanes=12)
    jobj, tobj = objectives("LogisticLoss", 0.1, "NONE", x)
    jopt, topt = optimizer_pair("NEWTON", **kw)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got)
    if kw["max_iterations"] == 2:
        assert int(ConvergenceReason.MAX_ITERATIONS) in got[1].reason.tolist()


def test_newton_overshoot_grows_the_damping():
    """Poisson lanes started in a flat region: a full step overshoots past
    the 16x shrink range, the round is rejected and the damping grows; the
    port follows the reference lane by lane."""
    x, y, weights, offsets, w0 = bucket(5, "PoissonLoss", lanes=6)
    w0 = w0 - 6.0 * (np.arange(4) == 3)  # intercepts far below
    jobj, tobj = objectives("PoissonLoss", 1e-3, "NONE", x)
    jopt, topt = optimizer_pair("NEWTON", 25)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, tol=1e-8)


def test_newton_non_finite_lane_does_not_stall_the_others():
    x, y, weights, offsets, w0 = bucket(6, "LogisticLoss", nan_lane=2)
    jobj, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("NEWTON", 10)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, skip=(2,))
    # the rejected lane keeps its warm start
    np.testing.assert_array_equal(got[0].numpy()[2], w0[2])


def test_newton_stationary_start_stops_before_the_first_solve():
    x, y, weights, offsets, w0 = bucket(7, "SquaredLoss")
    jobj, tobj = objectives("SquaredLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("NEWTON", 10)
    (_, _), (solved, _) = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, solved.numpy())
    assert_lanes_equal(ref, got)
    assert got[1].iterations[1] == 0  # the all-padding lane sits at its optimum 0... 
    assert np.array_equal(np.asarray(ref[1].iterations), got[1].iterations.numpy())


@pytest.mark.parametrize("loss_name", ["LogisticLoss", "SquaredLoss", "PoissonLoss"])
def test_solve_newton_single_problem_matches(loss_name):
    """``solve`` with NEWTON on one dense problem (a single lane)."""
    binary = loss_name == "LogisticLoss"
    x, y, o, ws = make_data(11, 300, 5, binary)
    if loss_name == "PoissonLoss":
        y = np.round(y)
    jb, tb = batches(x, y, o, ws)
    jobj, tobj = objectives(loss_name, 0.5, "NONE", x[None])
    jopt, topt = optimizer_pair("NEWTON", 15)
    ref = jsolve(jopt, jobj.bind(jb), jnp.zeros(5))
    got = tsolve(topt, tobj.bind(tb), torch.zeros(5, dtype=torch.float64))
    assert got.iterations == int(ref.iterations) and got.reason == int(ref.reason)
    np.testing.assert_allclose(to_np(got.coefficients), to_np(ref.coefficients), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(float(got.value), float(ref.value), rtol=1e-12)
    assert np.isfinite(to_np(got.value_history)[[0, got.iterations]]).all()


def test_solve_newton_needs_a_twice_differentiable_loss():
    x, y, o, ws = make_data(12, 50, 3, True)
    _, tb = batches(x, y, o, ws)
    _, tobj = objectives("SmoothedHingeLoss", 0.5, "NONE", x[None])
    _, topt = optimizer_pair("NEWTON", 5)
    with pytest.raises(ValueError, match="twice-differentiable"):
        tsolve(topt, tobj.bind(tb), torch.zeros(3, dtype=torch.float64))
    assert loss_pair("SmoothedHingeLoss")[1].twice_differentiable is False
