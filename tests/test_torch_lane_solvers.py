"""The port's lane-batched L-BFGS against ``jax.vmap`` of the JAX package's
``minimize_lbfgs`` (``_solve_bucket_entities``), on the CPU in float64:
per-lane coefficients within 1e-9, iterations and reasons equal, with lanes
that finish at different iterations, a padding lane and a lane whose line
search fails; and the lane forms of the line search and the two-loop
recursion against their single-problem versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.optim import common as jcommon
from photon_ml_tpu.optim import lbfgs as jlbfgs
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.ops.lane_objective import LaneObjective
from photon_ml_torch.optim import common as tcommon
from photon_ml_torch.optim import lanes as tlanes
from photon_ml_torch.optim.common import ConvergenceReason
from photon_ml_torch.optim.lbfgs import minimize_lbfgs, two_loop_direction
from tests.torch_game_parity import optimizer_pair
from tests.torch_lane_parity import assert_lanes_equal, bucket, objectives, solve_both
from tests.torch_parity import LOSSES, batches, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
@pytest.mark.parametrize("loss_name", [name for name, _ in LOSSES])
def test_lbfgs_lanes_match(loss_name, norm):
    x, y, weights, offsets, w0 = bucket(0, loss_name)
    jobj, tobj = objectives(loss_name, 1.0, norm, x)
    jopt, topt = optimizer_pair("LBFGS", 25)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got)
    assert len(set(got[1].iterations.tolist())) > 1  # lanes finish at different iterations


@pytest.mark.parametrize("kw", [dict(max_iterations=3), dict(max_iterations=40, history=3),
                                dict(max_iterations=12, rel_function_tolerance=1e-4),
                                dict(max_iterations=30, tolerance=1e-10)],
                         ids=["cut-at-3", "short-history", "function-stop", "tight"])
def test_lbfgs_lanes_stopping_rules_match(kw):
    x, y, weights, offsets, w0 = bucket(1, "LogisticLoss", lanes=11, k=5)
    jobj, tobj = objectives("LogisticLoss", 0.3, "NONE", x)
    jopt, topt = optimizer_pair("LBFGS", **kw)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got)
    if kw["max_iterations"] == 3:
        assert int(ConvergenceReason.MAX_ITERATIONS) in got[1].reason.tolist()


def test_lbfgs_line_search_failure_in_one_lane_does_not_stall_the_others():
    x, y, weights, offsets, w0 = bucket(2, "LogisticLoss", nan_lane=3)
    jobj, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("LBFGS", 20)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, skip=(3,))
    assert got[1].reason[3] == int(ConvergenceReason.LINE_SEARCH_FAILED)
    assert got[1].iterations[3] == 1
    np.testing.assert_array_equal(got[0].numpy()[3], w0[3])  # it keeps its warm start
    others = np.delete(got[1].reason.numpy(), 3)
    assert int(ConvergenceReason.LINE_SEARCH_FAILED) not in others.tolist()


def test_padding_lane_solves_a_zero_problem_and_is_masked():
    """Lane 1 has all weights 0: its objective is the L2 term alone. Its
    trace is marked invalid by the bucket solve when its entity row is out
    of range, and its result is not written to the table."""
    x, y, weights, offsets, w0 = bucket(3, "SquaredLoss", lanes=5)
    jobj, tobj = objectives("SquaredLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("LBFGS", 15)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got)
    assert float(np.abs(got[0].numpy()[1]).max()) < 1e-6

    from photon_ml_tpu.algorithm import coordinates as jcoord
    n = 200
    rng = np.random.default_rng(0)
    sample_rows = rng.integers(0, n, size=weights.shape).astype(np.int32)
    sample_rows[weights == 0] = -1
    entity_rows = np.array([4, 2**31 - 1, 0, 6, 3], dtype=np.int32)  # lane 1: the sentinel
    full_offsets = rng.normal(size=n)
    table = rng.normal(size=(7, x.shape[-1]))
    jt, jtrace = jcoord.solve_entity_bucket_traced(
        jobj, jopt, *(jnp.asarray(a) for a in (x, y, weights, sample_rows, entity_rows,
                                               full_offsets, table)))
    t = torch.from_numpy
    tt, ttrace = tcoord.solve_entity_bucket_traced(
        tobj, topt, t(x), t(y), t(weights), t(sample_rows), t(entity_rows), t(full_offsets),
        t(table))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-9, atol=1e-10)
    assert np.array_equal(np.asarray(jtrace.valid), ttrace.valid.numpy())
    assert ttrace.valid.tolist() == [True, False, True, True, True]
    assert np.array_equal(np.asarray(jtrace.iterations)[ttrace.valid.numpy()],
                          ttrace.iterations.numpy()[ttrace.valid.numpy()])
    for untouched in (1, 2, 5):
        assert np.array_equal(tt.numpy()[untouched], table[untouched])
    only = tcoord.solve_entity_bucket(
        tobj, topt, t(x), t(y), t(weights), t(sample_rows), t(entity_rows), t(full_offsets),
        t(table))
    assert torch.equal(only, tt)
    hist = tcoord.lane_iteration_histogram(tcommon.LaneTraces([ttrace]))
    assert sum(hist.values()) == 4 and tcoord.lane_iteration_histogram(None) == {}


def test_bucket_offsets_match():
    from photon_ml_tpu.algorithm import coordinates as jcoord
    rows = np.array([[0, 3, -1], [2, -1, -1]], dtype=np.int32)
    full = np.array([1.0, 2.0, 3.0, 4.0])
    ref = np.asarray(jcoord._bucket_offsets(jnp.asarray(rows), jnp.asarray(full)))
    got = tcoord._bucket_offsets(torch.from_numpy(rows), torch.from_numpy(full)).numpy()
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("kind", ["LBFGSB"])
def test_lanes_out_of_the_slice_raise(kind):
    """LBFGSB lanes raise the reference's own error: the JAX package's
    vmapped solve passes no box constraints. OWL-QN and TRON lanes are
    held against the reference in ``tests/test_torch_re_lanes.py``."""
    x, y, weights, offsets, w0 = bucket(4, "LogisticLoss", lanes=3)
    jobj, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair(kind, 5)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints$"):
        tcoord._solve_bucket_entities(tobj, topt, t(x), t(y), t(weights), t(offsets), t(w0))
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints"):
        solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)  # JAX may add a note
    _, auto = optimizer_pair("AUTO", 5)
    with pytest.raises(ValueError, match="AUTO"):
        tcoord._solve_bucket_entities(tobj, auto, t(x), t(y), t(weights), t(offsets), t(w0))
    _, newton = optimizer_pair("NEWTON", 5)
    _, hinge = objectives("SmoothedHingeLoss", 1.0, "NONE", x)
    with pytest.raises(ValueError, match="twice-differentiable"):
        tcoord._solve_bucket_entities(hinge, newton, t(x), t(y), t(weights), t(offsets), t(w0))


@pytest.mark.parametrize("loss_name,binary", LOSSES)
@pytest.mark.parametrize("norm", ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"])
def test_lane_objective_matches_single_problem_objective(loss_name, binary, norm):
    """Value, gradient, Hessian and Hessian diagonal of every lane equal the
    JAX package's GLMObjective on that lane's batch."""
    x, y, weights, offsets, w0 = bucket(5, loss_name, lanes=4, cap=10)
    jobj, tobj = objectives(loss_name, 0.7, norm, x)
    t = torch.from_numpy
    lanes = LaneObjective(tobj.loss, t(x), t(y), t(offsets), t(weights), l2_weight=0.7,
                          normalization=tobj.normalization)
    w = np.random.default_rng(1).normal(size=w0.shape) * 0.3
    value, grad = lanes.value_and_grad(t(w))
    hess, diag = lanes.hessian_matrix(t(w)), lanes.hessian_diagonal(t(w))
    cands = np.stack([w, w + 0.1, w * 0.5], axis=1)
    cand_values = lanes.value(t(cands))
    for i in range(x.shape[0]):
        jb, _ = batches(x[i], y[i], offsets[i], weights[i])
        rv, rg = jobj.value_and_gradient(jnp.asarray(w[i]), jb)
        np.testing.assert_allclose(float(value[i]), float(rv), rtol=1e-12)
        np.testing.assert_allclose(grad[i].numpy(), np.asarray(rg), rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(float(lanes.value(t(w))[i]), float(rv), rtol=1e-12)
        for a in range(3):
            np.testing.assert_allclose(float(cand_values[i, a]),
                                       float(jobj.value(jnp.asarray(cands[i, a]), jb)),
                                       rtol=1e-12)
        if tobj.loss.twice_differentiable:
            np.testing.assert_allclose(hess[i].numpy(),
                                       np.asarray(jobj.hessian_matrix(jnp.asarray(w[i]), jb)),
                                       rtol=1e-9, atol=1e-11)
            np.testing.assert_allclose(diag[i].numpy(),
                                       np.asarray(jobj.hessian_diagonal(jnp.asarray(w[i]), jb)),
                                       rtol=1e-9, atol=1e-11)


def test_wolfe_line_search_lanes_matches_vmapped_search():
    x, y, weights, offsets, w0 = bucket(6, "LogisticLoss", lanes=8)
    jobj, tobj = objectives("LogisticLoss", 0.5, "NONE", x)
    t = torch.from_numpy
    lanes = LaneObjective(tobj.loss, t(x), t(y), t(offsets), t(weights), l2_weight=0.5)
    f0, g0 = lanes.value_and_grad(t(w0))
    direction = -g0
    t_init = torch.tensor([1.0, 1.0, 8.0, 0.01, 1e-4, 3.0, 0.5, 64.0], dtype=torch.float64)
    active = torch.tensor([True, True, True, True, True, False, True, True])
    step, f_new, g_new, ok = tcommon.wolfe_line_search_lanes(
        lanes.value_and_grad, t(w0), f0, g0, direction, t_init, active)

    def one(xi, yi, oi, wi, w0i, di, ti):
        from photon_ml_tpu.data.batch import LabeledPointBatch
        b = LabeledPointBatch(features=xi, labels=yi, offsets=oi, weights=wi)
        fn = jobj.bind(b).value_and_grad
        f, g = fn(w0i)
        return jcommon.wolfe_line_search(fn, w0i, f, g, di, ti)

    ref = jax.vmap(one)(*(jnp.asarray(a) for a in (x, y, offsets, weights, w0,
                                                   direction.numpy(), t_init.numpy())))
    on = active.numpy()
    np.testing.assert_allclose(step.numpy()[on], np.asarray(ref.step)[on], rtol=1e-12)
    np.testing.assert_allclose(f_new.numpy()[on], np.asarray(ref.value)[on], rtol=1e-12)
    np.testing.assert_allclose(g_new.numpy()[on], np.asarray(ref.gradient)[on], rtol=1e-9,
                               atol=1e-12)
    assert np.array_equal(ok.numpy()[on], np.asarray(ref.success)[on])
    # the inactive lane kept its starting state
    assert float(step[5]) == 0.0 and torch.equal(f_new[5], f0[5]) and not bool(ok[5])


@pytest.mark.parametrize("pairs", [0, 2, 4])
def test_two_loop_direction_lanes_matches(pairs):
    rng = np.random.default_rng(7)
    lanes, m, d = 5, 4, 6
    s = rng.normal(size=(lanes, m, d))
    yv = s + 0.1 * rng.normal(size=(lanes, m, d))
    rho = 1.0 / np.einsum("lmd,lmd->lm", s, yv)
    g = rng.normal(size=(lanes, d))
    count = np.minimum(np.array([0, 1, 2, 3, 4]), pairs)
    head = np.array([0, 0, 1, 2, 1])
    t = torch.from_numpy
    got = tlanes.two_loop_direction_lanes(t(g), t(s), t(yv), t(rho), t(count), t(head), pairs)
    for i in range(lanes):
        ref = jlbfgs.two_loop_direction(jnp.asarray(g[i]), jnp.asarray(s[i]), jnp.asarray(yv[i]),
                                        jnp.asarray(rho[i]), jnp.int32(count[i]),
                                        jnp.int32(head[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
        single = two_loop_direction(t(g[i]), t(s[i]), t(yv[i]), t(rho[i]), int(count[i]),
                                    int(head[i]))
        np.testing.assert_allclose(got[i].numpy(), single.numpy(), rtol=1e-10, atol=1e-12)


def test_one_lane_follows_the_single_problem_solver():
    """A bucket of one lane takes the iterations of ``minimize_lbfgs``."""
    x, y, weights, offsets, w0 = bucket(8, "LogisticLoss", lanes=1, cap=40, k=5)
    _, tobj = objectives("LogisticLoss", 0.2, "NONE", x)
    t = torch.from_numpy
    lanes = LaneObjective(tobj.loss, t(x), t(y), t(offsets), t(weights), l2_weight=0.2)
    got = tlanes.minimize_lbfgs_lanes(lanes.value_and_grad, t(w0), max_iter=30)
    _, tb = batches(x[0], y[0], offsets[0], weights[0])
    ref = minimize_lbfgs(tobj.bind(tb).value_and_grad, t(w0[0]), max_iter=30)
    assert int(got.iterations[0]) == ref.iterations and int(got.reason[0]) == ref.reason
    np.testing.assert_allclose(got.coefficients[0].numpy(), to_np(ref.coefficients), rtol=1e-9,
                               atol=1e-11)


def test_check_convergence_lanes_matches():
    rng = np.random.default_rng(9)
    v, pv = rng.normal(size=40), rng.normal(size=40)
    pv[:10] = v[:10] * (1 + 1e-9)
    gn, g0 = np.abs(rng.normal(size=40)), np.abs(rng.normal(size=40)) * 10
    gn[5:15] = 1e-9
    for rft in (None, 1e-3):
        ref = jax.vmap(lambda a, b, c, e: jcommon.check_convergence(
            value=a, prev_value=b, grad_norm=c, initial_grad_norm=e, tolerance=1e-7,
            rel_function_tolerance=rft))(*(jnp.asarray(a) for a in (v, pv, gn, g0)))
        t = torch.from_numpy
        got = tcommon.check_convergence_lanes(value=t(v), prev_value=t(pv), grad_norm=t(gn),
                                              initial_grad_norm=t(g0), tolerance=1e-7,
                                              rel_function_tolerance=rft)
        assert got.dtype == torch.int32 and np.array_equal(np.asarray(ref), got.numpy())
