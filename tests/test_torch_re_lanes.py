"""The port's OWL-QN and TRON lanes against ``jax.vmap`` of the JAX package's
single-problem solvers (its ``_solve_bucket_entities``), on the CPU in
float64: per-lane coefficients within rel 1e-8, iterations and reasons
equal, with lanes that finish at different iterations and a padding lane;
one lane against the single-problem solvers; the lane Hessian-vector
product; and LBFGSB on a random effect raising the reference's error."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.optim import owlqn as jowlqn
from photon_ml_tpu.optim import tron as jtron
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.ops.lane_objective import LaneObjective
from photon_ml_torch.optim import common as tcommon
from photon_ml_torch.optim import owlqn as towlqn
from photon_ml_torch.optim import tron as ttron
from photon_ml_torch.optim.common import ConvergenceReason
from tests.torch_game_parity import optimizer_pair
from tests.torch_lane_parity import assert_lanes_equal, bucket, objectives, solve_both
from tests.torch_parity import LOSSES, batches

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

#: the twice-differentiable losses (TRON's domain)
SMOOTH = [name for name, _ in LOSSES if name != "SmoothedHingeLoss"]


@pytest.mark.parametrize("l1", [0.05, 0.5])
@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
@pytest.mark.parametrize("loss_name", [name for name, _ in LOSSES])
def test_owlqn_lanes_match(loss_name, norm, l1):
    x, y, weights, offsets, w0 = bucket(10, loss_name)
    jobj, tobj = objectives(loss_name, 0.5, norm, x)
    jopt, topt = optimizer_pair("OWLQN", 30, l1_weight=l1)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, tol=1e-8)
    assert len(set(got[1].iterations.tolist())) > 1
    assert (got[0].numpy() == 0.0).any()  # L1 puts coefficients at exactly 0


@pytest.mark.parametrize("kw", [dict(max_iterations=3), dict(max_iterations=40, history=3),
                                dict(max_iterations=20, rel_function_tolerance=1e-4)],
                         ids=["cut-at-3", "short-history", "function-stop"])
def test_owlqn_lanes_stopping_rules_match(kw):
    x, y, weights, offsets, w0 = bucket(11, "LogisticLoss", lanes=11, k=5)
    jobj, tobj = objectives("LogisticLoss", 0.2, "NONE", x)
    jopt, topt = optimizer_pair("OWLQN", l1_weight=0.1, **kw)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, tol=1e-8)
    if kw["max_iterations"] == 3:
        assert int(ConvergenceReason.MAX_ITERATIONS) in got[1].reason.tolist()


def test_owlqn_line_search_failure_in_one_lane_does_not_stall_the_others():
    x, y, weights, offsets, w0 = bucket(12, "LogisticLoss", nan_lane=3)
    jobj, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("OWLQN", 20, l1_weight=0.1)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, skip=(3,), tol=1e-8)
    assert got[1].reason[3] == int(ConvergenceReason.LINE_SEARCH_FAILED)
    np.testing.assert_array_equal(got[0].numpy()[3], w0[3])


@pytest.mark.parametrize("norm", ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"])
@pytest.mark.parametrize("loss_name", SMOOTH)
def test_tron_lanes_match(loss_name, norm):
    x, y, weights, offsets, w0 = bucket(13, loss_name)
    jobj, tobj = objectives(loss_name, 1.0, norm, x)
    jopt, topt = optimizer_pair("TRON", 15, tolerance=1e-5)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, tol=1e-8)
    assert len(set(got[1].iterations.tolist())) > 1


@pytest.mark.parametrize("kw", [dict(max_iterations=2),
                                dict(max_iterations=15, max_cg_iterations=2),
                                dict(max_iterations=15, rel_function_tolerance=1e-3)],
                         ids=["cut-at-2", "cg-cap-2", "function-stop"])
def test_tron_lanes_stopping_rules_match(kw):
    x, y, weights, offsets, w0 = bucket(14, "LogisticLoss", lanes=11, k=6)
    jobj, tobj = objectives("LogisticLoss", 0.3, "NONE", x)
    jopt, topt = optimizer_pair("TRON", tolerance=1e-5, **kw)
    ref, got = solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0)
    assert_lanes_equal(ref, got, tol=1e-8)
    if kw["max_iterations"] == 2:
        assert int(ConvergenceReason.MAX_ITERATIONS) in got[1].reason.tolist()


@pytest.mark.parametrize("kind", ["OWLQN", "TRON"])
def test_one_lane_follows_the_single_problem_solvers(kind):
    """A lane of the batch against the port's and the JAX package's
    single-problem solvers on that lane's own batch."""
    x, y, weights, offsets, w0 = bucket(15, "LogisticLoss", lanes=4)
    jobj, tobj = objectives("LogisticLoss", 0.5, "NONE", x)
    t = torch.from_numpy
    lanes = LaneObjective(tobj.loss, t(x), t(y), t(offsets), t(weights), l2_weight=0.5)
    if kind == "OWLQN":
        got = towlqn.minimize_owlqn_lanes(lanes.value_and_grad, t(w0), l1_weight=0.1,
                                          max_iter=25)
    else:
        got = ttron.minimize_tron_lanes(lanes.value_and_grad, lanes.hessian_vector_at, t(w0),
                                        max_iter=15, tolerance=1e-5)
    for i in range(x.shape[0]):
        jb, tb = batches(x[i], y[i], offsets[i], weights[i])
        tb_bound, jb_bound = tobj.bind(tb), jobj.bind(jb)
        if kind == "OWLQN":
            single = towlqn.minimize_owlqn(tb_bound.value_and_grad, t(w0[i]), l1_weight=0.1,
                                           max_iter=25)
            ref = jowlqn.minimize_owlqn(jb_bound.value_and_grad, jnp.asarray(w0[i]),
                                        l1_weight=0.1, max_iter=25)
        else:
            single = ttron.minimize_tron(tb_bound.value_and_grad, tb_bound.hessian_vector,
                                         t(w0[i]), max_iter=15, tolerance=1e-5)
            ref = jtron.minimize_tron(jb_bound.value_and_grad, jb_bound.hessian_vector,
                                      jnp.asarray(w0[i]), max_iter=15, tolerance=1e-5)
        assert int(got.iterations[i]) == single.iterations == int(ref.iterations)
        assert int(got.reason[i]) == single.reason == int(ref.reason)
        scale = max(1.0, float(np.abs(np.asarray(ref.coefficients)).max()))
        np.testing.assert_allclose(got.coefficients[i].numpy(), single.coefficients.numpy(),
                                   rtol=1e-8, atol=1e-8 * scale)
        np.testing.assert_allclose(got.coefficients[i].numpy(), np.asarray(ref.coefficients),
                                   rtol=1e-8, atol=1e-8 * scale)
        np.testing.assert_allclose(float(got.value[i]), float(ref.value), rtol=1e-10)


@pytest.mark.parametrize("norm", ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"])
@pytest.mark.parametrize("loss_name", SMOOTH)
def test_lane_hessian_vector_matches(loss_name, norm):
    x, y, weights, offsets, w0 = bucket(16, loss_name, lanes=4, cap=10)
    jobj, tobj = objectives(loss_name, 0.7, norm, x)
    t = torch.from_numpy
    lanes = LaneObjective(tobj.loss, t(x), t(y), t(offsets), t(weights), l2_weight=0.7,
                          normalization=tobj.normalization)
    rng = np.random.default_rng(1)
    w, v = rng.normal(size=w0.shape) * 0.3, rng.normal(size=w0.shape)
    hv = lanes.hessian_vector_at(t(w))(t(v))
    h = lanes.hessian_matrix(t(w))
    for i in range(x.shape[0]):
        jb, _ = batches(x[i], y[i], offsets[i], weights[i])
        ref = np.asarray(jobj.hessian_vector(jnp.asarray(w[i]), jnp.asarray(v[i]), jb))
        np.testing.assert_allclose(hv[i].numpy(), ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(hv.numpy(), torch.einsum("lkj,lj->lk", h, t(v)).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_lbfgsb_lanes_raise_the_references_error():
    """The JAX package's vmapped solve passes no box constraints, so LBFGSB
    on a random effect raises there; the port's lanes raise the same."""
    x, y, weights, offsets, w0 = bucket(17, "LogisticLoss", lanes=3)
    jobj, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("LBFGSB", 5)
    messages = []
    for call in (lambda: solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0),
                 lambda: tcoord._solve_bucket_entities(
                     tobj, topt, *(torch.from_numpy(a) for a in (x, y, weights, offsets, w0)))):
        with pytest.raises(ValueError) as err:
            call()
        messages.append(str(err.value))
    # a traced JAX call may append a traceback note to its message
    assert messages[1] == "LBFGSB requires box constraints"
    assert messages[0].splitlines()[0] == messages[1]


def test_tron_lanes_refuse_a_loss_that_is_not_twice_differentiable():
    x, y, weights, offsets, w0 = bucket(18, "SmoothedHingeLoss", lanes=3)
    jobj, tobj = objectives("SmoothedHingeLoss", 1.0, "NONE", x)
    jopt, topt = optimizer_pair("TRON", 5)
    messages = []
    for call in (lambda: solve_both(jobj, tobj, jopt, topt, x, y, weights, offsets, w0),
                 lambda: tcoord._solve_bucket_entities(
                     tobj, topt, *(torch.from_numpy(a) for a in (x, y, weights, offsets, w0)))):
        with pytest.raises(ValueError) as err:
            call()
        messages.append(str(err.value))
    assert messages[0].splitlines()[0] == messages[1] and "twice-differentiable" in messages[1]


@pytest.mark.parametrize("kind", ["OWLQN", "TRON", "LBFGS", "NEWTON"])
def test_lane_loops_count_their_host_reads(kind):
    """Each lane loop reads a lane mask on the host through ``any_lane``:
    TRON once per outer iteration (its CG runs its cap of steps with
    finished lanes frozen), OWL-QN and L-BFGS once per outer iteration and
    once per line-search trial."""
    x, y, weights, offsets, w0 = bucket(19, "LogisticLoss", lanes=5)
    _, tobj = objectives("LogisticLoss", 1.0, "NONE", x)
    _, topt = optimizer_pair(kind, 12, **({"l1_weight": 0.1} if kind == "OWLQN" else {}))
    before = tcommon.lane_host_reads
    _, trace = tcoord._solve_bucket_entities(
        tobj, topt, *(torch.from_numpy(a) for a in (x, y, weights, offsets, w0)))
    reads = tcommon.lane_host_reads - before
    outer = int(trace.iterations.max())
    if kind in ("TRON", "NEWTON"):
        assert reads == min(outer + 1, 12)
    else:
        assert reads > outer
