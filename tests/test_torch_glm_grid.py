"""The port's λ-grid lanes (``estimators.train_glm_grid``) and configuration
tournaments (``algorithm/lane_search.py``, ``train_glm_tournament``) against
the JAX package's, on the CPU in float64, on dense and sparse batches:
coefficients and variances within 1e-8·max|w|, per-lane iterations and
reasons equal, the uniform tournament bitwise the grid in the port, and the
refusals with the JAX package's messages."""

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import lane_search as jls
from photon_ml_tpu.evaluation.evaluators import EvaluationData as JData
from photon_ml_tpu.evaluation.evaluators import parse_evaluator as jparse
from photon_ml_tpu.evaluation.sharded import device_evaluator as jdevice_evaluator
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
from photon_ml_tpu.optim.optimizer import OptimizerType as JType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm import lane_search as tls
from photon_ml_torch.evaluation.evaluators import EvaluationData as TData
from photon_ml_torch.evaluation.evaluators import parse_evaluator as tparse
from photon_ml_torch.evaluation.sharded import device_evaluator as tdevice_evaluator
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOpt
from photon_ml_torch.optim.optimizer import OptimizerType as TType
from photon_ml_torch.types import TaskType as TTask
from tests.test_torch_sparse_objective import batch_pair, sparse_problem
from tests.torch_parity import batches, make_data, normalizations, to_np

RTOL = 1e-8
LAMBDAS = (0.03, 0.3, 3.0, 30.0)
D = 6


def _dense(seed=0, n=300, d=D):
    x, y, offsets, weights = make_data(seed, n, d, True)
    jb, tb = batches(x, y, offsets, weights)
    return jb, tb, x


def _sparse():
    problem = sparse_problem(seed=21, binary=True)
    tb, jb = batch_pair("ell_tail", problem)
    return jb, tb, problem[-1]


def _close(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.nanmax(np.abs(ref)), 1e-30))


CASES = {
    "lbfgs": dict(),
    "elastic-net": dict(elastic_net_alpha=0.5),
    "owlqn-l1": dict(kind="OWLQN", l1=0.2),
    "box": dict(box=True),
    "diagonal-variances": dict(compute_variance=True, variance_mode="diagonal"),
    "full-variances": dict(compute_variance=True, variance_mode="full"),
}


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grid_matches(case, layout):
    kw = dict(CASES[case])
    if layout == "sparse" and case == "full-variances":
        kw["variance_mode"] = "auto"  # a sparse objective has no dense Hessian
    jb, tb, x = _dense() if layout == "dense" else _sparse()
    d = x.shape[1]
    jn, tn = normalizations("SCALE_WITH_STANDARD_DEVIATION", x, intercept_index=d - 1)
    kind, l1 = kw.pop("kind", "LBFGS"), kw.pop("l1", 0.0)
    common = dict(regularization_weights=LAMBDAS, intercept_index=d - 1, **kw)
    if common.pop("box", False):
        common.update(lower_bounds=np.full(d, -0.3), upper_bounds=np.full(d, 0.25))
    ref = jest.train_glm_grid(jb, JTask.LOGISTIC_REGRESSION, normalization=jn,
                              optimizer=JOpt(JType[kind], 60, 1e-8, l1_weight=l1), **common)
    got = test_.train_glm_grid(tb, TTask.LOGISTIC_REGRESSION, normalization=tn,
                               optimizer=TOpt(TType[kind], 60, 1e-8, l1_weight=l1), **common)
    assert sorted(ref) == sorted(got)
    for lam in ref:
        _close(got[lam].coefficients.means, ref[lam].coefficients.means)
        rv, gv = ref[lam].coefficients.variances, got[lam].coefficients.variances
        assert (rv is None) == (gv is None)
        if rv is not None:
            _close(gv, rv)


def _configs(mod, lanes, d, *, box=False, l1=True):
    rng = np.random.default_rng(4)
    l2 = np.geomspace(0.01, 10.0, lanes)
    lo = hi = None
    if box:
        lo = np.where(rng.uniform(size=(lanes, 1)) < 0.5, -0.2, -np.inf) * np.ones((1, d))
        hi = np.where(np.isinf(lo), np.inf, 0.3)
    return mod.LaneConfigs(l2=l2, l1=(0.1 * l2 if l1 else np.zeros(lanes)),
                           tolerance=np.geomspace(1e-4, 1e-9, lanes), lower_bounds=lo,
                           upper_bounds=hi)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("lanes", ["owlqn-lanes", "box-lanes", "warm-lbfgs"])
def test_tournament_matches(lanes, layout):
    jb, tb, x = _dense(1) if layout == "dense" else _sparse()
    d = x.shape[1]
    jn, tn = normalizations("STANDARDIZATION", x, intercept_index=d - 1)
    box, l1 = lanes == "box-lanes", lanes == "owlqn-lanes"
    warm = (0.1 * np.random.default_rng(9).normal(size=(6, d))) if lanes == "warm-lbfgs" else None
    common = dict(intercept_index=d - 1, warm_start=warm)
    ref = jest.train_glm_tournament(jb, JTask.LOGISTIC_REGRESSION,
                                    _configs(jls, 6, d, box=box, l1=l1), normalization=jn,
                                    optimizer=JOpt(JType.LBFGS, 50), **common)
    got = test_.train_glm_tournament(tb, TTask.LOGISTIC_REGRESSION,
                                     _configs(tls, 6, d, box=box, l1=l1), normalization=tn,
                                     optimizer=TOpt(TType.LBFGS, 50), **common)
    assert np.array_equal(np.asarray(ref.results.iterations), got.results.iterations.numpy())
    assert np.array_equal(np.asarray(ref.results.reason), got.results.reason.numpy())
    assert len(set(got.results.iterations.tolist())) > 1
    _close(got.results.coefficients, ref.results.coefficients)
    for rm, gm in zip(ref.models, got.models):
        _close(gm.coefficients.means, rm.coefficients.means)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_uniform_tournament_is_bitwise_the_grid(alpha, layout, dtype):
    if layout == "dense":
        x, y, offsets, weights = make_data(2, 300, D, True)
        from photon_ml_torch import convert

        tb = convert.batch_from_numpy(x, y, offsets, weights, dtype=dtype, device="cpu")
    else:
        problem = sparse_problem(seed=21, binary=True)
        tb, _ = batch_pair("ell_tail", problem,
                           dtype={torch.float64: np.float64, torch.float32: np.float32}[dtype])
    opt = TOpt(TType.LBFGS, 40, 1e-6, rel_function_tolerance=1e-7)
    lams = np.array(sorted(LAMBDAS))
    grid = test_.train_glm_grid(tb, TTask.LOGISTIC_REGRESSION, optimizer=opt,
                                regularization_weights=lams, elastic_net_alpha=alpha)
    configs = tls.LaneConfigs(l2=(1 - alpha) * lams, l1=alpha * lams,
                              tolerance=np.full(len(lams), opt.tolerance))
    tour = test_.train_glm_tournament(tb, TTask.LOGISTIC_REGRESSION, configs, optimizer=opt)
    for lam, model in zip(lams, tour.models):
        assert torch.equal(model.coefficients.means, grid[float(lam)].coefficients.means)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_use_kernel_false_is_the_cpu_path(layout):
    """``use_kernel=False`` (the plain gathers, the card's only f64 path)
    gives the default CPU grid bit for bit, scaled columns included."""
    _, tb, x = _dense(4) if layout == "dense" else _sparse()
    d = x.shape[1]
    _, tn = normalizations("SCALE_WITH_STANDARD_DEVIATION", x, intercept_index=d - 1)
    common = dict(optimizer=TOpt(TType.LBFGS, 30), regularization_weights=LAMBDAS,
                  normalization=tn, intercept_index=d - 1)
    ref = test_.train_glm_grid(tb, TTask.LOGISTIC_REGRESSION, **common)
    got = test_.train_glm_grid(tb, TTask.LOGISTIC_REGRESSION, use_kernel=False, **common)
    for lam in ref:
        assert torch.equal(got[lam].coefficients.means, ref[lam].coefficients.means)


def test_evaluation_on_device_matches():
    jb, tb, x = _dense(3)
    vx, vy, voff, vw = make_data(4, 200, D, True)
    jv, tv = batches(vx, vy, voff, vw)
    jn, tn = normalizations("STANDARDIZATION", x, intercept_index=D - 1)
    ref = jest.train_glm_tournament(jb, JTask.LOGISTIC_REGRESSION, _configs(jls, 5, D),
                                    normalization=jn, intercept_index=D - 1)
    got = test_.train_glm_tournament(tb, TTask.LOGISTIC_REGRESSION, _configs(tls, 5, D),
                                     normalization=tn, intercept_index=D - 1)
    for name in ("AUC", "LOGISTIC_LOSS", "RMSE"):
        jdev = jdevice_evaluator(jparse(name), JData(labels=vy, offsets=voff, weights=vw))
        tdev = tdevice_evaluator(tparse(name), TData(labels=vy, offsets=voff, weights=vw))
        jobj = jest._objective_for_batch(jb, jest.loss_for_task(JTask.LOGISTIC_REGRESSION),
                                         0.0, jn)
        tobj = test_._objective_for_batch(tb, test_.loss_for_task(TTask.LOGISTIC_REGRESSION),
                                          0.0, tn)
        rm = jls.evaluate_tournament_on_device(jobj, jdev.compute, jv, ref.results.coefficients,
                                               jdev.consts, D - 1)
        gm = tls.evaluate_tournament_on_device(tobj, tdev.compute, tv, got.results.coefficients,
                                               tdev.consts, D - 1)
        np.testing.assert_allclose(gm.numpy(), np.asarray(rm), rtol=1e-8)


def _refusals(case):
    jb, tb, x = _dense(5, n=60)
    out = []
    for mod, b, task, opt, cfg, LaneConfigs in (
            (jest, jb, JTask.LOGISTIC_REGRESSION, JOpt, JType, jls.LaneConfigs),
            (test_, tb, TTask.LOGISTIC_REGRESSION, TOpt, TType, tls.LaneConfigs)):
        with pytest.raises(ValueError) as err:
            if case == "tron":
                mod.train_glm_grid(b, task, optimizer=opt(cfg.TRON))
            elif case == "owlqn-box":
                mod.train_glm_grid(b, task, elastic_net_alpha=0.5, lower_bounds=np.zeros(D))
            elif case == "tournament-tron":
                mod.train_glm_tournament(b, task, LaneConfigs(np.ones(2), np.zeros(2),
                                                              np.ones(2)), optimizer=opt(cfg.TRON))
            elif case == "tournament-owlqn-box":
                mod.train_glm_tournament(b, task, LaneConfigs(
                    np.ones(2), np.ones(2), np.ones(2), np.zeros((2, D)), np.ones((2, D))))
            elif case == "shapes":
                LaneConfigs(np.ones(2), np.ones(3), np.ones(2))
            elif case == "half-box":
                LaneConfigs(np.ones(2), np.ones(2), np.ones(2), lower_bounds=np.zeros((2, D)))
            else:
                mod.train_glm_tournament(b, task, LaneConfigs(np.ones(2), np.zeros(2),
                                                              np.ones(2)),
                                         warm_start=np.zeros((3, D)))
        out.append(str(err.value).splitlines()[0])
    return out


@pytest.mark.parametrize("case", ["tron", "owlqn-box", "tournament-tron", "tournament-owlqn-box",
                                  "shapes", "half-box", "warm-start-shape"])
def test_refusals_match(case):
    ref, got = _refusals(case)
    if case == "warm-start-shape":  # torch.Size prints as a tuple in the port
        assert got.split(", got")[0] == ref.split(", got")[0]
    else:
        assert got == ref

