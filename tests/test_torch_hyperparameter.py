"""The port's hyperparameter search (``photon_ml_torch/hyperparameter``)
against the JAX package's: the numpy and scipy pieces (kernels, GP, expected
improvement, slice sampler, Sobol and GP searchers, rescaling) give equal
outputs bit for bit under the same seeds; ``run_model_search`` asks the same
configurations every round (1e-12) with metrics within 1e-8 on the CPU in
float64; the GAME tuner and its JSON files match."""

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu import hyperparameter as jh
from photon_ml_tpu.hyperparameter import game_glue as jglue
from photon_ml_tpu.hyperparameter import rescaling as jresc
from photon_ml_tpu.hyperparameter import search_driver as jsd
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import hyperparameter as th
from photon_ml_torch.hyperparameter import game_glue as tglue
from photon_ml_torch.hyperparameter import rescaling as tresc
from photon_ml_torch.hyperparameter import search_driver as tsd
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOpt
from photon_ml_torch.telemetry.registry import MetricsRegistry
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, estimator_pair, game_arrays
from tests.torch_parity import batches, make_data, normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _points(seed=0, n=9, d=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    return x, np.sin(3 * x).sum(axis=1) + 0.1 * rng.normal(size=n)


@pytest.mark.parametrize("kernel", ["Matern52", "RBF"])
def test_kernels_match(kernel):
    x, _ = _points()
    jk = getattr(jh, kernel)().with_params(1.3, 0.01, [0.4, 0.7, 1.1])
    tk = getattr(th, kernel)().with_params(1.3, 0.01, [0.4, 0.7, 1.1])
    assert np.array_equal(jk(x), tk(x)) and np.array_equal(jk(x, x[:3]), tk(x, x[:3]))


def test_acquisition_matches():
    rng = np.random.default_rng(1)
    mean, var = rng.normal(size=20), rng.uniform(0, 2, size=20)
    assert np.array_equal(jh.expected_improvement(mean, var, 0.2, 0.01),
                          th.expected_improvement(mean, var, 0.2, 0.01))
    assert np.array_equal(jh.confidence_bound(mean, var), th.confidence_bound(mean, var))


def test_slice_sampler_matches():
    def log_prob(x):
        return float(-0.5 * np.sum((x - 0.3) ** 2 / 0.2))

    a = jh.slice_sample(log_prob, np.zeros(3), np.random.default_rng(7), num_samples=5,
                        burn_in=3)
    b = th.slice_sample(log_prob, np.zeros(3), np.random.default_rng(7), num_samples=5,
                        burn_in=3)
    assert np.array_equal(a, b)


def test_gaussian_process_matches():
    x, y = _points(2)
    jm = jh.GaussianProcessEstimator(seed=3).fit(x, y)
    tm = th.GaussianProcessEstimator(seed=3).fit(x, y)
    q = np.random.default_rng(4).uniform(size=(6, 3))
    for a, b in zip(jm.predict(q), tm.predict(q)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kind", ["RandomSearch", "GaussianProcessSearch"])
def test_searchers_match(kind):
    def f(u):
        return float(np.sum((u - 0.4) ** 2))

    js = getattr(jh, kind)(2, seed=5)
    ts = getattr(th, kind)(2, seed=5)
    js.observe_prior(np.array([0.9, 0.1]), 0.5)
    ts.observe_prior(np.array([0.9, 0.1]), 0.5)
    jr, tr = js.find(f, 6), ts.find(f, 6)
    assert np.array_equal(jr.best_candidate, tr.best_candidate)
    assert jr.best_value == tr.best_value
    assert [o.value for o in jr.observations] == [o.value for o in tr.observations]
    assert np.array_equal(js.propose_batch(4), ts.propose_batch(4))


def test_rescaling_matches():
    specs = [("lambda", 1e-4, 1e2, True, False), ("alpha", 0.0, 1.0, False, False),
             ("box", 0.0, 1.0, False, True)]
    jr = jresc.VectorRescaling([jresc.DimensionSpec(*s) for s in specs])
    tr = tresc.VectorRescaling([tresc.DimensionSpec(*s) for s in specs])
    u = np.random.default_rng(6).uniform(size=(7, 3))
    assert np.array_equal(jr.to_hyperparameters(u), tr.to_hyperparameters(u))
    v = jr.to_hyperparameters(u)
    assert np.array_equal(jr.to_unit(v), tr.to_unit(v))


@pytest.mark.parametrize("spec", ["lambda=1e-4:1e2:log,alpha=0:1", "lambda=1:2,box=0:1",
                                  "alpha=0:1", "lambda=1:2:cube", "lambda=1", "lambda",
                                  "lambda=1:2,lambda=2:3", "lambda=1:2,alpha=0:1,box=0:1",
                                  "lambda=1:2,gamma=0:1"])
def test_parse_search_space_matches(spec):
    try:
        ref = jsd.parse_search_space(spec)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tsd.parse_search_space(spec)
        assert str(got.value) == str(err)
        return
    got = tsd.parse_search_space(spec)
    assert ref.names == got.names
    u = np.random.default_rng(0).uniform(size=(4, ref.dim))
    kw = dict(default_tolerance=1e-7, feature_dim=3, box_lower=-np.ones(3),
              box_upper=np.ones(3))
    rc, gc = ref.lane_configs(u, **kw), got.lane_configs(u, **kw)
    for field in ("l2", "l1", "tolerance", "lower_bounds", "upper_bounds"):
        a, b = getattr(rc, field), getattr(gc, field)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    assert ref.config_dicts(u) == got.config_dicts(u)


def _search_problem():
    x, y, offsets, weights = make_data(0, 400, 5, True)
    vx, vy, voff, vw = make_data(1, 300, 5, True)
    jb, tb = batches(x, y, offsets, weights)
    jv, tv = batches(vx, vy, voff, vw)
    jn, tn = normalizations("STANDARDIZATION", x, intercept_index=4)
    return jb, tb, jv, tv, jn, tn


@pytest.mark.parametrize("searcher,space", [
    ("gp", "lambda=1e-3:1e3:log,tolerance=1e-9:1e-5:log"),
    ("sobol", "lambda=1e-3:1e2:log,alpha=0:1"),
    ("gp", "lambda=1e-3:1e2:log,box=0:1"),
])
def test_model_search_matches(searcher, space):
    jb, tb, jv, tv, jn, tn = _search_problem()
    box = dict(box_lower=np.full(5, -0.5), box_upper=np.full(5, 0.5)) if "box" in space else {}
    common = dict(rounds=3, lane_budget=4, seed=0, searcher=searcher, evaluator="AUC",
                  intercept_index=4, min_observations=3, candidate_pool=64, **box)
    ref = jsd.run_model_search(jb, jv, JTask.LOGISTIC_REGRESSION,
                               jsd.parse_search_space(space),
                               optimizer=JOpt(max_iterations=40, rel_function_tolerance=1e-9),
                               normalization=jn, **common)
    reg = MetricsRegistry()
    got = tsd.run_model_search(tb, tv, TTask.LOGISTIC_REGRESSION,
                               tsd.parse_search_space(space),
                               optimizer=TOpt(max_iterations=40, rel_function_tolerance=1e-9),
                               normalization=tn, registry=reg, **common)
    assert len(ref.observations) == len(got.observations) == 12
    for (ru, rm), (gu, gm) in zip(ref.observations, got.observations):
        np.testing.assert_allclose(gu, ru, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(gm, rm, rtol=1e-8)
    assert [r["source"] for r in ref.trajectory] == [r["source"] for r in got.trajectory]
    assert ref.best_config.keys() == got.best_config.keys()
    np.testing.assert_allclose(got.best_metric, ref.best_metric, rtol=1e-8)
    np.testing.assert_allclose(to_np(got.best_model.coefficients.means),
                               np.asarray(ref.best_model.coefficients.means), rtol=1e-7,
                               atol=1e-9)
    assert reg.counter("search/rounds").value == 3
    assert reg.counter("search/configs_evaluated").value == 12
    host = tsd.host_metric_for_model(got.best_model, tv, th.search_driver.parse_evaluator("AUC"))
    np.testing.assert_allclose(host, got.best_metric, rtol=1e-10)


def test_model_search_refusals():
    _, tb, _, tv, _, _ = _search_problem()
    space = tsd.parse_search_space("lambda=1:2")
    with pytest.raises(ValueError, match="need rounds >= 1"):
        tsd.run_model_search(tb, tv, TTask.LOGISTIC_REGRESSION, space, rounds=0, lane_budget=2)
    with pytest.raises(ValueError, match="unknown searcher"):
        tsd.run_model_search(tb, tv, TTask.LOGISTIC_REGRESSION, space, rounds=1, lane_budget=2,
                             searcher="grid")


@pytest.mark.parametrize("mode", ["BAYESIAN", "RANDOM"])
def test_game_tuner_matches(mode, tmp_path):
    train, val = game_arrays(12, held_out=300)
    jd, td = datasets(train)
    jv, tv = datasets(val, vocabs=jd.entity_vocabs)
    je, te = estimator_pair(num_iterations=1, lane_iterations=8,
                            validation_evaluators=("AUC",))
    ranges = {"per_user": (0.1, 10.0), "fixed": (0.01, 1.0)}
    prior = [({"per_user": 1.0, "fixed": 0.1}, 0.7)]
    jt = jglue.GameHyperparameterTuner(je, ranges, jglue.HyperparameterTuningMode[mode], seed=2)
    tt = tglue.GameHyperparameterTuner(te, ranges, tglue.HyperparameterTuningMode[mode], seed=2)
    jr = jt.tune(jd, jv, num_iterations=3, prior_observations=prior)
    tr = tt.tune(td, tv, num_iterations=3, prior_observations=prior)
    assert jr.best_reg_weights.keys() == tr.best_reg_weights.keys()
    for k in jr.best_reg_weights:
        np.testing.assert_allclose(tr.best_reg_weights[k], jr.best_reg_weights[k], rtol=1e-10)
    np.testing.assert_allclose(tr.best_value, jr.best_value, rtol=1e-7)
    jglue.save_tuned_config(jr, tmp_path / "j.json")
    tglue.save_tuned_config(tr, tmp_path / "t.json")
    jj = json.loads((tmp_path / "j.json").read_text())
    tj = json.loads((tmp_path / "t.json").read_text())
    assert sorted(jj) == sorted(tj)
    assert len(tglue.load_prior_observations(tmp_path / "t.json")) == len(
        jglue.load_prior_observations(tmp_path / "j.json"))
    assert tglue.load_tuned_config(tmp_path / "t.json")["best_reg_weights"].keys() \
        == tr.best_reg_weights.keys()
    assert tr.best_result is not None and isinstance(tr.best_result[1].model.get("fixed")
                                                     .glm.coefficients.means, torch.Tensor)
