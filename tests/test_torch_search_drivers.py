"""The drivers' search and scheduling options against the JAX drivers, on
the CPU on small Avro inputs: the GLM driver's ``--grid-parallel`` and
``--search-rounds`` (coefficients within 1e-3·max|w|, the drivers training
in f32; the same summary keys and configurations), and the GAME training
driver's ``scheduler=true``, ``--hyperparameter-tuning`` and
``--incremental-refresh`` (models within the same limit, output files with
the JAX driver's keys, index maps byte-identical)."""

import json
import os

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as jtrain
from photon_ml_tpu.cli import glm_driver as jglm
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.cli import glm_driver as tglm
from tests import torch_driver_parity as P

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.fixture(scope="module")
def logistic(tmp_path_factory):
    base = tmp_path_factory.mktemp("logistic")
    P.write_logistic(str(base))
    return base


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    base = tmp_path_factory.mktemp("music")
    P.write_music(str(base))
    return base


def _glm_args(base, out, extra=()):
    return ["--input-data-path", str(base / "train"),
            "--validation-data-path", str(base / "test"), "--output-dir", str(out),
            "--task-type", "LOGISTIC_REGRESSION", *extra]


def _close(wt, wj, limit=1e-3):
    wj = np.asarray(wj, np.float64)
    wt = wt.double().numpy() if hasattr(wt, "double") else np.asarray(wt, np.float64)
    assert np.abs(wt - wj).max() <= limit * np.abs(wj).max()


def _index_maps_equal(tdir, jdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for n in names:
        with open(os.path.join(tdir, n), "rb") as f, open(os.path.join(jdir, n), "rb") as g:
            assert f.read() == g.read(), n


@pytest.mark.parametrize("extra", [[], ["--elastic-net-alpha", "0.5"]],
                         ids=["lbfgs", "elastic-net"])
def test_grid_parallel_matches_the_jax_driver_and_the_sequential_path(logistic, tmp_path,
                                                                      extra):
    grid = ["--regularization-weights", "0.1,1,10", "--grid-parallel",
            "--max-iterations", "30", *extra]
    j = jglm.main(_glm_args(logistic, tmp_path / "j", grid))
    t = tglm.main(_glm_args(logistic, tmp_path / "t", grid), device="cpu")
    assert sorted(t.models) == sorted(j.models) == [0.1, 1.0, 10.0]
    for lam in j.models:
        _close(t.models[lam].coefficients.means, j.models[lam].coefficients.means)
    assert t.best_lambda == j.best_lambda
    with open(t.summary_path) as f, open(j.summary_path) as g:
        assert set(json.load(f)) == set(json.load(g))
    # the cold-started lanes reach the warm sequential path's optima
    seq = tglm.main(_glm_args(logistic, tmp_path / "s", [a for a in grid
                                                         if a != "--grid-parallel"]),
                    device="cpu")
    for lam in seq.models:
        _close(t.models[lam].coefficients.means, seq.models[lam].coefficients.means, 2e-3)


def test_search_rounds_match_the_jax_driver(logistic, tmp_path):
    search = ["--search-rounds", "2", "--search-lane-budget", "4",
              "--search-space", "lambda=1e-2:1e2:log,tolerance=1e-8:1e-5:log",
              "--max-iterations", "40"]
    j = jglm.main(_glm_args(logistic, tmp_path / "j", search))
    t = tglm.main(_glm_args(logistic, tmp_path / "t", search), device="cpu")
    with open(t.summary_path) as f, open(j.summary_path) as g:
        ts, js = json.load(f), json.load(g)
    assert set(ts) == set(js) and set(ts["search"]) == set(js["search"])
    assert ts["search"]["configs"] == js["search"]["configs"] == 8
    assert ts["search"]["best_config"].keys() == js["search"]["best_config"].keys()
    assert ts["search"]["best_metric"] == pytest.approx(js["search"]["best_metric"], abs=2e-3)
    (lam_t, mt), = t.models.items()
    (lam_j, mj), = j.models.items()
    if lam_t == pytest.approx(lam_j, rel=1e-4):  # the same winner (f32 may pick a neighbour)
        _close(mt.coefficients.means, mj.coefficients.means)


def _game_args(music, out, extra, validation=True):
    return P.training_args(music, out, extra, validation=validation)


def test_scheduled_game_driver_matches_the_jax_driver(music, tmp_path):
    sched = ["--coordinate-configurations",
             "name=per-user,feature.shard=userShard,random.effect.type=userId,reg.weights=1,"
             "max.iter=25,scheduler=true,scheduler.probe.iter=2",
             "--coordinate-descent-iterations", "2"]
    js = jtrain.main(_game_args(music, tmp_path / "j", P.FE_ARGS + sched))
    ts = ttrain.main(_game_args(music, tmp_path / "t", P.FE_ARGS + sched), device="cpu")
    assert ts["best_metric"] == pytest.approx(js["best_metric"], rel=1e-3)
    assert ts["effective_coordinate_configurations"] == js["effective_coordinate_configurations"]
    _index_maps_equal(tmp_path / "t" / "index-maps", tmp_path / "j" / "index-maps")


@pytest.mark.parametrize("mode", ["BAYESIAN", "RANDOM"])
def test_hyperparameter_tuning_matches_the_jax_driver(music, tmp_path, mode):
    tune = ["--hyperparameter-tuning", mode, "--hyperparameter-tuning-iter", "3",
            "--hyperparameter-tuning-range", "0.01,10"]
    extra = P.FE_ARGS + P.PER_USER_ARGS + tune
    js = jtrain.main(_game_args(music, tmp_path / "j", extra))
    ts = ttrain.main(_game_args(music, tmp_path / "t", extra), device="cpu")
    assert set(ts) == set(js)
    with open(tmp_path / "t" / "tuned-hyperparameters.json") as f, \
            open(tmp_path / "j" / "tuned-hyperparameters.json") as g:
        tt, jt = json.load(f), json.load(g)
    assert set(tt) == set(jt)
    assert set(tt["best_reg_weights"]) == set(jt["best_reg_weights"])
    assert len(tt["prior_observations"]) == len(jt["prior_observations"])
    assert sorted(os.listdir(tmp_path / "t" / "models-tuned")) == \
        sorted(os.listdir(tmp_path / "j" / "models-tuned"))
    # a second run seeded with the first run's file
    again = ttrain.main(_game_args(music, tmp_path / "t2", extra + [
        "--hyperparameter-prior-json", str(tmp_path / "t" / "tuned-hyperparameters.json")]),
        device="cpu")
    assert "tuned_reg_weights" in again


def test_incremental_refresh_matches_the_jax_driver(music, tmp_path):
    extra = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]
    ttrain.main(_game_args(music, tmp_path / "resident", extra, validation=False),
                device="cpu")
    resident = str(tmp_path / "resident" / "best")
    refresh = extra + ["--incremental-refresh", "--model-input-dir", resident,
                       "--refresh-changed-entities", "userId=user0|user1",
                       "--refresh-gradient-tolerance", "0.05"]
    js = jtrain.main(_game_args(music, tmp_path / "j", refresh, validation=False))
    ts = ttrain.main(_game_args(music, tmp_path / "t", refresh, validation=False),
                     device="cpu")
    assert set(ts) == set(js)
    tr, jr = ts["incremental_refresh"], js["incremental_refresh"]
    assert set(tr) == set(jr)
    for key in ("lanes_total", "lanes_changed", "coordinates_refreshed", "coordinates_carried"):
        assert tr[key] == jr[key], key
    assert tr["lanes_changed"] == 2 and 0 < tr["lanes_solved"] < tr["lanes_total"]
    assert sorted(os.listdir(tmp_path / "t" / "best")) == sorted(os.listdir(tmp_path / "j" /
                                                                            "best"))
    # a resident model of another λ is refused, naming the field
    with pytest.raises(ValueError, match="lambda"):
        ttrain.main(_game_args(music, tmp_path / "x", [a.replace("reg.weights=1,",
                                                                 "reg.weights=3,")
                                                       for a in refresh], validation=False),
                    device="cpu")
