"""The port's three drivers (``photon_ml_torch/cli``) against the JAX
package's, end to end on the CPU: Avro in, GLM and GAME training, model
Avro out, GAME scoring.

Limits: the two packages train in f32 and their solver trajectories drift
apart near the optimum, so driver-level agreement is looser than a
module's: GAME validation RMSE within rel 1e-3 of the JAX driver's (and
under the frozen bounds of ``tests/test_driver_integ.py``), scores of the
same saved model within 1e-4 max|score|, GLM coefficients per λ within
1e-3 max|w|.
"""

import json
import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import game_scoring_driver as jscore
from photon_ml_tpu.cli import game_training_driver as jtrain
from photon_ml_tpu.cli import glm_driver as jglm
from photon_ml_torch.cli import game_scoring_driver as tscore
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.cli import glm_driver as tglm
from photon_ml_torch.io.model_io import read_scores
from tests import torch_driver_parity as P

#: configuration -> (extra arguments, frozen bound of tests/test_driver_integ.py)
CONFIGS = {
    "fixed-effect-only": (P.FE_ARGS, 2.1),
    "fixed-and-per-user": (P.FE_ARGS + P.PER_USER_ARGS
                           + ["--coordinate-descent-iterations", "2"], 1.45),
    "full-mixed-effect": (P.FE_ARGS + P.PER_USER_ARGS + P.PER_SONG_ARGS
                          + ["--coordinate-descent-iterations", "3"], 0.45),
    "newton-re-lanes": (P.FE_ARGS + P.NEWTON_USER_ARGS
                        + ["--coordinate-descent-iterations", "2"], 1.45),
}
BF16_SHARDS = ["--feature-shard-configurations",
               "name=global,feature.bags=features,intercept=true,dtype=bf16",
               "--feature-shard-configurations",
               "name=userShard,feature.bags=userFeatures,intercept=false"]


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    base = tmp_path_factory.mktemp("music")
    P.write_music(str(base))
    return base


@pytest.fixture(scope="module")
def trained(music, tmp_path_factory):
    """Each configuration trained by both packages: name -> (jax summary,
    port summary, jax output dir, port output dir)."""
    out = tmp_path_factory.mktemp("trained")
    runs = {}
    for name, (extra, _) in CONFIGS.items():
        jdir, tdir = out / f"jax-{name}", out / f"torch-{name}"
        runs[name] = (jtrain.main(P.training_args(music, jdir, extra)),
                      ttrain.main(P.training_args(music, tdir, extra), device="cpu"),
                      jdir, tdir)
    return runs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_game_training_matches_the_jax_driver(trained, name):
    jsum, tsum, jdir, tdir = trained[name]
    bound = CONFIGS[name][1]
    assert tsum["best_metric"] < bound
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)
    with open(tdir / "training-summary.json") as f:
        on_disk = json.load(f)
    # the JAX-only fields (ledger, telemetry, streaming, refresh) are left out
    assert set(on_disk) == set(jsum) - {"tuned_reg_weights", "tuned_metric"}
    assert on_disk["effective_coordinate_configurations"] == \
        jsum["effective_coordinate_configurations"]
    assert on_disk["best_reg_weights"] == jsum["best_reg_weights"]
    assert [m["reg_weights"] for m in on_disk["metric_history"]] == \
        [m["reg_weights"] for m in jsum["metric_history"]]
    for sub in ("best", "models/0", "index-maps", "feature-stats"):
        assert sorted(os.listdir(tdir / sub)) == sorted(os.listdir(jdir / sub)), sub


WIDE_SHARD = ["--feature-shard-configurations",
              "name=wideShard,feature.bags=userFeatures|songFeatures|features,intercept=true"]
#: projected random effects and the other lanes: (extra arguments, bound on
#: the validation RMSE: the fixed-and-per-user run's frozen 1.45, or the
#: fixed effect's alone, 2.1, for a sketch of 8 of the wide shard's 15 columns)
PROJECTED = {
    "index-map": (["--coordinate-configurations",
                   "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                   "reg.weights=1,projector=INDEX_MAP,max.iter=25"], 1.45),
    "random-projection": (WIDE_SHARD + [
        "--coordinate-configurations",
        "name=per-user,feature.shard=wideShard,random.effect.type=userId,reg.weights=1,"
        "projector=RANDOM,projected.dim=8,max.iter=25"], 2.1),
    "elastic-net-lanes": (["--coordinate-configurations",
                           "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                           "reg.weights=1,reg.alpha=0.5,max.iter=25"], 1.45),
    "tron-lanes": (["--coordinate-configurations",
                    "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                    "reg.weights=1,optimizer=TRON,max.iter=15,tolerance=1e-5"], 1.45),
}


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", list(PROJECTED))
def test_projected_game_training_matches_the_jax_driver(music, tmp_path, name):
    """A projected per-user effect, elastic-net lanes or TRON lanes through
    both training drivers, then both scoring drivers on their own models.
    The files that do not hold f32 solver output (model metadata, id-info,
    index maps, feature statistics) are byte-identical; the two packages'
    f32 trajectories differ in the last bits, so coefficients agree within
    1e-3 max|w| per coordinate and scores within 1e-3 max|score|."""
    from photon_ml_torch import convert
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model

    args, bound = PROJECTED[name]
    extra = P.FE_ARGS + args + ["--coordinate-descent-iterations", "2"]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jsum = jtrain.main(P.training_args(music, jdir, extra))
    tsum = ttrain.main(P.training_args(music, tdir, extra), device="cpu")
    assert tsum["best_metric"] < bound
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)
    assert _files(tdir) == _files(jdir)
    for f in _files(jdir):
        if f.startswith(("index-maps", "feature-stats")) or f.endswith(
                ("model-metadata.json", "id-info")):
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    maps = IndexMap.load_directory(jdir / "index-maps")
    models = [convert.game_model_to_numpy(load_game_model(d / "best", maps, device="cpu"))
              for d in (jdir, tdir)]
    assert list(models[0]) == list(models[1]) == ["fe", "per-user"]
    for cid in models[0]:
        key = "means" if "means" in models[0][cid] else "coefficients"
        ref, got = models[0][cid][key], models[1][cid][key]
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), cid
    shards = P.SHARD_ARGS + (WIDE_SHARD if "wideShard" in " ".join(extra) else [])
    scored = []
    for mod, d, kw in ((jscore, jdir, {}), (tscore, tdir, {"device": "cpu"})):
        mod.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                  str(d / "best"), "--output-dir", str(d / "scored"), "--evaluators", "RMSE",
                  *shards], **kw)
        scored.append(_scores(d / "scored" / "scores"))
    assert scored[0].shape == scored[1].shape == (400,)
    assert np.abs(scored[1] - scored[0]).max() <= 1e-3 * np.abs(scored[0]).max()


def test_lbfgsb_random_effect_fails_as_the_jax_driver_does(music, tmp_path):
    """The JAX driver reads the data, trains the fixed effect and then fails
    in the random effect's solve, which passes no box constraints; the
    port's driver fails there with the same error."""
    extra = P.FE_ARGS + ["--coordinate-configurations",
                         "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                         "reg.weights=1,optimizer=LBFGSB,max.iter=5"]
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints"):
        jtrain.main(P.training_args(music, tmp_path / "j", extra))
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints$"):
        ttrain.main(P.training_args(music, tmp_path / "t", extra), device="cpu")


def test_bf16_global_shard_matches_the_jax_driver(music, tmp_path):
    extra = BF16_SHARDS + P.FE_ARGS
    args = ["--input-data-path", str(music / "train"), "--validation-data-path",
            str(music / "test"), "--task-type", "LINEAR_REGRESSION", "--evaluators", "RMSE"]
    j = jtrain.main(args + ["--root-output-dir", str(tmp_path / "j")] + extra)
    t = ttrain.main(args + ["--root-output-dir", str(tmp_path / "t")] + extra, device="cpu")
    assert t["best_metric"] < 2.1
    assert t["best_metric"] == pytest.approx(j["best_metric"], rel=1e-3)


def _scores(path):
    return np.asarray([r["predictionScore"] for r in read_scores(path)])


@pytest.mark.parametrize("trainer", ["jax", "torch"])
def test_scoring_driver_on_each_packages_model(music, trained, tmp_path, trainer):
    """Both scoring drivers on one saved model: the same scores (within
    1e-4 max|score|), the same uids and the same evaluations; the scores
    read back from the port's Avro equal its in-process transform."""
    jsum, tsum, jdir, tdir = trained["full-mixed-effect"]
    model = (jdir if trainer == "jax" else tdir) / "best"
    args = ["--input-data-path", str(music / "test"), "--model-input-dir", str(model),
            "--evaluators", "RMSE,RMSE:queryId", *P.SHARD_ARGS]
    j = jscore.main(args + ["--output-dir", str(tmp_path / "j")])
    t = tscore.main(args + ["--output-dir", str(tmp_path / "t")], device="cpu")
    sj, st = _scores(tmp_path / "j" / "scores"), _scores(tmp_path / "t" / "scores")
    assert t["num_scored"] == j["num_scored"] == 400
    assert np.abs(sj - st).max() <= 1e-4 * np.abs(sj).max()
    assert [r["uid"] for r in read_scores(tmp_path / "t" / "scores")] == \
        [r["uid"] for r in read_scores(tmp_path / "j" / "scores")]
    assert set(t["evaluations"]) == set(j["evaluations"]) == {"RMSE", "RMSE:queryId"}
    for k in j["evaluations"]:
        assert t["evaluations"][k] == pytest.approx(j["evaluations"][k], rel=1e-4)
    # the driver's own (frozen-style) bound: the trained model scores the test split well
    assert t["evaluations"]["RMSE"] < 0.45
    with open(tmp_path / "t" / "scoring-summary.json") as f:
        assert json.load(f)["num_scored"] == 400


def test_warm_start_from_a_jax_model_and_saved_index_maps(music, trained, tmp_path):
    """The port trains warm-started from a model directory the JAX driver
    wrote, reading its index stores (--index-maps-dir) instead of scanning."""
    _, _, jdir, _ = trained["fixed-and-per-user"]
    extra, bound = CONFIGS["fixed-and-per-user"]
    s = ttrain.main(P.training_args(music, tmp_path / "w", extra + [
        "--model-input-dir", str(jdir / "best"), "--index-maps-dir", str(jdir / "index-maps"),
        "--model-output-mode", "BEST"]), device="cpu")
    assert s["best_metric"] < bound
    assert (tmp_path / "w" / "best" / "model-metadata.json").exists()
    assert not (tmp_path / "w" / "models").exists()


def test_glm_driver_matches_the_jax_driver(tmp_path):
    P.write_logistic(str(tmp_path / "data"))

    def args(out):
        return ["--input-data-path", str(tmp_path / "data" / "train"),
                "--validation-data-path", str(tmp_path / "data" / "test"),
                "--output-dir", str(out), "--task-type", "LOGISTIC_REGRESSION",
                "--regularization-weights", "0.1,1,10"]

    j = jglm.main(args(tmp_path / "j"))
    t = tglm.main(args(tmp_path / "t"), device="cpu")
    assert sorted(t.models) == sorted(j.models) == [0.1, 1.0, 10.0]
    for lam in j.models:
        wj = np.asarray(j.models[lam].coefficients.means, np.float64)
        wt = t.models[lam].coefficients.means.double().numpy()
        assert np.abs(wj - wt).max() <= 1e-3 * np.abs(wj).max(), lam
        assert set(t.validation_metrics[lam]) == set(j.validation_metrics[lam])
        assert t.validation_metrics[lam]["AUC"] == pytest.approx(
            j.validation_metrics[lam]["AUC"], abs=1e-3)
    assert t.best_lambda == j.best_lambda and t.stage.name == j.stage.name == "VALIDATED"
    assert sorted(os.listdir(tmp_path / "t" / "models-text")) == \
        sorted(os.listdir(tmp_path / "j" / "models-text"))
    with open(t.summary_path) as f, open(j.summary_path) as g:
        assert set(json.load(f)) == set(json.load(g))


def test_glm_driver_box_constraints(tmp_path):
    P.write_logistic(str(tmp_path / "data"), n_train=300, n_test=50, d=6)
    bounds = '[{"name": "*", "term": "*", "lowerBound": -0.05, "upperBound": 0.05}]'
    args = ["--input-data-path", str(tmp_path / "data" / "train"), "--output-dir",
            str(tmp_path / "t"), "--task-type", "LOGISTIC_REGRESSION",
            "--regularization-weights", "0.1", "--coefficient-box-constraints", bounds,
            "--tolerance", "1e-10", "--max-iterations", "200"]
    t = tglm.main(args, device="cpu")
    j = jglm.main(args[:3] + [str(tmp_path / "j")] + args[4:])
    wt = t.models[0.1].coefficients.means.numpy()
    wj = np.asarray(j.models[0.1].coefficients.means)
    assert np.abs(wt[:-1]).max() <= 0.05 + 1e-7  # the intercept is not bounded
    np.testing.assert_array_equal(wt[:-1], wj[:-1])  # both pinned at the same bounds
    # the one free coefficient: f32 L-BFGS-B stops where the projected
    # gradient is f32 noise, 2.5e-3 of |w| apart between the two packages
    assert abs(wt[-1] - wj[-1]) <= 5e-3 * np.abs(wj).max()


GAME_LEFT_OUT = [
    (["--distributed"], "item 10"), (["--mesh", "data=8,model=1"], "item 10"),
    (["--partitioned-io"], "item 15"), (["--streaming-chunks", "64"], "item 16"),
    (["--duhl-working-set", "2"], "item 16"), (["--checkpoint-dir", "ck"], "item 16"),
    (["--max-restarts", "2"], "item 16"), (["--incremental-refresh"], "item 18"),
    (["--hyperparameter-tuning", "BAYESIAN"], "item 18"), (["--telemetry-dir", "t"], "item 19"),
    (["--trace-dir", "t"], "item 19"), (["--profile-dir", "t"], "item 19"),
    (["--input-format", "libsvm"], "item 14"), (["--input-date-range", "1-2"], "queue A"),
    (["--coordinate-configurations",
      "name=mf,mf.row.effect.type=userId,mf.col.effect.type=songId,mf.latent.factors=2"],
     "item 13"),
    (["--feature-shard-configurations", "name=sp,feature.bags=features,sparse=true"],
     "item 14"),
    (["--coordinate-configurations",
      "name=s,feature.shard=userShard,random.effect.type=userId,scheduler=true"], "item 18"),
]


@pytest.mark.parametrize("extra,item", GAME_LEFT_OUT,
                         ids=[" ".join(e)[:40] for e, _ in GAME_LEFT_OUT])
def test_game_training_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    """Each left-out flag fails before any data is read (the input path
    does not even exist) and names its ROADMAP.md item."""
    args = P.training_args(tmp_path / "no-such-input", tmp_path / "o", P.FE_ARGS + extra,
                           validation=False)
    with pytest.raises(NotImplementedError, match=item):
        ttrain.main(args, device="cpu")


GLM_LEFT_OUT = [
    (["--streaming-chunks", "8"], "item 16"), (["--checkpoint-dir", "c"], "item 16"),
    (["--max-restarts", "1"], "item 16"), (["--grid-parallel"], "item 18"),
    (["--search-rounds", "2"], "item 18"), (["--enable-diagnostics"], "item 19"),
    (["--num-bootstraps", "3"], "item 19"), (["--telemetry-dir", "t"], "item 19"),
    (["--trace-dir", "t"], "item 19"), (["--input-format", "libsvm"], "item 14"),
]


@pytest.mark.parametrize("extra,item", GLM_LEFT_OUT, ids=[" ".join(e) for e, _ in GLM_LEFT_OUT])
def test_glm_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    args = ["--input-data-path", str(tmp_path / "none"), "--output-dir", str(tmp_path / "o"),
            "--task-type", "LOGISTIC_REGRESSION", *extra]
    with pytest.raises(NotImplementedError, match=item):
        tglm.main(args, device="cpu")


SCORING_LEFT_OUT = [(["--distributed"], "item 10"), (["--partitioned-io"], "item 15"),
                    (["--telemetry-dir", "t"], "item 19"), (["--trace-dir", "t"], "item 19"),
                    (["--input-format", "libsvm"], "item 14")]


@pytest.mark.parametrize("extra,item", SCORING_LEFT_OUT,
                         ids=[" ".join(e) for e, _ in SCORING_LEFT_OUT])
def test_scoring_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    args = ["--input-data-path", str(tmp_path / "none"), "--model-input-dir",
            str(tmp_path / "m"), "--output-dir", str(tmp_path / "o"), *extra]
    with pytest.raises(NotImplementedError, match=item):
        tscore.main(args, device="cpu")


def test_drivers_run_on_cuda_unless_asked(music, tmp_path):
    """device=None means the CUDA device: without one each driver raises
    before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(P.training_args(music, tmp_path / "a", P.FE_ARGS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tglm.main(["--input-data-path", str(music / "train"), "--output-dir",
                   str(tmp_path / "b"), "--task-type", "LINEAR_REGRESSION"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscore.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                     str(tmp_path / "m"), "--output-dir", str(tmp_path / "c")])
    assert not (tmp_path / "a").exists()
