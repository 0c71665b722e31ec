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
    # the mesh is ported, its model axis too: a one-process --distributed
    # run makes a group of one and fails on the missing input, as does a 1x1
    # mesh; --mesh data=8 or model=2 in a group of one is refused as a shape
    # error (tests/test_torch_model_axis_io.py runs the model axis)
    (["--distributed"], None), (["--mesh", "data=8,model=1"], ValueError),
    (["--mesh", "data=1,model=2"], ValueError), (["--mesh", "data=1,model=1"], None),
    # partitioned I/O is ported: it needs --distributed (or --mesh), and
    # with it gets past every refusal, as do checkpoints and restarts
    (["--partitioned-io"], ValueError), (["--partitioned-io", "--distributed"], None),
    (["--partitioned-io", "--distributed", "--checkpoint-dir", "ck"], None),
    # streamed GAME is ported: --streaming-chunks gets past every refusal,
    # and --duhl-working-set without it is the JAX driver's ValueError
    (["--streaming-chunks", "64"], None),
    (["--duhl-working-set", "2"], ValueError), (["--checkpoint-dir", "ck"], None),
    # the refresh needs a resident model and tuning needs evaluators (the
    # JAX driver's ValueErrors); the lane scheduler gets past every refusal
    (["--max-restarts", "2"], None), (["--incremental-refresh"], ValueError),
    (["--hyperparameter-tuning", "BAYESIAN"], ValueError),
    (["--input-format", "libsvm"], None), (["--input-date-range", "1-2"], ValueError),
    (["--coordinate-configurations",
      "name=mf,mf.row.effect.type=userId,mf.col.effect.type=songId,mf.latent.factors=2"],
     None),
    (["--feature-shard-configurations", "name=sp,feature.bags=features,sparse=true"], None),
    (["--coordinate-configurations",
      "name=s,feature.shard=userShard,random.effect.type=userId,scheduler=true"], None),
]


@pytest.mark.parametrize("extra,item", GAME_LEFT_OUT,
                         ids=[" ".join(e)[:40] for e, _ in GAME_LEFT_OUT])
def test_game_training_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    """Each left-out flag fails before any data is read (the input path
    does not even exist) and names its ROADMAP.md item; a flag ported since
    (item None) gets past every refusal and fails on the missing input."""
    args = P.training_args(tmp_path / "no-such-input", tmp_path / "o", P.FE_ARGS + extra,
                           validation=False)
    _raises_for(item, lambda: ttrain.main(args, device="cpu"))


def _raises_for(item, run, missing=FileNotFoundError, match=None):
    """``run`` raises NotImplementedError naming ``item``; with item None
    (ported) it gets past every refusal and raises ``missing`` instead; with
    an exception class (ported) it rejects the flag's malformed value with
    that exception, as the JAX driver does."""
    if isinstance(item, type):
        with pytest.raises(item):
            run()
    elif item is None:
        with pytest.raises(missing, match=match):
            run()
    else:
        with pytest.raises(NotImplementedError, match=item):
            run()


GLM_LEFT_OUT = [
    # streaming, checkpoints (streaming only) and restarts are ported, and
    # so are the grid lanes and the model search (which needs its space)
    (["--streaming-chunks", "8"], None), (["--checkpoint-dir", "c"], ValueError),
    (["--max-restarts", "1"], None), (["--grid-parallel"], None),
    (["--search-rounds", "2"], ValueError), (["--input-format", "libsvm"], None),
]


@pytest.mark.parametrize("extra,item", GLM_LEFT_OUT, ids=[" ".join(e) for e, _ in GLM_LEFT_OUT])
def test_glm_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    args = ["--input-data-path", str(tmp_path / "none"), "--output-dir", str(tmp_path / "o"),
            "--task-type", "LOGISTIC_REGRESSION", *extra]
    _raises_for(item, lambda: tglm.main(args, device="cpu"))


SCORING_LEFT_OUT = [(["--distributed"], None), (["--mesh", "model=2"], ValueError),
                    (["--mesh", "data=1,model=1"], None),
                    (["--partitioned-io"], ValueError),
                    (["--partitioned-io", "--distributed"], None),
                    (["--input-format", "libsvm"], None)]


@pytest.mark.parametrize("extra,item", SCORING_LEFT_OUT,
                         ids=[" ".join(e) for e, _ in SCORING_LEFT_OUT])
def test_scoring_driver_refuses_what_is_not_ported(tmp_path, extra, item):
    args = ["--input-data-path", str(tmp_path / "none"), "--model-input-dir",
            str(tmp_path / "m"), "--output-dir", str(tmp_path / "o"), *extra]
    # the model is read before the data: a ported flag fails on the missing model
    _raises_for(item, lambda: tscore.main(args, device="cpu"), missing=ValueError,
                match="no saved index-map stores")


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


SPARSE_SHARD = "name=global,feature.bags=features,intercept=true,sparse=true"
SPARSE_ARGS = ["--feature-shard-configurations", SPARSE_SHARD,
               "--coordinate-configurations",
               "name=fe,feature.shard=global,reg.weights=1,max.iter=30",
               "--coordinate-configurations",
               "name=per-user,feature.shard=global,random.effect.type=userId,reg.weights=1,"
               "max.iter=20", "--coordinate-descent-iterations", "2"]


@pytest.fixture(scope="module")
def sparse_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("sparse")
    P.write_sparse(str(base))
    return base


def _sparse_training_args(base, out, extra=()):
    return ["--input-data-path", str(base / "train"), "--validation-data-path",
            str(base / "test"), "--root-output-dir", str(out), "--task-type",
            "LINEAR_REGRESSION", "--evaluators", "RMSE", *SPARSE_ARGS, *extra]


def test_sparse_game_training_and_scoring_match_the_jax_drivers(sparse_data, tmp_path):
    """A fixed effect and a compact per-user effect on one sparse name-term
    shard, through both training drivers (the maps from the port's feature
    indexing driver, ``--index-maps-dir``), then both scoring drivers on the
    JAX driver's model loaded compact: validation RMSE within rel 1e-3, the
    files that hold no f32 solver output byte-identical, the compact tables
    within 1e-3 max|w|, scores of the same model within 1e-4 max|score|."""
    from photon_ml_tpu.cli import feature_indexing_driver as jindexing
    from photon_ml_torch import convert
    from photon_ml_torch.cli import feature_indexing_driver as tindexing
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model

    spec = ["--input-data-path", str(sparse_data / "train"),
            "--feature-shard-configurations", SPARSE_SHARD]
    jindexing.main(spec + ["--output-dir", str(tmp_path / "jmaps")])
    tindexing.main(spec + ["--output-dir", str(tmp_path / "tmaps")])
    assert _files(tmp_path / "tmaps") == _files(tmp_path / "jmaps")
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jsum = jtrain.main(_sparse_training_args(sparse_data, jdir))
    tsum = ttrain.main(_sparse_training_args(sparse_data, tdir, [
        "--index-maps-dir", str(tmp_path / "tmaps")]), device="cpu")
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)
    fe_alone = tsum["metric_history"][0]["metrics"][0]
    assert tsum["best_metric"] < fe_alone["validate:RMSE"]
    assert _files(tdir) == _files(jdir)
    for f in _files(jdir):
        if f.startswith(("index-maps", "feature-stats")) or f.endswith(
                ("model-metadata.json", "id-info")):
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    maps = IndexMap.load_directory(jdir / "index-maps")
    models = [load_game_model(d / "best", maps, compact_random_effect_threshold=0,
                              device="cpu") for d in (jdir, tdir)]
    users = [m.get("per-user") for m in models]
    assert users[0].is_compact and np.array_equal(users[0].active_cols, users[1].active_cols)
    plain = [convert.game_model_to_numpy(m) for m in models]
    for cid, key in (("fe", "means"), ("per-user", "coefficients")):
        ref, got = plain[0][cid][key], plain[1][cid][key]
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max(), cid
    shard = ["--feature-shard-configurations", SPARSE_SHARD, "--compact-random-effect-threshold",
             "0"]
    for mod, out, kw in ((jscore, "js", {}), (tscore, "ts", {"device": "cpu"})):
        mod.main(["--input-data-path", str(sparse_data / "test"), "--model-input-dir",
                  str(jdir / "best"), "--output-dir", str(tmp_path / out), "--evaluators",
                  "RMSE", *shard], **kw)
    sj, st = _scores(tmp_path / "js" / "scores"), _scores(tmp_path / "ts" / "scores")
    assert sj.shape == st.shape == (300,)
    assert np.abs(st - sj).max() <= 1e-4 * np.abs(sj).max()


@pytest.fixture(scope="module")
def libsvm_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("libsvm")
    for task, tag in (("LOGISTIC_REGRESSION", "logistic"), ("LINEAR_REGRESSION", "linear")):
        P.write_libsvm(str(base / tag / "train.txt"), 500, 1, task=task)
        P.write_libsvm(str(base / tag / "test.txt"), 200, 2, task=task)
    return base


def test_glm_driver_on_libsvm_matches_the_jax_driver(libsvm_data, tmp_path):
    def args(out):
        return ["--input-data-path", str(libsvm_data / "logistic" / "train.txt"),
                "--validation-data-path", str(libsvm_data / "logistic" / "test.txt"),
                "--output-dir", str(out), "--task-type", "LOGISTIC_REGRESSION",
                "--regularization-weights", "0.1,10", "--input-format", "libsvm"]

    j = jglm.main(args(tmp_path / "j"))
    t = tglm.main(args(tmp_path / "t"), device="cpu")
    for lam in j.models:
        wj = np.asarray(j.models[lam].coefficients.means, np.float64)
        wt = t.models[lam].coefficients.means.double().numpy()
        assert wt.shape == wj.shape == (121,)  # 120 features and the intercept
        assert np.abs(wj - wt).max() <= 1e-3 * np.abs(wj).max(), lam
        assert t.validation_metrics[lam]["AUC"] == pytest.approx(
            j.validation_metrics[lam]["AUC"], abs=1e-3)
    assert t.best_lambda == j.best_lambda and t.validation_metrics[t.best_lambda]["AUC"] > 0.6
    for name in os.listdir(tmp_path / "j" / "models-text"):
        jl = (tmp_path / "j" / "models-text" / name).read_text().splitlines()
        tl = (tmp_path / "t" / "models-text" / name).read_text().splitlines()
        # the same features (their order follows f32 magnitudes, which may tie)
        assert sorted(line.split("\t")[:2] for line in tl) == \
            sorted(line.split("\t")[:2] for line in jl)


LIBSVM_GAME = {
    "pre-indexed-sparse": "name=global,feature.bags=features,intercept=false,pre.indexed=true,"
                          "dimension=200,sparse=true",
    "pre-indexed-hybrid": "name=global,feature.bags=features,intercept=false,pre.indexed=true,"
                          "dimension=200,sparse=true,hybrid=true,hybrid.hot.cols=16",
    "by-name-dense": "name=global,feature.bags=features,intercept=true",
}


@pytest.mark.parametrize("name", list(LIBSVM_GAME))
def test_game_driver_on_libsvm_matches_the_jax_driver(libsvm_data, tmp_path, name):
    """The GAME training driver on LibSVM (a fixed effect: LibSVM carries no
    id columns), pre-indexed or by name: validation RMSE within rel 1e-3,
    index maps and feature statistics byte-identical."""
    def args(out):
        return ["--input-data-path", str(libsvm_data / "linear" / "train.txt"),
                "--validation-data-path", str(libsvm_data / "linear" / "test.txt"),
                "--root-output-dir", str(out), "--task-type", "LINEAR_REGRESSION",
                "--input-format", "libsvm", "--evaluators", "RMSE",
                "--feature-shard-configurations", LIBSVM_GAME[name],
                "--coordinate-configurations",
                "name=fe,feature.shard=global,reg.weights=1,max.iter=30"]

    j = jtrain.main(args(tmp_path / "j"))
    t = ttrain.main(args(tmp_path / "t"), device="cpu")
    assert t["best_metric"] == pytest.approx(j["best_metric"], rel=1e-3)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    for f in _files(tmp_path / "j"):
        if f.startswith(("index-maps", "feature-stats")) or f.endswith("model-metadata.json"):
            assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


@pytest.mark.parametrize("zero_based", [False, True])
def test_libsvm_to_avro_is_byte_identical(libsvm_data, tmp_path, zero_based):
    from photon_ml_tpu.cli import libsvm_to_avro as jconv
    from photon_ml_torch.cli import libsvm_to_avro as tconv

    src = str(libsvm_data / "logistic" / "train.txt")
    flag = ["--zero-based"] if zero_based else []
    nj = jconv.main(["--input", src, "--output", str(tmp_path / "j" / "part.avro"), *flag])
    nt = tconv.main(["--input", src, "--output", str(tmp_path / "t" / "part.avro"), *flag])
    assert nt == nj == 500
    assert (tmp_path / "t" / "part.avro").read_bytes() == \
        (tmp_path / "j" / "part.avro").read_bytes()


@pytest.mark.parametrize("source", ["avro", "libsvm"])
def test_name_term_feature_bags_driver_matches(music, libsvm_data, tmp_path, source):
    from photon_ml_tpu.cli import name_term_feature_bags_driver as jbags
    from photon_ml_torch.cli import name_term_feature_bags_driver as tbags

    if source == "avro":
        args = ["--input-data-path", str(music / "train"), "--feature-bags",
                "features,userFeatures,missing"]
    else:
        args = ["--input-data-path", str(libsvm_data / "linear" / "train.txt"),
                "--feature-bags", "features", "--input-format", "libsvm"]
    cj = jbags.main(args + ["--output-dir", str(tmp_path / "j")])
    ct = tbags.main(args + ["--output-dir", str(tmp_path / "t")])
    assert ct == cj and _files(tmp_path / "t") == _files(tmp_path / "j")
    for f in _files(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


INDEXING = {
    "avro": (["--feature-shard-configurations", "name=global,feature.bags=features",
              "--feature-shard-configurations",
              "name=entity,feature.bags=userFeatures|songFeatures,intercept=false"], "avro"),
    "avro-sparse": (["--feature-shard-configurations", SPARSE_SHARD], "sparse"),
    "libsvm": (["--feature-shard-configurations", "name=global,feature.bags=features",
                "--input-format", "libsvm"], "libsvm"),
    "avro-offheap": (["--feature-shard-configurations", "name=global,feature.bags=features",
                      "--feature-shard-configurations",
                      "name=entity,feature.bags=userFeatures|songFeatures,intercept=false",
                      "--index-store-format", "offheap", "--num-partitions", "3"], "avro"),
}


@pytest.mark.parametrize("name", list(INDEXING))
def test_feature_indexing_driver_is_byte_identical(music, sparse_data, libsvm_data, tmp_path,
                                                   name):
    from photon_ml_tpu.cli import feature_indexing_driver as jindexing
    from photon_ml_torch.cli import feature_indexing_driver as tindexing

    extra, source = INDEXING[name]
    path = {"avro": music / "train", "sparse": sparse_data / "train",
            "libsvm": libsvm_data / "linear" / "train.txt"}[source]
    args = ["--input-data-path", str(path), *extra]
    sj = jindexing.main(args + ["--output-dir", str(tmp_path / "j")])
    st = tindexing.main(args + ["--output-dir", str(tmp_path / "t")])
    assert st == sj and _files(tmp_path / "t") == _files(tmp_path / "j")
    for f in _files(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_feature_indexing_driver_refuses_off_heap_stores(music, trained, tmp_path):
    """The off-heap store format was refused before the port had the store;
    now the port's indexing driver writes it (the JAX driver's files byte
    for byte, P=1) and the GAME training driver trains from it
    (``--index-maps-dir``) the same model as from the maps it builds itself;
    the scoring driver reads the store too."""
    from photon_ml_tpu.cli import feature_indexing_driver as jindexing
    from photon_ml_torch.cli import feature_indexing_driver as tindexing
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.offheap_index_map import OffHeapIndexMap

    spec = ["--input-data-path", str(music / "train"),
            "--feature-shard-configurations", "name=global,feature.bags=features",
            "--feature-shard-configurations",
            "name=userShard,feature.bags=userFeatures,intercept=false",
            "--feature-shard-configurations",
            "name=songShard,feature.bags=songFeatures,intercept=false",
            "--index-store-format", "offheap"]
    jindexing.main(spec + ["--output-dir", str(tmp_path / "jmaps")])
    tindexing.main(spec + ["--output-dir", str(tmp_path / "tmaps")])
    assert _files(tmp_path / "tmaps") == _files(tmp_path / "jmaps")
    for f in _files(tmp_path / "jmaps"):
        assert (tmp_path / "tmaps" / f).read_bytes() == (tmp_path / "jmaps" / f).read_bytes(), f
    maps = IndexMap.load_directory(tmp_path / "tmaps")
    assert all(isinstance(m, OffHeapIndexMap) for m in maps.values()) and len(maps) == 3
    extra, _ = CONFIGS["fixed-and-per-user"]
    _, reference, _, refdir = trained["fixed-and-per-user"]
    s = ttrain.main(P.training_args(music, tmp_path / "o", extra + [
        "--index-maps-dir", str(tmp_path / "tmaps")]), device="cpu")
    assert s["best_metric"] == pytest.approx(reference["best_metric"], rel=1e-9)
    # off-heap stores stay where they are: no plain copy beside the models
    assert not (tmp_path / "o" / "index-maps").exists()
    for f in _files(refdir / "best"):
        assert (tmp_path / "o" / "best" / f).read_bytes() == (refdir / "best" / f).read_bytes(), f
    tscore.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                 str(tmp_path / "o" / "best"), "--index-maps-dir", str(tmp_path / "tmaps"),
                 "--output-dir", str(tmp_path / "s"), "--evaluators", "RMSE"], device="cpu")
    tscore.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                 str(refdir / "best"), "--output-dir", str(tmp_path / "r"), "--evaluators",
                 "RMSE"], device="cpu")
    np.testing.assert_array_equal(_scores(tmp_path / "s" / "scores"),
                                  _scores(tmp_path / "r" / "scores"))


MF_ARGS = ["--coordinate-configurations",
           "name=mf,mf.row.effect.type=userId,mf.col.effect.type=songId,mf.latent.factors=3,"
           "reg.weights=1,max.iter=20"]


def _initial_mf_model(directory) -> None:
    """An MF-only warm-start model saved by the JAX package: its own
    ``init_factors`` over the music fixture's sorted user and song keys (the
    training vocabs), so both drivers start from the same factors."""
    from photon_ml_tpu.io import model_io as jio
    from photon_ml_tpu.models.game import GameModel as JGameModel
    from photon_ml_tpu.models.matrix_factorization import MatrixFactorizationModel, init_factors
    from photon_ml_tpu.types import TaskType as JTask

    users = np.unique([f"user{i}" for i in range(P.N_USERS)])
    songs = np.unique([f"song{i}" for i in range(P.N_SONGS)])
    rows, cols = init_factors(len(users), len(songs), 3, seed=5)
    mf = MatrixFactorizationModel(row_factors=rows, col_factors=cols, row_effect_type="userId",
                                  col_effect_type="songId", row_keys=users, col_keys=songs,
                                  task=JTask.LINEAR_REGRESSION)
    jio.save_game_model(directory, JGameModel(models={"mf": mf}), {})


@pytest.fixture(scope="module")
def music_mf(tmp_path_factory):
    """The music fixture with a planted rank-3 user·song term."""
    base = tmp_path_factory.mktemp("music_mf")
    P.write_music(str(base), mf_rank=3)
    return base


@pytest.mark.parametrize("lanes", ["LBFGS", "AUTO"])
def test_mf_game_training_and_scoring_match_the_jax_drivers(music_mf, tmp_path, lanes):
    """A fixed effect plus a user × song MF coordinate through both training
    drivers, warm-started from the same saved MF model, then both scoring
    drivers on the JAX driver's model: validation RMSE within rel 1e-3 (and
    below the fixed effect's alone), metadata, id-info, index maps and
    feature statistics byte-identical, the same files, scores within
    1e-4 max|score|; the port's Avro scores equal its in-process scores of
    the loaded model."""
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model
    from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
    from photon_ml_torch.transformers import GameTransformer

    _initial_mf_model(tmp_path / "init")
    mf_args = [MF_ARGS[0], MF_ARGS[1] + f",optimizer={lanes}"]
    extra = P.FE_ARGS + mf_args + ["--coordinate-descent-iterations", "3", "--model-input-dir",
                                   str(tmp_path / "init")]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jsum = jtrain.main(P.training_args(music_mf, jdir, extra))
    tsum = ttrain.main(P.training_args(music_mf, tdir, extra), device="cpu")
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)
    fe_only = ttrain.main(P.training_args(music_mf, tmp_path / "fe", P.FE_ARGS), device="cpu")
    assert tsum["best_metric"] < 0.8 * fe_only["best_metric"]
    assert _files(tdir) == _files(jdir)
    assert "best/matrix-factorization/mf/row-latent-factors/part-00000.avro" in _files(tdir)
    for f in _files(jdir):
        if f.startswith(("index-maps", "feature-stats")) or f.endswith(
                ("model-metadata.json", "id-info")):
            assert (tdir / f).read_bytes() == (jdir / f).read_bytes(), f
    maps = IndexMap.load_directory(jdir / "index-maps")
    loaded = load_game_model(jdir / "best", maps, device="cpu")
    assert isinstance(loaded.get("mf"), MatrixFactorizationModel)
    args = ["--input-data-path", str(music_mf / "test"), "--model-input-dir", str(jdir / "best"),
            "--evaluators", "RMSE", *P.SHARD_ARGS]
    j = jscore.main(args + ["--output-dir", str(tmp_path / "sj")])
    t = tscore.main(args + ["--output-dir", str(tmp_path / "st")], device="cpu")
    sj, st = _scores(tmp_path / "sj" / "scores"), _scores(tmp_path / "st" / "scores")
    assert t["num_scored"] == j["num_scored"] == 400
    assert np.abs(sj - st).max() <= 1e-4 * np.abs(sj).max()
    assert t["evaluations"]["RMSE"] == pytest.approx(j["evaluations"]["RMSE"], rel=1e-4)
    shards = {name: FeatureShardConfiguration(feature_bags=(bag,), has_intercept=icpt)
              for name, bag, icpt in (("global", "features", True),
                                      ("userShard", "userFeatures", False),
                                      ("songShard", "songFeatures", False))}
    mf = loaded.get("mf")
    test = read_merged(music_mf / "test", shards, index_maps=maps,
                       random_effect_id_columns=("songId", "userId"),
                       entity_vocabs={"userId": mf.row_keys, "songId": mf.col_keys},
                       device="cpu")
    in_process = GameTransformer(model=loaded).transform(test.dataset).scores
    assert np.array_equal(st, np.asarray(in_process, dtype=np.float64))


def test_date_range_input_equals_the_single_directory(music, tmp_path):
    """--input-date-range and --validation-data-date-range over daily
    directories (<base>/daily/yyyy/MM/dd) train the same model as the same
    records passed as one directory, in the port and in the JAX driver."""
    from photon_ml_torch.io import avro as tavro
    from photon_ml_torch.util.date_range import DateRange, daily_path

    recs = list(tavro.read_directory(music / "train"))
    base = tmp_path / "days"
    for day, part in ((1, recs[:700]), (3, recs[700:])):
        d = daily_path(base, DateRange.parse("20260101-20260101").start.replace(day=day))
        os.makedirs(d)
        tavro.write_container(os.path.join(d, "part-00000.avro"), P.MUSIC_SCHEMA, part)
    os.makedirs(daily_path(base / "val", DateRange.parse("20260102-20260102").start))
    tavro.write_container(os.path.join(daily_path(base / "val", DateRange.parse(
        "20260102-20260102").start), "part-00000.avro"), P.MUSIC_SCHEMA,
        list(tavro.read_directory(music / "test")))
    extra = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]
    one = ttrain.main(P.training_args(music, tmp_path / "one", extra), device="cpu")
    ranged_args = P.training_args(music, tmp_path / "ranged", extra)
    ranged_args[ranged_args.index("--input-data-path") + 1] = str(base)
    ranged_args[ranged_args.index("--validation-data-path") + 1] = str(base / "val")
    ranged_args += ["--input-date-range", "20260101-20260104",
                    "--validation-data-date-range", "20260102-20260102"]
    ranged = ttrain.main(ranged_args, device="cpu")
    assert ranged["best_metric"] == one["best_metric"]
    for f in _files(tmp_path / "one" / "best"):
        assert (tmp_path / "ranged" / "best" / f).read_bytes() == \
            (tmp_path / "one" / "best" / f).read_bytes(), f
    jranged = jtrain.main([a.replace(str(tmp_path / "ranged"), str(tmp_path / "jranged"))
                           for a in ranged_args])
    assert ranged["best_metric"] == pytest.approx(jranged["best_metric"], rel=1e-3)
    bad = ranged_args[:]
    bad[bad.index("--input-date-range") + 1] = "20270101-20270102"
    with pytest.raises(FileNotFoundError, match="no daily input"):
        ttrain.main(bad + ["--override-output"], device="cpu")
