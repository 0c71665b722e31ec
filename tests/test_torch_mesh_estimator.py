"""``GameEstimator(mesh=...)`` and the GAME drivers' ``--distributed`` on the
CPU, in one group of 2 spawned gloo ranks (``tests/torch_mesh_worker.py``).

The estimator cases (after the JAX package's
``tests/test_estimator_distributed.py``) are held in float64 against the
JAX package's ``_fit_distributed`` on a data=2 virtual CPU mesh; an MF case,
whose initial factors differ between the packages by design, against the
port's own mesh estimator in a group of one in this process. The drivers
(float32) are held against the same drivers without ``--distributed`` and
with it in one process.
"""

import json

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCoordOpt
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch.cli import game_scoring_driver as tscore
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.io.avro import read_directory
from tests import torch_driver_parity as P
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

LBFGS20 = ("LBFGS", 20, {})
FE = dict(kind="fe", shard="global", opt=LBFGS20, l2=1.0)
RE = dict(kind="re", type="user", shard="per_entity", opt=LBFGS20, l2=1.0)


def _data():
    a = MP.arrays(3, n=263, users=12, task="LINEAR_REGRESSION")
    return MP.split(a, 60)


def _estimator_tasks() -> dict:
    train, val = _data()
    adversarial = dict(train, labels=-train["labels"])
    base = dict(kind="estimator", task="LINEAR_REGRESSION", data=train, validation=val,
                evaluators=["RMSE"], sweeps=3)
    slow_fe = dict(FE, opt=("LBFGS", 1, {}))
    mf = dict(kind="mf", row="user", col="item", k=2, opt=LBFGS20, l2=1.0, alternations=1)
    return {
        "matches": dict(base, coordinates={"fe": FE, "per-user": RE}),
        "best_not_last": dict(base, validation=adversarial, coordinates={"fe": slow_fe}),
        "down_sampling": dict(base, coordinates={"fe": dict(FE, rate=0.5), "per-user": RE},
                              sweeps=2),
        "two_fe": dict(base, coordinates={"fe": FE, "fe2": dict(FE, shard="per_entity", l2=0.3),
                                          "per-user": RE}),
        "random_effects_only": dict(base, coordinates={"per-user": RE}),
        "locked": dict(base, coordinates={"fe": FE, "per-user": RE}, locked=["fe"], sweeps=2),
        "mf": dict(base, coordinates={"fe": FE, "per-user": RE, "mf": mf}, sweeps=2),
    }


def _initial_model_spec(train) -> dict:
    rng = np.random.default_rng(11)
    d = train["shards"]["global"].shape[1]
    return {"__task__": "LINEAR_REGRESSION",
            "fe": {"kind": "fe", "means": rng.normal(size=d), "shard": "global"}}


def _jax_fit(task: dict, data_axis: int = 2):
    def opt(c):
        return JCoordOpt(optimizer=MP._opt(c["opt"]), l2_weight=c["l2"],
                         down_sampling_rate=c.get("rate", 1.0))

    configs = {}
    for cid, c in task["coordinates"].items():
        if c["kind"] == "fe":
            configs[cid] = jest.FixedEffectCoordinateConfig(c["shard"], opt(c))
        else:
            configs[cid] = jest.RandomEffectCoordinateConfig(c["type"], c["shard"], opt(c))
    ds = MP.jdataset(task["data"])
    val = MP.jdataset(task["validation"], vocabs=ds.entity_vocabs)
    initial = None
    if task.get("initial"):
        spec = task["initial"]
        initial = jgame.GameModel(models={
            cid: jgame.FixedEffectModel(glm=JGLM(JCoefficients(means=np.asarray(m["means"])),
                                                 JTask[spec["__task__"]]),
                                        feature_shard_id=m["shard"])
            for cid, m in spec.items() if cid != "__task__"})
    est = jest.GameEstimator(task=JTask[task["task"]], coordinate_configs=configs,
                             num_iterations=task["sweeps"],
                             validation_evaluators=tuple(task["evaluators"]),
                             locked_coordinates=frozenset(task.get("locked", ())),
                             mesh=MP.jmesh(data_axis))
    return est.fit(ds, validation_dataset=val, initial_model=initial)


def _jax_models(model) -> dict:
    out = {}
    for cid, m in model.models.items():
        if hasattr(m, "glm"):
            out[cid] = {"means": np.asarray(m.glm.coefficients.means)}
        else:
            out[cid] = {"table": np.asarray(m.coefficients), "keys": np.asarray(m.entity_keys)}
    return out


def _driver_tasks(base) -> dict:
    extra = P.FE_ARGS + P.PER_USER_ARGS + P.PER_SONG_ARGS + ["--coordinate-descent-iterations",
                                                           "2"]
    args = P.training_args(base, base / "dist2", extra) + ["--distributed"]
    score = ["--input-data-path", str(base / "test"), "--model-input-dir",
             str(base / "dist2" / "best"), "--output-dir", str(base / "scores2"),
             "--evaluators", "RMSE", "--mesh", "data=2"]
    return {"drivers": dict(kind="driver", train_args=args, score_args=score)}


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    base = tmp_path_factory.mktemp("music")
    P.write_music(base)
    return base


@pytest.fixture(scope="module")
def runs(tmp_path_factory, music):
    tasks = _estimator_tasks()
    tasks["locked"]["initial"] = _initial_model_spec(tasks["locked"]["data"])
    tasks.update(_driver_tasks(music))
    names = list(tasks)
    results = W.spawn_ranks(2, [tasks[k] for k in names], tmp_path_factory.mktemp("ranks2"))
    return {"tasks": tasks, "results": dict(zip(names, results))}


@pytest.mark.parametrize("name", ["matches", "best_not_last", "down_sampling", "two_fe",
                                  "random_effects_only", "locked"])
def test_mesh_estimator_matches_the_jax_fit_distributed(runs, name):
    """Final and best models, best metric and the per-sweep history at rel
    1e-8 of the JAX package's GameEstimator(mesh=data=2 mesh)."""
    task = runs["tasks"][name]
    got = runs["results"][name]
    jres = _jax_fit(task)
    for which, jmodel in (("model", jres.model), ("best", jres.best_model)):
        ref = _jax_models(jmodel)
        assert list(got[0][which]) == list(ref), which
        for cid, r in ref.items():
            for key, v in r.items():
                if key == "keys":
                    assert np.array_equal(got[0][which][cid][key].astype(str), v.astype(str))
                    continue
                np.testing.assert_allclose(got[0][which][cid][key], v, rtol=1e-8,
                                           atol=1e-8 * max(np.abs(v).max(), 1e-30),
                                           err_msg=f"{which}/{cid}/{key}")
    assert got[0]["best_metric"] == pytest.approx(jres.best_metric, rel=1e-8)
    assert len(got[0]["history"]) == len(jres.metric_history)
    for a, b in zip(got[0]["history"], jres.metric_history):
        for k in b:
            if k.startswith(("validate:", "train:")):
                assert a[k] == pytest.approx(b[k], rel=1e-8), k
    if name == "best_not_last":
        vals = [h["validate:RMSE"] for h in got[0]["history"]]
        assert min(vals) < vals[-1] and got[0]["best_metric"] == pytest.approx(min(vals))
    if name == "locked":
        spec = task["initial"]["fe"]["means"]
        assert np.array_equal(got[0]["model"]["fe"]["means"], spec)
    for r in got[1:]:  # every rank returns the same model
        for cid, m in got[0]["model"].items():
            for key, v in m.items():
                if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                    assert np.array_equal(r["model"][cid][key], v), (cid, key)


def test_mesh_estimator_with_mf_matches_a_group_of_one(runs):
    """An MF coordinate through GameEstimator(mesh=...): two ranks at rel
    1e-10 of the same fit over a one-rank group in this process (the JAX
    package draws other initial factors by design)."""
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import make_mesh

    task = runs["tasks"]["mf"]
    got = runs["results"]["mf"][0]
    assert list(got["model"]) == ["fe", "per-user", "mf"]
    multihost.initialize(device="cpu")
    try:
        one = W._task_estimator(task, 0, 1, None)
        assert make_mesh().size(0) == 1
    finally:
        multihost.shutdown()
    for cid, m in one["model"].items():
        for key, v in m.items():
            if isinstance(v, np.ndarray) and v.dtype.kind == "f":
                np.testing.assert_allclose(got["model"][cid][key], v, rtol=1e-10,
                                           atol=1e-10 * np.abs(v).max(), err_msg=f"{cid}/{key}")
    assert np.isfinite(got["best_metric"]) and got["best_metric"] == pytest.approx(
        one["best_metric"], rel=1e-10)


def _coefficients(path) -> dict:
    """(coefficients directory, model id) -> {(name, term): value} of every
    model record under ``path``."""
    out = {}
    for d in sorted({f.parent for f in path.rglob("*.avro")}):
        for rec in read_directory(d):
            out[(str(d.relative_to(path)), rec.get("modelId", ""))] = {
                (m["name"], m["term"]): m["value"] for m in rec["means"]}
    return out


def _close(a: dict, b: dict, limit: float) -> bool:
    keys = set(a) | set(b)
    ref = np.asarray([b.get(k, 0.0) for k in keys])
    got = np.asarray([a.get(k, 0.0) for k in keys])
    return bool(np.abs(got - ref).max(initial=0.0) <= limit * max(np.abs(ref).max(initial=0.0),
                                                                 1e-6))


def _scores(path) -> np.ndarray:
    return np.asarray([r["predictionScore"] for r in read_directory(path / "scores")])


def test_distributed_drivers_match_the_one_process_runs(runs, music, tmp_path):
    """The training and scoring drivers with --distributed over two ranks:
    rank 0 writes the outputs, rank 1 a scratch directory; index maps,
    model metadata and id-info are byte-identical to the run without
    --distributed; coefficients within 1e-3 of their largest against the
    --distributed run in one process and against the coordinate-descent run
    (f32: the sums change order with the rank count, and the L-BFGS and lane
    solves amplify the last bits to about 1e-4 here); the written scores
    within 1e-4."""
    got = runs["results"]["drivers"]
    assert got[0]["train"]["distributed"] is True
    assert (music / "dist2" / ".worker-1").is_dir()
    extra = P.FE_ARGS + P.PER_USER_ARGS + P.PER_SONG_ARGS + ["--coordinate-descent-iterations",
                                                           "2"]
    ttrain.main(P.training_args(music, tmp_path / "plain", extra), device="cpu")
    one = ttrain.main(P.training_args(music, tmp_path / "dist1", extra) + ["--distributed"],
                      device="cpu")
    assert one["distributed"] is True and not torch.distributed.is_initialized()
    for sub in ("index-maps", "best"):
        for f in sorted((tmp_path / "plain" / sub).rglob("*")):
            if f.is_file() and (sub == "index-maps" or f.name in ("id-info",
                                                                  "model-metadata.json")):
                rel = f.relative_to(tmp_path / "plain")
                assert (music / "dist2" / rel).read_bytes() == f.read_bytes(), rel
    two = _coefficients(music / "dist2" / "best")
    for ref, limit in ((_coefficients(tmp_path / "dist1" / "best"), 1e-3),
                       (_coefficients(tmp_path / "plain" / "best"), 1e-3)):
        assert set(two) == set(ref)
        for key, v in ref.items():
            assert _close(two[key], v, limit), key
    tscore.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                 str(tmp_path / "dist1" / "best"), "--output-dir", str(tmp_path / "scores1"),
                 "--evaluators", "RMSE", "--distributed"], device="cpu")
    s1, s2 = _scores(tmp_path / "scores1"), _scores(music / "scores2")
    assert len(s2) == 400
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4 * np.abs(s1).max())
    summary = json.loads((music / "scores2" / "scoring-summary.json").read_text())
    assert summary["num_scored"] == 400 and np.isfinite(summary["evaluations"]["RMSE"])
