"""Partitioned training and scoring and the GAME drivers over a mesh with a
model axis, in float64 (partitioned) and float32 (drivers) on the CPU.

The port runs in spawned gloo ranks (``tests/torch_mesh_worker.py``): a
group of 2 as a 1x2 mesh and one of 4 as a 2x2 mesh for the whole file. A
partitioned read's ranks are the data ranks: at 2x2 the two ranks of a data
row read the same block (``multihost.DataAxisExchange``), at 1x2 the one
data rank reads in full. Their training is held against the JAX package's
``train_partitioned`` over a data-axis mesh of the same data ranks (the
model axis changes no arithmetic beyond the order of sums) and against the
port's own full read with the same model axis. The drivers with ``--mesh
data=D,model=2`` are held against the JAX drivers over the same mesh and
against the port's one-process ``--distributed`` run.
"""

import json

import numpy as np
import pytest

from photon_ml_tpu.cli import game_training_driver as jtrain
from photon_ml_torch.cli import game_scoring_driver as tscore
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.io.avro import read_directory
from tests import torch_driver_parity as P
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W
from tests import torch_partitioned_parity as PP

SHAPES = {2: (1, 2), 4: (2, 2)}
CASES = {"dense": dict(num_files=4), "sparse": dict(num_files=4, seed=2)}
EXTRA = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]


def _mesh_flag(world: int) -> list:
    data, model = SHAPES[world]
    return ["--mesh", f"data={data},model={model}"]


def _driver_runs(music, world: int) -> list:
    out = music / f"w{world}"
    train = P.training_args(music, out / "train", EXTRA) + _mesh_flag(world)
    score = ["--input-data-path", str(music / "test"), "--model-input-dir",
             str(out / "train" / "best"), "--output-dir", str(out / "scores"),
             "--evaluators", "RMSE"] + _mesh_flag(world)
    ptrain = P.training_args(music, out / "ptrain", EXTRA, validation=False) \
        + _mesh_flag(world) + ["--partitioned-io"]
    pscore = ["--input-data-path", str(music / "test"), "--model-input-dir",
              str(out / "ptrain" / "best"), "--output-dir", str(out / "pscores"),
              "--partitioned-io"] + _mesh_flag(world)
    return [("train", train), ("score", score), ("train", ptrain), ("score", pscore)]


def _build_runs(base) -> dict:
    """The music fixture, the partitioned inputs and every spawned run of
    the file: a group of 2 (1x2) and one of 4 (2x2) ranks."""
    base.mkdir(parents=True, exist_ok=True)
    music = base / "music"
    music.mkdir()
    P.write_music(music)
    inputs = {name: PP.write_input(base / name, **kw) for name, kw in CASES.items()}
    out = {}
    for world, shape in SHAPES.items():
        tasks = {name: dict(kind="partitioned_train", path=inputs[name],
                            configs=PP.CONFIGS[name], re_columns=["userId"],
                            program=PP.program(), sweeps=2, mesh=shape,
                            fe_feature_sharded=True, full=True,
                            estimator=name == "dense",
                            score={"path": inputs[name]} if name == "dense" else None)
                 for name in CASES}
        tasks["drivers"] = dict(kind="driver_runs", runs=_driver_runs(music, world))
        names = list(tasks)
        spawn_dir = base / f"io{world}"
        spawn_dir.mkdir()
        results = W.spawn_ranks(world, [tasks[k] for k in names], spawn_dir)
        out[world] = dict(zip(names, results))
    return {"results": out, "inputs": inputs, "music": music}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Built once a run: the workers of an xdist run share one build
    (``torch_mesh_worker.run_once``) instead of each spawning its own six
    ranks for the same results."""
    return W.run_once("model_axis_io", _build_runs, tmp_path_factory.mktemp("model-axis-io"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_feature_sharded_matches_the_jax_package(runs, case, world):
    """train_partitioned(fe_feature_sharded=True): losses and the gathered
    state at rel 1e-8 of the JAX package's train_partitioned over the same
    data ranks, on every rank."""
    data = SHAPES[world][0]
    jres = PP.jtrain_partitioned(runs["inputs"][case], PP.CONFIGS[case], PP.program(),
                                 num_ranks=data)[0]
    ref = MP.state_numpy(jres.state)
    for r in runs["results"][world][case]:
        np.testing.assert_allclose(r["losses"], jres.losses, rtol=1e-8)
        MP.assert_states_close(r["state"], ref, 1e-8)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_feature_sharded_matches_the_full_read(runs, case, world):
    """On entity-clustered input the partitioned run lands on the full
    read's feature-sharded train_distributed state at rel 1e-10; each rank
    holds its FE block of ceil(d/2) and the ranks of a data row read the
    same block."""
    got = runs["results"][world][case]
    for r in got:
        np.testing.assert_allclose(r["losses"], r["full"]["losses"], rtol=1e-10)
        MP.assert_states_close(r["state"], r["full"]["state"], 1e-10)
        d = len(r["state"]["fe_coefficients"])
        assert r["block"]["fe_coefficients"].shape == (-(-d // 2),)
    model = SHAPES[world][1]
    for i in range(0, len(got), model):
        for r in got[i + 1:i + model]:
            np.testing.assert_array_equal(r["read"]["labels"], got[i]["read"]["labels"])


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_estimator_and_scores_over_a_model_axis(runs, world):
    """GameEstimator(partition=, fe_feature_sharded=True) gives
    train_partitioned's model at rel 1e-10; score_partitioned with the FE
    feature-sharded scores every rank's rows, finite, the ranks of a data
    row bitwise alike."""
    got = runs["results"][world]["dense"]
    for r in got:
        est, prog = r["estimator"], r["program_model"]
        np.testing.assert_allclose(est["fixed"]["means"], prog["global"]["means"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(est["userId"]["table"], prog["userId"]["table"], rtol=1e-10,
                                   atol=1e-12)
        assert np.isfinite(r["scores"]).all() and len(r["scores"]) > 0
    model = SHAPES[world][1]
    for i in range(0, len(got), model):
        for r in got[i + 1:i + model]:
            np.testing.assert_array_equal(r["scores"], got[i]["scores"])


def _coefficients(path) -> dict:
    """{(directory, model id): {(name, term): value}} of every model record
    under ``path``."""
    out = {}
    for d in sorted({f.parent for f in path.rglob("*.avro")}):
        for rec in read_directory(d):
            out[(str(d.relative_to(path)), rec.get("modelId", ""))] = {
                (m["name"], m["term"]): m["value"] for m in rec["means"]}
    return out


def _gap(a: dict, b: dict) -> float:
    """The largest coefficient difference over the largest of ``b``."""
    keys = set(a) | set(b)
    ref = np.asarray([b.get(k, 0.0) for k in keys])
    got = np.asarray([a.get(k, 0.0) for k in keys])
    return float(np.abs(got - ref).max(initial=0.0) / max(np.abs(ref).max(initial=0.0), 1e-6))


def _scores(path) -> np.ndarray:
    return np.asarray([r["predictionScore"] for r in read_directory(path / "scores")])


def _same_files(a, b, names=("id-info", "model-metadata.json")) -> None:
    for sub in ("index-maps", "best"):
        for f in sorted((b / sub).rglob("*")):
            if f.is_file() and (sub == "index-maps" or f.name in names):
                rel = f.relative_to(b)
                assert (a / rel).read_bytes() == f.read_bytes(), rel


@pytest.mark.parametrize("world", [2, 4])
def test_drivers_over_a_model_axis_match(runs, tmp_path, world):
    """The training and scoring drivers with --mesh data=D,model=2 (the
    fixed effect feature-sharded, as the JAX driver does for model > 1):
    index maps, model metadata and id-info byte-identical to the JAX
    driver's over the same mesh and to the port's one-process
    --distributed run; coefficients within 1e-3 of their largest against
    both, the repo's driver bound (float32 in both packages: the sums change
    order with the package and the rank count, and the per-user lanes end
    up to 2.5e-4 apart here); the written scores within 1e-4 of the
    one-process run's."""
    got = runs["results"][world]["drivers"]
    assert got[0][0]["summary"]["distributed"] is True
    music = runs["music"]
    out = music / f"w{world}"
    jtrain.main(P.training_args(music, tmp_path / "jax", EXTRA) + _mesh_flag(world))
    one = tmp_path / "one"
    ttrain.main(P.training_args(music, one, EXTRA) + ["--distributed"], device="cpu")
    for ref in (tmp_path / "jax", one):
        _same_files(out / "train", ref)
    mine = _coefficients(out / "train" / "best")
    for ref, limit in ((_coefficients(tmp_path / "jax" / "best"), 1e-3),
                       (_coefficients(one / "best"), 1e-3)):
        assert set(mine) == set(ref)
        for key, v in ref.items():
            assert _gap(mine[key], v) <= limit, (key, limit, _gap(mine[key], v))
    tscore.main(["--input-data-path", str(music / "test"), "--model-input-dir",
                 str(one / "best"), "--output-dir", str(tmp_path / "s1"), "--evaluators",
                 "RMSE", "--distributed"], device="cpu")
    s1, s2 = _scores(tmp_path / "s1"), _scores(out / "scores")
    assert len(s2) == 400
    np.testing.assert_allclose(s2, s1, rtol=1e-4, atol=1e-4 * np.abs(s1).max())
    summary = json.loads((out / "scores" / "scoring-summary.json").read_text())
    assert summary["num_scored"] == 400 and np.isfinite(summary["evaluations"]["RMSE"])


@pytest.mark.parametrize("world", [2, 4])
def test_partitioned_drivers_over_a_model_axis(runs, world):
    """--partitioned-io with --mesh data=D,model=2: the training driver's
    model equals its full-read run's (the same mesh) within 1e-3 of the
    largest coefficient, and the scoring driver writes one part per data
    rank, 400 scores in all, within 1e-4 of the full-read scoring's."""
    got = runs["results"][world]["drivers"]
    assert all("summary" in run for r in got for run in r), got[0]
    out = runs["music"] / f"w{world}"
    mine, full = _coefficients(out / "ptrain" / "best"), _coefficients(out / "train" / "best")
    for key, v in full.items():
        assert _gap(mine[key], v) <= 1e-3, key
    parts = sorted((out / "pscores" / "scores").glob("part-*.avro"))
    assert len(parts) == SHAPES[world][0]
    s = _scores(out / "pscores")
    assert len(s) == 400
    np.testing.assert_allclose(np.sort(s), np.sort(_scores(out / "scores")), rtol=1e-4,
                               atol=1e-4 * np.abs(s).max())
