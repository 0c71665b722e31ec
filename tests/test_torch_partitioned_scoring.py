"""The port's partitioned scoring and the drivers' ``--partitioned-io``, on
the CPU. score_partitioned on two spawned gloo ranks (each its own block;
dense, sparse and hybrid fixed effects) against the JAX package's
score_partitioned on two virtual ranks, rel 1e-8 (the models agree at
1e-8), and the ranks' rows in order against the JAX package's scores of the
whole held-out read. The GAME drivers with ``--partitioned-io --distributed``
on two gloo ranks against the same ranks' ``--distributed`` runs: the files
that hold no coefficients byte-identical, coefficients rel 1e-5 (f32
training), the per-rank score parts exactly the one-rank scores.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel.scoring import DistributedScorer as JScorer
from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io.index_map import IndexMap
from photon_ml_torch.io.model_io import load_game_model
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W
from tests import torch_partitioned_parity as PP

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

KINDS = ["dense", "sparse", "hybrid"]

SHARDS = ["--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
          "--feature-shard-configurations",
          "name=perUser,feature.bags=entityFeatures,intercept=false"]
COORDS = ["--coordinate-configurations", "name=fixed,feature.shard=global,reg.weights=1,"
          "max.iter=10",
          "--coordinate-configurations", "name=per_user,feature.shard=perUser,reg.weights=1,"
          "optimizer=NEWTON,max.iter=10,random.effect.type=userId"]


def _driver_runs(base: Path) -> list:
    train = PP.write_input(base / "drv_train", num_files=4, seed=11)
    held = PP.write_input(base / "drv_held", num_files=3, seed=12, clustered=False)
    out = base / "out"

    def training(name, *extra):
        return ("train", ["--input-data-path", train, "--root-output-dir", str(out / name),
                          "--task-type", "LINEAR_REGRESSION", *SHARDS, *COORDS,
                          "--coordinate-descent-iterations", "2", "--distributed", *extra])

    def scoring(name, *extra):
        return ("score", ["--input-data-path", held, "--model-input-dir",
                          str(out / "part" / "best"), "--output-dir", str(out / name), *SHARDS,
                          "--distributed", *extra])

    return [training("full"), training("part", "--partitioned-io"),
            scoring("scores-full"), scoring("scores-part", "--partitioned-io"),
            training("refused", "--partitioned-io", "--validation-data-path", held),
            scoring("scores-refused", "--partitioned-io", "--evaluators", "RMSE")]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tmp_path_factory.mktemp("partitioned-scoring")


@pytest.fixture(scope="module")
def kind_runs(base):
    """Per fixed-effect kind, its inputs and the two ranks' partitioned
    training and scoring, each spawned on its own the first time a test asks
    for it (one group's work a spawn keeps each well inside the join
    deadline when the suite loads the machine)."""
    cache = {}

    def run(kind):
        if kind not in cache:
            train = PP.write_input(base / f"{kind}_train", num_files=4, seed=21)
            held = PP.write_input(base / f"{kind}_held", num_files=3, seed=22, clustered=False)
            task = dict(kind="partitioned_train", path=train, configs=PP.CONFIGS[kind],
                        re_columns=["userId"], program=PP.program(), sweeps=2,
                        score={"path": held})
            ranks = base / f"ranks-{kind}"
            ranks.mkdir()
            cache[kind] = ((train, held), W.spawn_ranks(2, [task], ranks)[0])
        return cache[kind]

    return run


@pytest.fixture(scope="module")
def drivers(base):
    """The six driver runs on two spawned ranks, and their output root."""
    ranks = base / "ranks-drivers"
    ranks.mkdir()
    results = W.spawn_ranks(2, [dict(kind="driver_runs", runs=_driver_runs(base))], ranks)[0]
    return {"port": results, "out": base / "out"}


def _jax_scores(train: str, held: str, kind: str):
    """The JAX package's partitioned model, its score_partitioned of the
    held-out rows on two virtual ranks, and its score_dataset of the whole
    held-out read."""
    from photon_ml_tpu.io.data_reader import read_merged

    spec = PP.CONFIGS[kind]
    jres, jprog, jparts, jre = PP.jtrain_partitioned(train, spec, PP.program())
    model = jdist.state_to_game_model(jprog, jres.state, jparts[0].result.dataset,
                                      re_datasets=jre[0])
    kw = dict(index_maps=jparts[0].result.index_maps,
              entity_vocabs=jparts[0].result.dataset.entity_vocabs)
    held_parts, _ = PP.jread_ranks(held, spec, 2, **kw)
    scorer = JScorer(model, MP.jmesh(2))
    got = scorer.score_partitioned({r: held_parts[r].result.dataset for r in range(2)},
                                   held_parts[0].partition)
    full = read_merged(held, PP.jconfigs(spec), random_effect_id_columns=("userId",),
                       dtype=np.float64, **kw)
    return got, scorer.score_dataset(full.dataset)


@pytest.mark.parametrize("kind", KINDS)
def test_score_partitioned_matches_the_jax_package(kind_runs, kind):
    """Each rank's rows at rel 1e-8 of the JAX package's score_partitioned,
    and the ranks' rows in order those of its whole-read scores; each rank
    gets only its own true rows."""
    inputs, got = kind_runs(kind)
    jparts, jfull = _jax_scores(*inputs, kind)
    for r, out in enumerate(got):
        part = out["score_read"]["partition"]
        assert len(out["scores"]) == part[2][r] < part[3] * 2
        scale = np.abs(jparts[r]).max()
        np.testing.assert_allclose(out["scores"], jparts[r], rtol=1e-8, atol=1e-8 * scale)
    both = np.concatenate([o["scores"] for o in got])
    np.testing.assert_allclose(both, jfull, rtol=1e-8, atol=1e-8 * np.abs(jfull).max())


def test_partitioned_drivers_run_and_refuse(drivers):
    """Both ranks' partitioned training and scoring runs finish; validation
    data and evaluators with --partitioned-io raise the JAX package's
    messages."""
    local = []
    for out in drivers["port"]:
        train_full, train_part, score_full, score_part, refused, score_refused = out
        for run in (train_full, train_part, score_full, score_part):
            assert "summary" in run, run
        assert train_part["summary"]["distributed"]
        assert score_part["summary"]["num_scored"] == 120
        local.append(score_part["summary"]["num_scored_local"])
        assert 0 < score_part["summary"]["bytes_decoded_local"] \
            < score_part["summary"]["input_bytes_total"]
        assert refused["error"] == ("--partitioned-io does not support validation data yet; "
                                    "score + evaluate with the partitioned scoring driver")
        assert score_refused["error"] == ("--partitioned-io does not support --evaluators yet; "
                                          "evaluate through the non-partitioned scoring path")
    assert sum(local) == 120 and min(local) > 0


def test_partitioned_training_driver_matches_the_full_read(drivers):
    """Index maps, model metadata and id-info byte-identical to the
    --distributed run's; coefficients within 1e-5 of their largest; no
    feature statistics (they would summarize one rank's rows)."""
    out = drivers["out"]
    full, part = out / "full", out / "part"
    same = [p.relative_to(full) for p in sorted(full.rglob("*")) if p.is_file()
            and ("index-maps" in p.parts or p.name in ("id-info", "model-metadata.json"))]
    assert same
    for rel in same:
        assert (part / rel).read_bytes() == (full / rel).read_bytes(), rel
    assert (full / "feature-stats").is_dir() and not (part / "feature-stats").exists()
    maps = IndexMap.load_directory(full / "index-maps")
    a, b = (load_game_model(d / "best", maps, device="cpu") for d in (full, part))
    for cid, m in a.models.items():
        x = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
        y = b.get(cid).glm.coefficients.means if hasattr(m, "glm") else b.get(cid).coefficients
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(x.abs().max()))


def test_partitioned_score_parts_hold_the_one_rank_scores(drivers):
    """scores/part-00000.avro and part-00001.avro, in order, hold exactly the
    records the one-rank writer of the --distributed run wrote."""
    out = drivers["out"]
    parts = sorted(os.listdir(out / "scores-part" / "scores"))
    assert parts == ["part-00000.avro", "part-00001.avro"]
    got = [r for p in parts for r in tavro.read_container(out / "scores-part" / "scores" / p)]
    want = [r for p in sorted(os.listdir(out / "scores-full" / "scores"))
            for r in tavro.read_container(out / "scores-full" / "scores" / p)]
    assert len(got) == 120 and got == want
