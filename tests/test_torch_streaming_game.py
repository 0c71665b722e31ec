"""Streamed GAME (``algorithm/streaming_game.py`` over ``io/stream_reader``'s
GAME chunk sources) against the JAX package's ``StreamingGameProgram`` on the
same chunks, and against the port's in-core ``GameEstimator.fit``, in f64 at
rel 1e-8: entity chunk plans and ``GameChunk`` arrays (in memory and Avro),
uniform and DuHL sweeps, ``schedule=None`` bitwise the uniform schedule,
resumes (a kill mid-sweep through ``run_with_recovery``, and checkpoints
written by either package resumed by the other), the fail-fast refusals,
streamed validation scoring, the streamed GAME driver against the JAX
driver, and the drivers' ``--max-restarts`` defaults against the JAX
parsers'."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import streaming_game as jsg
from photon_ml_tpu.io import stream_reader as jsr
from photon_ml_tpu.io.checkpoint import TrainingCheckpointer as JCheckpointer
from photon_ml_torch.algorithm import streaming_game as tsg
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.io.checkpoint import TrainingCheckpointer
from photon_ml_torch.resilience import recovery, run_with_recovery
from tests import torch_streaming_game_parity as SG

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

SWEEPS = 3


def _sources(arrays=None, chunk_records=24, cluster_by="user", hook=None):
    arrays = arrays or SG.game_arrays()
    kw = dict(arrays, chunk_records=chunk_records, cluster_by=cluster_by)
    return jsr.GameArrayChunkSource(**kw), tsr.GameArrayChunkSource(**kw, decode_hook=hook)


def _chunk_arrays(chunk) -> dict:
    out = {"labels": chunk.labels, "offsets": chunk.offsets, "weights": chunk.weights,
           "rows": chunk.rows, "num_records": np.asarray(chunk.num_records)}
    out.update({f"x/{k}": v for k, v in chunk.features.items()})
    out.update({f"e/{k}": v for k, v in chunk.entity_idx.items()})
    return out


def _assert_chunks_equal(jsrc, tsrc):
    assert [(s.index, s.num_records, s.runs) for s in tsrc.specs] == \
        [(s.index, s.num_records, tuple(s.runs)) for s in jsrc.specs]
    assert tsrc.chunk_rows == jsrc.chunk_rows and tsrc.dims == jsrc.dims
    for js, ts in zip(jsrc.specs, tsrc.specs):
        got, ref = _chunk_arrays(tsrc.load(ts)), _chunk_arrays(jsrc.load(js))
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
            assert got[k].dtype == np.asarray(ref[k]).dtype, k


# ---------------------------------------------------------------------------
# chunk plans and chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ents,budget", [
    (np.repeat(np.arange(5), [3, 10, 2, 7, 4]), 8),
    (np.repeat([0, 1, 2], [4, 20, 4]), 8),
    (np.full(30, -1, dtype=np.int64), 8),
    (np.array([1, 0, 1, 0, 1, 0]), 6),
    (np.random.default_rng(5).integers(-1, 12, size=200), 17),
], ids=["whole", "oversized", "absent", "order", "random"])
def test_entity_chunk_plans_match(ents, budget):
    jplan, tplan = jsr.plan_entity_chunks(ents, budget), tsr.plan_entity_chunks(ents, budget)
    assert len(tplan) == len(jplan)
    for a, b in zip(tplan, jplan):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsr.entities_spanning_chunks(tplan, ents),
                                  jsr.entities_spanning_chunks(jplan, ents))
    # a split plan: every entity split at the middle row spans
    cut = [np.arange(len(ents) // 2), np.arange(len(ents) // 2, len(ents))]
    np.testing.assert_array_equal(tsr.entities_spanning_chunks(cut, ents),
                                  jsr.entities_spanning_chunks(cut, ents))


def test_entity_chunk_plans_reject_a_nonpositive_budget():
    for mod in (jsr, tsr):
        with pytest.raises(ValueError, match="chunk_records must be positive"):
            mod.plan_entity_chunks(np.arange(4), 0)


@pytest.mark.parametrize("cluster_by", ["user", None], ids=["clustered", "row-ranges"])
def test_game_array_chunks_match(cluster_by):
    jsrc, tsrc = _sources(chunk_records=20, cluster_by=cluster_by)
    _assert_chunks_equal(jsrc, tsrc)


@pytest.fixture(scope="module")
def avro_input(tmp_path_factory):
    base = tmp_path_factory.mktemp("streamed-game-avro")
    return SG.write_avro(base, SG.avro_records()), SG.write_avro(
        base, SG.avro_records(n=60, seed=11), name="validation")


def _cfgs():
    from photon_ml_tpu.io.data_reader import FeatureShardConfiguration as JCfg
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration as TCfg

    return ({"global": JCfg(feature_bags=("features",))},
            {"global": TCfg(feature_bags=("features",))})


def _avro_sources(path, chunk_records=40, cluster_by="userId"):
    from photon_ml_tpu.io import avro as javro
    from photon_ml_torch.io import avro as tavro

    jcfg, tcfg = _cfgs()
    out = []
    for mod, avro, cfg in ((jsr, javro, jcfg), (tsr, tavro, tcfg)):
        files = avro.list_avro_files(path)
        maps, vocabs, keys, indexes, scalars = mod.scan_game_stream(
            files, cfg, ("userId",), cluster_by=cluster_by, dtype=np.float64)
        src = mod.GameAvroChunkSource(files, cfg, maps, chunk_records=chunk_records,
                                      random_effect_id_columns=("userId",),
                                      entity_vocabs=vocabs, cluster_by=cluster_by,
                                      cluster_keys=keys, indexes=indexes, dtype=np.float64)
        out.append((src, maps, vocabs, keys, scalars))
    return out


def test_scan_game_stream_matches(avro_input):
    (_, jmaps, jvocabs, jkeys, jscal), (_, tmaps, tvocabs, tkeys, tscal) = \
        _avro_sources(avro_input[0])
    assert list(tmaps["global"]) == list(jmaps["global"])
    np.testing.assert_array_equal(tvocabs["userId"], jvocabs["userId"])
    np.testing.assert_array_equal(tkeys, jkeys)
    for k in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(tscal[k], jscal[k])
        assert tscal[k].dtype == jscal[k].dtype
    np.testing.assert_array_equal(tscal["entity_idx"]["userId"], jscal["entity_idx"]["userId"])


@pytest.mark.parametrize("chunk_records", [40, 13], ids=["40", "13"])
def test_avro_entity_chunk_plans_and_chunks_match(avro_input, chunk_records):
    from photon_ml_tpu.io import avro as javro

    (jsrc, _, _, keys, _), (tsrc, _, _, _, _) = _avro_sources(avro_input[0], chunk_records)
    files = javro.list_avro_files(avro_input[0])
    jplan = jsr.plan_entity_chunks_avro(files, chunk_records, keys)
    tplan = tsr.plan_entity_chunks_avro(files, chunk_records, keys)
    assert [tuple(s.runs) for s in tplan[0]] == [tuple(s.runs) for s in jplan[0]]
    assert tplan[2:] == jplan[2:]
    assert len(tsrc.specs) > 1
    for start in tsrc.record_starts[1:]:
        assert keys[start - 1] != keys[start]
    _assert_chunks_equal(jsrc, tsrc)


def test_unclustered_avro_chunks_match(avro_input):
    (jsrc, *_), (tsrc, *_) = _avro_sources(avro_input[0], 48, cluster_by=None)
    assert tsrc.record_starts == [int(s) for s in jsrc.record_starts]
    _assert_chunks_equal(jsrc, tsrc)


# ---------------------------------------------------------------------------
# streamed sweeps against the JAX package and the in-core fit
# ---------------------------------------------------------------------------


def _train_both(arrays=None, task="LOGISTIC_REGRESSION", sweeps=SWEEPS, schedule=None,
                chunk_records=24, tolerance=0.0, **kw):
    jsrc, tsrc = _sources(arrays, chunk_records=chunk_records)
    out = []
    for pkg, src in (("jax", jsrc), ("torch", tsrc)):
        sched = None if schedule is None else schedule(pkg, src.num_chunks)
        prog = SG.program(pkg, src, task, schedule=sched, **kw)
        out.append((prog, prog.train(num_sweeps=sweeps, tolerance=tolerance)))
    return out


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_streamed_sweeps_match_the_jax_program(task):
    (_, jres), (_, tres) = _train_both(SG.game_arrays(task=task), task=task)
    SG.assert_states_close(tres.state, jres.state, 1e-8)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    assert tres.chunk_visits == jres.chunk_visits and tres.sweeps == jres.sweeps


def test_duhl_sweeps_match_the_jax_program():
    """The DuHL run on the gap-skewed fixture, both packages: the same
    visits, the same pinned sets every sweep and the same state."""
    kw = dict(task="LINEAR_REGRESSION", fe_shard="g", re_shard="p", max_iter=6, fe_l2=0.1,
              re_l2=1.0, chunk_records=64, sweeps=6,
              schedule=lambda pkg, c: SG.duhl(pkg, c, working_set=4))
    (jprog, jres), (tprog, tres) = _train_both(SG.skewed_arrays(), **kw)
    SG.assert_states_close(tres.state, jres.state, 1e-8)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    assert tres.chunk_visits == jres.chunk_visits
    assert tprog.schedule.cursor == jprog.schedule.cursor
    assert sorted(tprog.schedule.pinned()) == sorted(int(c) for c in jprog.schedule.pinned())
    np.testing.assert_allclose(tprog.schedule.importance, jprog.schedule.importance,
                               rtol=1e-8)


def test_duhl_reaches_tolerance_in_fewer_chunk_loads():
    def run(schedule):
        arrays = SG.skewed_arrays()
        src = tsr.GameArrayChunkSource(**arrays, chunk_records=64, cluster_by="user")
        prog = SG.program("torch", src, "LINEAR_REGRESSION", fe_shard="g", re_shard="p",
                          max_iter=6, schedule=None if schedule is None
                          else SG.duhl("torch", src.num_chunks, working_set=4))
        return prog, prog.train(num_sweeps=10, tolerance=1e-5)

    _, uniform = run(None)
    prog, duhl = run("duhl")
    assert duhl.chunk_visits < uniform.chunk_visits
    assert duhl.chunk_loads < uniform.chunk_loads
    assert abs(duhl.losses[-1] - uniform.losses[-1]) < 5e-3
    # the pinned working set is host arrays: bytes, and no tensor
    assert prog.cache_bytes() > 0
    assert all(isinstance(a, np.ndarray) for c in prog._cache._store.values()
               for a in c.features.values())


def test_schedule_none_is_bitwise_the_uniform_schedule():
    runs = []
    for schedule in (None, "uniform"):
        _, tsrc = _sources()
        sched = None if schedule is None else tsg.UniformChunkSchedule(tsrc.num_chunks)
        runs.append(SG.program("torch", tsrc, schedule=sched).train(num_sweeps=SWEEPS))
    assert runs[0].losses == runs[1].losses
    SG.assert_states_equal(runs[0].state, runs[1].state)


def test_streamed_sweeps_match_the_in_core_fit():
    """The port's streamed program against its own in-core
    ``GameEstimator.fit`` (coordinate descent, FE then per-user) on the same
    data: rel 1e-8."""
    from photon_ml_torch import estimators as test_
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.data.game_data import build_game_dataset
    from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
    from photon_ml_torch.types import TaskType

    arrays = SG.game_arrays()
    _, tsrc = _sources(arrays)
    streamed = SG.program("torch", tsrc, bucket_sizes=(8, 32, 128)).train(num_sweeps=SWEEPS)
    users = np.array([f"u{i}" for i in arrays["entity_idx"]["user"]])
    ds = build_game_dataset(labels=arrays["labels"], feature_shards=arrays["features"],
                            entity_keys={"user": users}, offsets=arrays["offsets"],
                            weights=arrays["weights"], dtype=np.float64, device="cpu")
    opt = OptimizerConfig(optimizer_type=OptimizerType.LBFGS, max_iterations=8)
    est = test_.GameEstimator(TaskType.LOGISTIC_REGRESSION, {
        "fixed": test_.FixedEffectCoordinateConfig(
            "global", CoordinateOptimizationConfig(optimizer=opt, l2_weight=0.1)),
        "user": test_.RandomEffectCoordinateConfig(
            "user", "per_entity", CoordinateOptimizationConfig(optimizer=opt, l2_weight=1.0),
            bucket_sizes=(8, 32, 128))}, num_iterations=SWEEPS)
    fit = est.fit(ds)
    model = fit.model
    in_core_losses = [h["train:LOGISTIC_LOSS"] for h in fit.metric_history
                      if h["coordinate"] == "user"]
    np.testing.assert_allclose(streamed.losses, in_core_losses, rtol=1e-8)
    fe = model.models["fixed"].glm.coefficients.means.numpy()
    table = model.models["user"].coefficients.numpy()
    sw = SG.state_np(streamed.state)
    assert np.abs(sw["fe"] - fe).max() <= 1e-8 * np.abs(fe).max()
    assert np.abs(sw["re/user"] - table).max() <= 1e-8 * np.abs(table).max()


def test_two_streamed_runs_are_bitwise_equal():
    runs = [SG.program("torch", _sources()[1]).train(num_sweeps=SWEEPS) for _ in range(2)]
    assert runs[0].losses == runs[1].losses
    SG.assert_states_equal(runs[0].state, runs[1].state)


def test_fe_epoch_split_is_recorded():
    _, tsrc = _sources()
    prog = SG.program("torch", tsrc)
    prog.train(num_sweeps=1)
    t = prog.timings
    assert t["fe_epochs"] >= 2 and t["fe_bytes"] > 0
    assert t["fe_solve"] > 0 and t["re_solve"] > 0 and t["fe_exchange"] == 0.0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_spanning_entity_fails_fast_with_the_reference_message():
    arrays = SG.game_arrays()
    msgs = []
    for pkg, mod in (("jax", jsr), ("torch", tsr)):
        src = mod.GameArrayChunkSource(**arrays, chunk_records=24, cluster_by=None)
        with pytest.raises(ValueError, match="span chunk boundaries") as ei:
            SG.program(pkg, src)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "random-effect coordinate 'user'" in msgs[1]


def test_mesh_and_the_lane_scheduler_are_refused():
    """The mesh is refused; the lane scheduler is ported (item 18): a
    fixed-effect spec that carries one builds, as in the JAX package, where
    only random effects schedule."""
    from photon_ml_torch.optim.optimizer import LaneSchedulerConfig, OptimizerConfig
    from photon_ml_torch.parallel.distributed import FixedEffectStepSpec
    from photon_ml_torch.types import TaskType

    _, tsrc = _sources()
    with pytest.raises(ValueError, match="no counterpart"):
        SG.program("torch", tsrc, mesh=object())
    fe = FixedEffectStepSpec("global", OptimizerConfig(scheduler=LaneSchedulerConfig()))
    prog = tsg.StreamingGameProgram(TaskType.LOGISTIC_REGRESSION, tsrc, fe, device="cpu")
    assert prog.fe.optimizer.scheduler is not None and prog._lane_schedulers == {}


@pytest.mark.parametrize("freeze", [0.0, 0.3], ids=["no-freeze", "freeze"])
def test_scheduled_streamed_sweeps_match_the_jax_program(freeze):
    """One lane scheduler per (RE type, chunk), in both packages: the same
    state, losses and chunk visits, with the probe and rescue run."""
    sched = dict(probe_iterations=2, freeze_coefficient_tolerance=freeze,
                 freeze_gradient_tolerance=freeze)
    (jprog, jres), (tprog, tres) = _train_both(SG.game_arrays(), scheduler=sched, max_iter=10)
    SG.assert_states_close(tres.state, jres.state, 1e-8)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    assert tres.chunk_visits == jres.chunk_visits
    assert sorted(tprog._lane_schedulers) == sorted(
        (k, int(c)) for k, c in jprog._lane_schedulers)
    for key, sch in tprog._lane_schedulers.items():
        jsch = jprog._lane_schedulers[key]
        assert dataclasses.asdict(sch.total_stats) == dataclasses.asdict(jsch.total_stats)
    assert sum(s.total_stats.lanes_rescued for s in tprog._lane_schedulers.values()) > 0


def test_checkpoint_of_another_schedule_fails_naming_the_field(tmp_path):
    _, tsrc = _sources()
    ck = TrainingCheckpointer(tmp_path / "ck")
    SG.program("torch", tsrc).train(num_sweeps=1, checkpointer=ck)
    _, tsrc = _sources()
    with pytest.raises(ValueError, match="schedule"):
        SG.program("torch", tsrc, schedule=SG.duhl("torch", tsrc.num_chunks, 2)).train(
            num_sweeps=2, checkpointer=ck)


# ---------------------------------------------------------------------------
# resumes
# ---------------------------------------------------------------------------


def test_a_kill_mid_sweep_resumes_bitwise(tmp_path):
    """A transient decode failure at sweep 2's first random-effect chunk (a
    load outside the FE epochs' retry policy) restarts the run through
    ``run_with_recovery``; the run restored from sweep 1's checkpoint ends
    bitwise equal to the uninterrupted one."""
    ref = SG.program("torch", _sources()[1]).train(num_sweeps=SWEEPS)
    loads = {"n": 0, "fault_at": None}

    def hook():
        loads["n"] += 1
        if loads["n"] == loads["fault_at"]:
            raise OSError(5, "injected EIO mid-sweep")

    # the loads of one sweep: the RE phase's are its last num_chunks
    _, counted = _sources(hook=hook)
    SG.program("torch", counted).train(num_sweeps=1)
    per_sweep = loads["n"]
    loads.update(n=0, fault_at=2 * per_sweep - counted.num_chunks + 1)
    recovery.reset_counts()
    ck = TrainingCheckpointer(tmp_path / "ck")
    _, tsrc = _sources(hook=hook)
    got = run_with_recovery(
        lambda restart: SG.program("torch", tsrc).train(num_sweeps=SWEEPS, checkpointer=ck),
        checkpointer=ck)
    assert loads["n"] > loads["fault_at"]
    assert recovery.counts["retries"] == 1 and recovery.counts["checkpoint_restores"] == 1
    assert got.losses == ref.losses
    SG.assert_states_equal(got.state, ref.state)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """One package trains a sweep and checkpoints it; the other resumes it
    to the end and matches the writer's uninterrupted run at rel 1e-8."""
    reader = "torch" if writer == "jax" else "jax"
    ck_cls = {"jax": JCheckpointer, "torch": TrainingCheckpointer}
    jsrc, tsrc = _sources()
    srcs = {"jax": jsrc, "torch": tsrc}
    ref = SG.program(writer, srcs[writer]).train(num_sweeps=SWEEPS)
    SG.program(writer, srcs[writer]).train(num_sweeps=1,
                                           checkpointer=ck_cls[writer](tmp_path / "ck"))
    got = SG.program(reader, srcs[reader]).train(num_sweeps=SWEEPS,
                                                 checkpointer=ck_cls[reader](tmp_path / "ck"))
    SG.assert_states_close(got.state, ref.state, 1e-8)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-8)
    with open(tmp_path / "ck" / f"step_{SWEEPS:08d}" / "meta.json") as f:
        assert json.load(f)["kind"] == "game_streaming"


# ---------------------------------------------------------------------------
# streamed validation scoring
# ---------------------------------------------------------------------------


def test_streamed_scores_match_in_core_and_the_jax_scorer(avro_input):
    """``score_game_stream`` against ``GameModel.score_dataset + offsets`` of
    the port and against the JAX package's ``score_game_stream``."""
    from photon_ml_tpu.io import avro as javro
    from photon_ml_torch.io import avro as tavro
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_torch.models.glm import GeneralizedLinearModel
    from photon_ml_torch.types import TaskType

    (jsrc, jmaps, jvocabs, _, _), (tsrc, tmaps, tvocabs, _, _) = _avro_sources(avro_input[0])
    tprog = SG.program("torch", tsrc, "LINEAR_REGRESSION", fe_shard="global",
                       re_shard="global", re_type="userId", max_iter=4)
    state = tprog.train(num_sweeps=2).state
    jcfg, tcfg = _cfgs()
    vfiles = tavro.list_avro_files(avro_input[1])
    tval = tsr.GameAvroChunkSource(vfiles, tcfg, tmaps, chunk_records=25,
                                   random_effect_id_columns=("userId",),
                                   entity_vocabs=tvocabs, dtype=np.float64)
    scores, scalars = tsg.score_game_stream(state, tval, TaskType.LINEAR_REGRESSION, "global",
                                            {"userId": "global"}, return_scalars=True)
    full = read_merged(avro_input[1], tcfg, index_maps=tmaps, random_effect_id_columns=(
        "userId",), entity_vocabs=tvocabs, dtype=np.float64, device="cpu").dataset
    model = GameModel(models={
        "fe": FixedEffectModel(glm=GeneralizedLinearModel(Coefficients(
            means=state.fe_coefficients), TaskType.LINEAR_REGRESSION), feature_shard_id="global"),
        "user": RandomEffectModel(coefficients=state.re_tables["userId"],
                                  entity_keys=tvocabs["userId"], random_effect_type="userId",
                                  feature_shard_id="global",
                                  task=TaskType.LINEAR_REGRESSION)})
    in_core = (model.score_dataset(full) + full.offsets).numpy()
    np.testing.assert_allclose(scores, in_core, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(scalars["labels"], full.host_array("labels"))
    # the JAX scorer on the same state and the same validation chunks
    from photon_ml_tpu.parallel.distributed import GameTrainState as JState
    from photon_ml_tpu.types import TaskType as JTask

    jval = jsr.GameAvroChunkSource(javro.list_avro_files(avro_input[1]), jcfg, jmaps,
                                   chunk_records=25, random_effect_id_columns=("userId",),
                                   entity_vocabs=jvocabs, dtype=np.float64)
    import jax.numpy as jnp

    jstate = JState(fe_coefficients=jnp.asarray(state.fe_coefficients.numpy()),
                    re_tables={"userId": jnp.asarray(state.re_tables["userId"].numpy())})
    jscores = jsg.score_game_stream(jstate, jval, JTask.LINEAR_REGRESSION, "global",
                                    {"userId": "global"})
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-12, atol=1e-12)
    assert isinstance(state.fe_coefficients, torch.Tensor)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def _driver_args(path, out, extra=(), validation=None):
    args = ["--input-data-path", str(path), "--root-output-dir", str(out),
            "--task-type", "LINEAR_REGRESSION",
            "--feature-shard-configurations", "name=global,feature.bags=features",
            "--coordinate-configurations",
            "name=fe,feature.shard=global,reg.weights=0.1,max.iter=40",
            "--coordinate-configurations",
            "name=per-user,feature.shard=global,random.effect.type=userId,reg.weights=1,"
            "max.iter=25",
            "--coordinate-descent-iterations", "2", *extra]
    if validation is not None:
        args += ["--validation-data-path", str(validation), "--evaluators", "RMSE"]
    return args


def _coefficients(root):
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.model_io import load_game_model

    maps = IndexMap.load_directory(str(root / "index-maps"))
    model = load_game_model(str(root / "best"), maps, device="cpu")
    return {"fe": model.models["fe"].glm.coefficients.means.double().numpy(),
            "user": model.models["per-user"].coefficients.double().numpy()}


@pytest.mark.parametrize("extra", [[], ["--duhl-working-set", "2"]], ids=["uniform", "duhl"])
def test_streamed_driver_matches_the_jax_driver(avro_input, tmp_path, extra):
    """The GAME training driver with ``--streaming-chunks`` in both packages
    (f32, the iteration budgets of the repo's driver tests): the coefficient
    files within the repo's driver bound 1e-3·max|w|, index maps byte-equal,
    the streamed validation metric within 1e-3 rel; and the streamed driver
    against the port's in-core driver on the same coordinates (trained
    without validation data, so its saved model is the last one too)."""
    from photon_ml_tpu.cli import game_training_driver as jdriver
    from photon_ml_torch.cli import game_training_driver as tdriver

    path, val = avro_input
    stream = ["--streaming-chunks", "40", *extra]
    j = jdriver.main(_driver_args(path, tmp_path / "j", stream, val))
    t = tdriver.main(_driver_args(path, tmp_path / "t", stream, val), device="cpu")
    jw, tw = _coefficients(tmp_path / "j"), _coefficients(tmp_path / "t")
    for k in jw:
        assert np.abs(tw[k] - jw[k]).max() <= 1e-3 * np.abs(jw[k]).max(), k
    assert (tmp_path / "t" / "index-maps").is_dir()
    for f in (tmp_path / "j" / "index-maps").iterdir():
        assert (tmp_path / "t" / "index-maps" / f.name).read_bytes() == f.read_bytes()
    assert t["streaming"]["chunks"] == j["streaming"]["chunks"] > 1
    assert t["streaming"]["schedule"] == j["streaming"]["schedule"]
    assert abs(t["best_metric"] - j["best_metric"]) <= 1e-3 * abs(j["best_metric"])
    # the streamed driver against the port's in-core driver on the same
    # coordinates: the fixed effect, as the JAX package's test compares them
    # (in f32 the per-user lanes end up to 1.6e-3·max|w| apart, from the
    # FE's chunked sums; in f64 the two agree to 1e-8,
    # test_streamed_sweeps_match_the_in_core_fit)
    tdriver.main(_driver_args(path, tmp_path / "c"), device="cpu")
    cw = _coefficients(tmp_path / "c")
    assert np.abs(tw["fe"] - cw["fe"]).max() <= 1e-3 * np.abs(cw["fe"]).max()


@pytest.mark.parametrize("extra,match", [
    (["--distributed"], "partitioned-io"),
    (["--normalization", "STANDARDIZATION"], "NONE"),
    (["--hyperparameter-tuning", "BAYESIAN"], "tuning"),
    (["--input-format", "libsvm"], "Avro"),
    (["--evaluators", "AUC:queryId"], "per-query"),
], ids=["distributed", "normalization", "tuning", "libsvm", "per-query"])
def test_streamed_driver_rejects_what_the_jax_driver_rejects(tmp_path, extra, match):
    from photon_ml_tpu.cli import game_training_driver as jdriver
    from photon_ml_torch.cli import game_training_driver as tdriver

    path = SG.write_avro(tmp_path, SG.avro_records(n=40))
    msgs = []
    for run, kw in ((jdriver.main, {}), (tdriver.main, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match) as ei:
            run(_driver_args(path, tmp_path / "out", ["--streaming-chunks", "20", *extra]),
                **kw)
        msgs.append(str(ei.value))
    # the streamed surface's problems, word for word (the JAX driver checks
    # tuning's evaluators where the port refuses tuning as not ported)
    streamed = [m for m in msgs[0].split(": ", 1)[1].split("; ")
                if not m.startswith("hyperparameter tuning requires")]
    assert streamed and all(m in msgs[1] for m in streamed)


def test_duhl_flag_requires_streaming(tmp_path):
    from photon_ml_torch.cli import game_training_driver as tdriver

    path = SG.write_avro(tmp_path, SG.avro_records(n=40))
    with pytest.raises(ValueError, match="streaming-chunks"):
        tdriver.main(_driver_args(path, tmp_path / "out", ["--duhl-working-set", "2"]),
                     device="cpu")


class _Parser(Exception):
    pass


def _jax_glm_parser(monkeypatch):
    """The JAX GLM driver's parser (built inside its ``main``): caught at
    ``parse_args``."""
    import argparse

    from photon_ml_tpu.cli import glm_driver as jglm

    def catch(self, *args, **kwargs):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parser) as ei:
        jglm.main([])
    monkeypatch.undo()
    return ei.value.args[0]


@pytest.mark.parametrize("which", ["game-params", "game-parser", "glm-params", "glm-parser"])
def test_max_restarts_defaults_match_the_jax_drivers(which, monkeypatch):
    """The port's ``--max-restarts`` defaults are the JAX drivers' (2): the
    parameter dataclasses' and the parsers'."""
    import dataclasses

    from photon_ml_tpu.cli import game_training_driver as jgame
    from photon_ml_tpu.cli import glm_driver as jglm
    from photon_ml_torch.cli import game_training_driver as tgame
    from photon_ml_torch.cli import glm_driver as tglm

    def field_default(cls):
        return next(f.default for f in dataclasses.fields(cls) if f.name == "max_restarts")

    def parser_default(parser):
        return next(a.default for a in parser._actions if a.dest == "max_restarts")

    if which == "game-params":
        got, ref = field_default(tgame.GameTrainingParams), field_default(jgame.GameTrainingParams)
    elif which == "game-parser":
        got, ref = parser_default(tgame.build_arg_parser()), parser_default(jgame.build_arg_parser())
    elif which == "glm-params":
        got, ref = field_default(tglm.GLMDriverParams), field_default(jglm.GLMDriverParams)
    else:
        got, ref = parser_default(tglm.build_arg_parser()), parser_default(
            _jax_glm_parser(monkeypatch))
    assert got == ref == 2
