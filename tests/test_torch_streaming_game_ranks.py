"""Streamed GAME over several ranks: ``io/stream_reader
.plan_partitioned_game_stream`` and ``StreamingGameProgram(partition=,
exchange=)``. Virtual ranks are threads over ``InProcessExchange``, as in
``tests/test_streaming_game_ranks.py``; one case runs two spawned gloo ranks
over the group's ``DistributedKVExchange``. In f64: the agreed plan field for
field (fingerprint included) against the JAX package's; two ranks bitwise
equal to each other, within rel 1e-8 of one rank and of the JAX package's two
ranks; identical DuHL decisions on every rank every sweep; a coordinated
rollback bitwise the uninterrupted run; and the fail-fast cases (a disagreed
plan, another rank geometry, a withheld allgather)."""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

from dev import faultinject
from photon_ml_tpu.io import stream_reader as jsr
from photon_ml_tpu.parallel.multihost import InProcessExchange as JInProcess
from photon_ml_tpu.resilience import ExchangeTimeout as JExchangeTimeout
from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.io.checkpoint import TrainingCheckpointer
from photon_ml_torch.parallel.multihost import InProcessExchange
from photon_ml_torch.resilience import (
    CoordinatedRecovery,
    ExchangeTimeout,
    run_with_recovery,
)
from tests import torch_streaming_game_parity as SG

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

NUM_RANKS = 2
CHUNK_RECORDS = 40
SWEEPS = 2

PKG = {"jax": (jsr, JInProcess), "torch": (tsr, InProcessExchange)}


def _cfg(pkg):
    if pkg == "jax":
        from photon_ml_tpu.io.data_reader import FeatureShardConfiguration
    else:
        from photon_ml_torch.io.data_reader import FeatureShardConfiguration
    return {"global": FeatureShardConfiguration(feature_bags=("features",))}


def _run_ranks(n, fn, timeout=300.0):
    results, errors = [None] * n, [None] * n

    def work(r):
        try:
            results[r] = fn(r)
        except Exception as e:  # asserted by the caller
            errors[r] = e

    threads = [threading.Thread(target=work, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a streamed rank hung"
    return results, errors


def _plan(pkg, path, exchange, chunk_records=CHUNK_RECORDS, schedule_budget=None):
    return PKG[pkg][0].plan_partitioned_game_stream(
        path, _cfg(pkg), ("userId",), exchange=exchange, chunk_records=chunk_records,
        cluster_by="userId", schedule_budget=schedule_budget, dtype=np.float64)


def _program(pkg, source, vocabs, *, partition=None, exchange=None, schedule=None, **kw):
    return SG.program(pkg, source, "LINEAR_REGRESSION", fe_shard="global", re_shard="global",
                      re_type="userId", max_iter=4,
                      num_entities={"userId": len(vocabs["userId"])}, schedule=schedule,
                      exchange=exchange, partition=partition, **kw)


def _single(pkg, path, sweeps=SWEEPS):
    mod = PKG[pkg][0]
    avro = tavro
    if pkg == "jax":
        from photon_ml_tpu.io import avro
    files = avro.list_avro_files(path)
    maps, vocabs, keys, indexes, _ = mod.scan_game_stream(
        files, _cfg(pkg), ("userId",), cluster_by="userId", dtype=np.float64)
    src = mod.GameAvroChunkSource(files, _cfg(pkg), maps, chunk_records=CHUNK_RECORDS,
                                  random_effect_id_columns=("userId",), entity_vocabs=vocabs,
                                  cluster_by="userId", cluster_keys=keys, indexes=indexes,
                                  dtype=np.float64)
    return _program(pkg, src, vocabs).train(num_sweeps=sweeps)


def _ranks(pkg, path, *, sweeps=SWEEPS, working_set=0, exchanges=None, checkpointers=None,
           coordinators=None):
    """Every rank plans and trains; returns (results, errors, pins per rank)."""
    group = exchanges or PKG[pkg][1].create_group(NUM_RANKS, timeout=60.0)
    pins = [[] for _ in group]

    def fn(r):
        def attempt(restart=0):
            source, _maps, vocabs, part = _plan(pkg, path, group[r])
            schedule = (SG.duhl(pkg, part.num_chunks, working_set=working_set)
                        if working_set else None)
            prog = _program(pkg, source, vocabs, partition=part, exchange=group[r],
                            schedule=schedule)
            real = prog._cache.set_pinned

            def record(pinned, _real=real, _prog=prog):
                # the global decision of the sweep (each rank pins its part)
                pins[r].append(sorted(int(g) for g in _prog.schedule.pinned()))
                _real(pinned)

            prog._cache.set_pinned = record
            coord = coordinators[r] if coordinators else None
            return prog.train(num_sweeps=sweeps,
                              checkpointer=checkpointers[r] if checkpointers else None,
                              resume_step=coord.resume_step if coord else None)

        if coordinators is None:
            return attempt()
        return run_with_recovery(attempt, checkpointer=checkpointers[r],
                                 coordinator=coordinators[r], description=f"rank {r}")

    results, errors = _run_ranks(NUM_RANKS, fn)
    return results, errors, pins


@pytest.fixture(scope="module")
def avro_path(tmp_path_factory):
    return SG.write_avro(tmp_path_factory.mktemp("ranks"), SG.avro_records())


@pytest.fixture(scope="module")
def port_ranks(avro_path):
    results, errors, _ = _ranks("torch", avro_path)
    assert errors == [None, None], errors
    return results


# ---------------------------------------------------------------------------
# the agreed plan
# ---------------------------------------------------------------------------


def test_two_rank_plan_matches_the_jax_plan(avro_path):
    plans = {}
    for pkg in PKG:
        group = PKG[pkg][1].create_group(NUM_RANKS, timeout=60.0)
        results, errors = _run_ranks(NUM_RANKS, lambda r: _plan(pkg, avro_path, group[r]))
        assert errors == [None, None], errors
        plans[pkg] = results
    for r in range(NUM_RANKS):
        (js, jmaps, jvocabs, jpart), (ts, tmaps, tvocabs, tpart) = plans["jax"][r], \
            plans["torch"][r]
        assert dataclasses.asdict(tpart) == dataclasses.asdict(jpart)
        assert [(s.index, s.num_records, tuple(s.runs)) for s in ts.specs] == \
            [(s.index, s.num_records, tuple(s.runs)) for s in js.specs]
        assert ts.record_starts == js.record_starts and ts._skips == js._skips
        assert ts.chunk_rows == js.chunk_rows and ts.scan_bytes == js.scan_bytes
        assert list(tmaps["global"]) == list(jmaps["global"])
        np.testing.assert_array_equal(tvocabs["userId"], jvocabs["userId"])
        for spec in ts.specs:  # each rank decodes only its chunks, array for array
            tc, jc = ts.load(spec), js.load(js.specs[spec.index])
            np.testing.assert_array_equal(tc.features["global"], jc.features["global"])
            np.testing.assert_array_equal(tc.rows, jc.rows)
    tparts = [plans["torch"][r][3] for r in range(NUM_RANKS)]
    assert tparts[0].fingerprint == tparts[1].fingerprint
    assert tparts[0].chunk_ranges[0][1] == tparts[0].chunk_ranges[1][0]
    assert sum(p.payload_bytes[p.rank] for p in tparts) >= tparts[0].input_bytes * 0.5


def test_disagreed_plan_fails_fast_naming_the_field(avro_path):
    msgs = {}
    for pkg in PKG:
        group = PKG[pkg][1].create_group(NUM_RANKS, timeout=60.0)
        _, errors = _run_ranks(NUM_RANKS, lambda r: _plan(
            pkg, avro_path, group[r], chunk_records=CHUNK_RECORDS + 10 * r))
        assert all(isinstance(e, RuntimeError) for e in errors), errors
        msgs[pkg] = str(errors[0])
    assert "chunk_records: rank0=40, rank1=50" in msgs["torch"]
    assert msgs["torch"] == msgs["jax"]


# ---------------------------------------------------------------------------
# training over ranks
# ---------------------------------------------------------------------------


def test_two_ranks_end_bitwise_equal_and_match_one_rank(avro_path, port_ranks):
    SG.assert_states_equal(port_ranks[0].state, port_ranks[1].state)
    assert port_ranks[0].losses == port_ranks[1].losses
    single = _single("torch", avro_path)
    SG.assert_states_close(port_ranks[0].state, single.state, 1e-8)
    np.testing.assert_allclose(port_ranks[0].losses, single.losses, rtol=1e-8)


def test_two_ranks_match_the_jax_ranks(avro_path, port_ranks):
    results, errors, _ = _ranks("jax", avro_path)
    assert errors == [None, None], errors
    for r in range(NUM_RANKS):
        SG.assert_states_close(port_ranks[r].state, results[r].state, 1e-8)
        np.testing.assert_allclose(port_ranks[r].losses, results[r].losses, rtol=1e-8)
        assert port_ranks[r].chunk_visits == results[r].chunk_visits


def test_duhl_decisions_are_identical_on_every_rank(avro_path):
    """One allgathered importance signal drives one schedule: every rank
    pins the same global chunks every sweep, as the JAX package's ranks do."""
    runs = {}
    for pkg in PKG:
        results, errors, pins = _ranks(pkg, avro_path, sweeps=5, working_set=2)
        assert errors == [None, None], errors
        assert pins[0] == pins[1]
        runs[pkg] = (results, pins)
    assert runs["torch"][1][0] == runs["jax"][1][0]
    assert any(runs["torch"][1][0])  # past the warm-up, chunks are pinned
    SG.assert_states_close(runs["torch"][0][0].state, runs["jax"][0][0].state, 1e-8)
    SG.assert_states_equal(runs["torch"][0][0].state, runs["torch"][0][1].state)


def test_rank_kill_mid_sweep_rolls_back_bitwise(avro_path, port_ranks, tmp_path):
    """Rank 1 dies at the sweep-2 commit barrier: both ranks roll back to
    sweep 1's checkpoint, end bitwise equal to the uninterrupted run, and
    rank 0's PeerAbort names rank 1."""
    group = InProcessExchange.create_group(NUM_RANKS, timeout=60.0)
    killer = faultinject.die_at_barrier(group[1], "checkpoint_commit/2", rank=1)
    exchanges = [group[0], killer]
    cks = [TrainingCheckpointer(tmp_path / "ck") for _ in range(NUM_RANKS)]

    class _Journal:
        def __init__(self):
            self.rows = []

        def record(self, kind, **f):
            self.rows.append({"kind": kind, **f})

    journals = [_Journal() for _ in range(NUM_RANKS)]
    coords = [CoordinatedRecovery(exchanges[r], max_restarts=2, checkpointer=cks[r],
                                  journal=journals[r]) for r in range(NUM_RANKS)]
    results, errors, _ = _ranks("torch", avro_path, exchanges=exchanges, checkpointers=cks,
                                coordinators=coords)
    assert errors == [None, None], errors
    assert killer.state["fired"] == 1 and [c.resume_step for c in coords] == [1, 1]
    for r in range(NUM_RANKS):
        SG.assert_states_equal(results[r].state, port_ranks[r].state)
        assert results[r].losses == port_ranks[r].losses
    aborts = [row for row in journals[0].rows if row["kind"] == "peer_abort"]
    assert aborts and aborts[0]["origin_rank"] == 1


def test_restore_under_another_rank_geometry_fails_naming_partition(avro_path, tmp_path):
    ck = TrainingCheckpointer(tmp_path / "ck")
    _, errors, _ = _ranks("torch", avro_path, sweeps=1, checkpointers=[ck, ck])
    assert errors == [None, None], errors
    files = tavro.list_avro_files(avro_path)
    maps, vocabs, keys, indexes, _ = tsr.scan_game_stream(
        files, _cfg("torch"), ("userId",), cluster_by="userId", dtype=np.float64)
    src = tsr.GameAvroChunkSource(files, _cfg("torch"), maps, chunk_records=CHUNK_RECORDS,
                                  random_effect_id_columns=("userId",), entity_vocabs=vocabs,
                                  cluster_by="userId", cluster_keys=keys, indexes=indexes,
                                  dtype=np.float64)
    with pytest.raises(ValueError, match="partition"):
        _program("torch", src, vocabs).train(num_sweeps=2, checkpointer=ck)


@pytest.mark.parametrize("pkg", sorted(PKG))
def test_withheld_importance_allgather_is_attributed(avro_path, pkg):
    """A rank that never joins the DuHL importance allgather surfaces on its
    peer as an ExchangeTimeout naming it."""
    group = PKG[pkg][1].create_group(NUM_RANKS, timeout=3.0)
    killer = faultinject.die_at_barrier(group[1], "duhl_importance", rank=1,
                                        exc_factory=lambda: RuntimeError("withheld"))
    results, errors, _ = _ranks(pkg, avro_path, sweeps=3, working_set=2,
                                exchanges=[group[0], killer])
    timeout_cls = JExchangeTimeout if pkg == "jax" else ExchangeTimeout
    assert isinstance(errors[0], timeout_cls) and list(errors[0].missing_ranks) == [1]
    assert "withheld" in str(errors[1]) and results == [None, None]


def test_two_gloo_ranks_stream_and_recover(avro_path, port_ranks, tmp_path):
    """Two spawned ranks over the group's DistributedKVExchange: the same
    state as the threaded ranks (bitwise), and a kill of rank 1 at the
    sweep-2 commit rolls both back to the same end, bitwise."""
    from tests import torch_mesh_worker as W

    task = dict(kind="streamed_game", path=avro_path,
                configs={"global": dict(feature_bags=("features",))},
                chunk_records=CHUNK_RECORDS, sweeps=SWEEPS, kill=True)
    (tmp_path / "ranks").mkdir()
    out = W.spawn_ranks(NUM_RANKS, [task], tmp_path / "ranks", timeout_s=240)[0]
    for r in range(NUM_RANKS):
        ref = SG.state_np(port_ranks[r].state)
        np.testing.assert_array_equal(out[r]["plain"]["fe"], ref["fe"])
        np.testing.assert_array_equal(out[r]["plain"]["user"], ref["re/userId"])
        killed = out[r]["killed"]
        np.testing.assert_array_equal(killed["fe"], ref["fe"])
        np.testing.assert_array_equal(killed["user"], ref["re/userId"])
        assert killed["losses"] == out[r]["plain"]["losses"] == port_ranks[r].losses
        assert killed["resume_step"] == 1
    assert out[1]["killed"]["fired"] == 1 and out[0]["killed"]["peer_abort_origin"] == 1
