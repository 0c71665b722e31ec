"""Coordinated multi-rank recovery (``resilience/coordinated.py``) and the
exchanges' generation fencing and abort markers (``parallel/multihost.py``),
case for case against ``tests/test_coordinated.py``'s
``TestGenerationFencing`` and ``TestPeerAbort``: each in-process case runs
on the JAX package's ``InProcessExchange`` and on the port's, and both must
end alike; the key-value cases run the port's ``DistributedKVExchange`` over
a ``HashStore`` (the JAX package's runs over its coordination-service
client). Then ``run_with_recovery(coordinator=)``: the shared budget, the
attribution and the rendezvous timeout on virtual ranks (threads), and the
fused program's ``train_partitioned`` on two gloo ranks, killed at a commit
barrier and inside a sweep's all-gather."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from dev import faultinject
from photon_ml_tpu.parallel.multihost import InProcessExchange as JInProcess
from photon_ml_tpu.resilience import ExchangeTimeout as JExchangeTimeout
from photon_ml_tpu.resilience import PeerAbort as JPeerAbort
from photon_ml_torch import resilience as tres
from photon_ml_torch.parallel import multihost
from photon_ml_torch.parallel.multihost import DistributedKVExchange, InProcessExchange
from photon_ml_torch.resilience import (
    CoordinatedRecovery,
    ExchangeTimeout,
    PeerAbort,
    Transience,
    classify_exception,
    recovery,
    run_with_recovery,
)

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

NUM_RANKS = 2

#: (InProcessExchange, ExchangeTimeout, PeerAbort) of each package
PACKAGES = {"jax": (JInProcess, JExchangeTimeout, JPeerAbort),
            "torch": (InProcessExchange, ExchangeTimeout, PeerAbort)}


def _join_all(threads, timeout=90.0):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a coordinated path hung"


def _swallow(fn, *args):
    try:
        fn(*args)
    except (ExchangeTimeout, JExchangeTimeout):
        pass


# ---------------------------------------------------------------------------
# generation fencing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_stale_generation_key_never_satisfies_newer_get(pkg):
    """Rank 0 publishes in generation 0 (its peer never arrives), both
    ranks move to generation 1, and the same tag resolves only generation-1
    payloads."""
    cls, timeout_cls, _ = PACKAGES[pkg]
    group = cls.create_group(NUM_RANKS, timeout=0.3)
    for ex in group:
        ex.set_generation(0)
    box = {}

    def dead_attempt():
        try:
            group[0].allgather("layout", {"v": "stale"})
        except Exception as e:  # asserted below
            box["e"] = e

    t = threading.Thread(target=dead_attempt, daemon=True)
    t.start()
    t.join(5.0)
    assert isinstance(box["e"], timeout_cls)
    for ex in group:
        ex.set_generation(1)
    results = [None] * NUM_RANKS

    def fresh(r):
        results[r] = group[r].allgather("layout", {"v": f"fresh{r}"})

    _join_all([threading.Thread(target=fresh, args=(r,), daemon=True)
               for r in range(NUM_RANKS)], timeout=5.0)
    assert results[0] == results[1] == [{"v": "fresh0"}, {"v": "fresh1"}]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_desynced_sequences_resync_at_generation_bump(pkg):
    cls, _, _ = PACKAGES[pkg]
    group = cls.create_group(NUM_RANKS, timeout=0.3)
    t = threading.Thread(target=lambda: _swallow(group[0].allgather, "ahead", 1), daemon=True)
    t.start()
    t.join(5.0)
    assert group[0]._seq != group[1]._seq
    for ex in group:
        ex.set_generation(1)
    results = [None] * NUM_RANKS

    def go(r):
        results[r] = group[r].allgather("resynced", r)

    _join_all([threading.Thread(target=go, args=(r,), daemon=True)
               for r in range(NUM_RANKS)], timeout=5.0)
    assert results[0] == results[1] == [0, 1]


def _kv_group(num_ranks=NUM_RANKS, timeout=5.0):
    store = dist.HashStore()
    return store, [DistributedKVExchange(timeout, store=store, rank=r, num_ranks=num_ranks)
                   for r in range(num_ranks)]


def test_kv_exchange_generation_prefixes_keys_and_resets_seq():
    """Fenced keys carry the (session nonce, generation) namespace, the
    sequence restarts at the bump, and a second fencing session in the same
    process draws a fresh nonce."""
    store, (ex,) = _kv_group(1, timeout=0.3)
    writes = []
    ex.set_generation(0)
    ex._store = _Counting(ex._store, writes)
    ns0 = ex._namespace()
    assert ex.allgather("meta", {"x": 1}) == [{"x": 1}]
    assert f"{ns0}/0/meta/0" in [k for op, k in writes if op == "set"]
    ex.set_generation(1)
    ns1 = ex._namespace()
    assert ns1.endswith("g1") and ns1.startswith(ns0[:ns0.index("g")])
    assert ex.allgather("meta", {"x": 2}) == [{"x": 2}]
    assert f"{ns1}/0/meta/0" in [k for op, k in writes if op == "set"]
    ex.set_generation(0)
    assert ex._namespace() != ns0 and ex._namespace().endswith("g0")


def test_kv_fenced_wait_surfaces_peer_abort_between_slices():
    store, (ex0, ex1) = _kv_group(timeout=5.0)
    ex0.ABORT_POLL_MS = 20
    for ex in (ex0, ex1):
        ex.set_generation(0)
    ex1.post_abort({"rank": 1, "cause": "RuntimeError('worker preempted')"})
    t0 = time.perf_counter()
    with pytest.raises(PeerAbort) as ei:
        ex0.allgather("meta", {"x": 1})
    assert time.perf_counter() - t0 < 2.0
    assert ei.value.origin_rank == 1 and "preempted" in ei.value.cause


class _Counting:
    """A store proxy that records each operation (name, first key)."""

    def __init__(self, inner, log):
        self._inner, self._log = inner, log

    def __getattr__(self, name):
        fn = getattr(self._inner, name)

        def call(*args, **kwargs):
            key = args[0] if args else None
            self._log.append((name, key[0] if isinstance(key, list) else key))
            return fn(*args, **kwargs)

        return call


def test_healthy_fenced_run_makes_the_unfenced_store_operations():
    """A healthy exchange performs the same store operations fenced as
    unfenced: the abort marker is read only when a wait's slice expires.
    (Unfenced keys take the process-global sequence, so one process holds
    one rank of it here; ``test_partitioned_training_recovers_over_two_gloo_
    ranks`` runs the fenced exchange over two processes.)"""
    counts = {}
    for mode in ("unfenced", "fenced"):
        _, (ex,) = _kv_group(1)
        if mode == "fenced":
            ex.set_generation(0)
        log: list = []
        ex._store = _Counting(ex._store, log)
        ex._aborts = _Counting(ex._aborts, log)
        assert ex.allgather("a", 0) == [0] and ex.allgather("b", {"r": 0}) == [{"r": 0}]
        ex.barrier("c")
        counts[mode] = [op for op, _ in log]
    assert counts["fenced"] == counts["unfenced"]
    assert counts["fenced"].count("set") == 3 and "check" not in counts["fenced"]


# ---------------------------------------------------------------------------
# peer aborts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_abort_wakes_waiter_fast_and_names_culprit(pkg):
    cls, _, abort_cls = PACKAGES[pkg]
    group = cls.create_group(NUM_RANKS, timeout=5.0)
    for ex in group:
        ex.set_generation(0)
    box = {}

    def waiter():
        t0 = time.perf_counter()
        try:
            group[0].allgather("sweep", 1)
        except Exception as e:  # asserted below
            box["e"], box["dt"] = e, time.perf_counter() - t0

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    group[1].post_abort({"rank": 1, "cause": "RuntimeError('pool preempted worker 1')"})
    t.join(5.0)
    assert not t.is_alive()
    assert isinstance(box["e"], abort_cls)
    assert box["e"].origin_rank == 1 and "preempted" in box["e"].cause
    assert box["dt"] < 2.0
    if pkg == "torch":
        # attributed coordination failures stay fatal without a coordinator
        assert classify_exception(box["e"]) is Transience.FATAL


@pytest.mark.parametrize("transport", ["jax", "torch", "torch-kv"])
def test_corrupt_abort_marker_still_bounded_and_typed(transport):
    """A garbled marker ends the wait typed (PeerAbort, unattributed)."""
    if transport == "torch-kv":
        _, group = _kv_group(timeout=5.0)
        group[0].ABORT_POLL_MS = 20
        abort_cls = PeerAbort
    else:
        cls, _, abort_cls = PACKAGES[transport]
        group = cls.create_group(NUM_RANKS, timeout=5.0)
    for ex in group:
        ex.set_generation(0)
    box = {}

    def waiter():
        try:
            group[0].allgather("sweep", 1)
        except Exception as e:  # asserted below
            box["e"] = e

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    with faultinject.abort_marker_corruptor(group[1]) as state:
        group[1].post_abort({"rank": 1, "cause": "real cause"})
    t.join(5.0)
    assert not t.is_alive()
    assert state["posted"] == 1
    assert isinstance(box["e"], abort_cls)
    assert box["e"].origin_rank is None
    assert "unparseable" in box["e"].cause and "unattributed" in str(box["e"])


@pytest.mark.parametrize("transport", ["jax", "torch", "torch-kv"])
def test_own_marker_never_aborts_self(transport):
    if transport == "torch-kv":
        _, group = _kv_group(1, timeout=0.5)
    else:
        group = PACKAGES[transport][0].create_group(1, timeout=0.5)
    group[0].set_generation(0)
    group[0].post_abort({"rank": 0, "cause": "mine"})
    assert group[0].allgather("t", "x") == ["x"]


@pytest.mark.parametrize("transport", ["torch", "torch-kv"])
def test_first_abort_writer_wins(transport):
    """The first marker of a generation names the culprit; a second rank
    failing in the same window does not replace it."""
    group = (_kv_group(3)[1] if transport == "torch-kv"
             else InProcessExchange.create_group(3, timeout=1.0))
    for ex in group:
        ex.set_generation(0)
    group[1].post_abort({"rank": 1, "cause": "first"})
    group[2].post_abort({"rank": 2, "cause": "second"})
    assert group[0].pending_abort()["cause"] == "first"
    # a new generation starts clean
    for ex in group:
        ex.set_generation(1)
    assert group[0].pending_abort() is None


# ---------------------------------------------------------------------------
# run_with_recovery(coordinator=) on virtual ranks
# ---------------------------------------------------------------------------


class _StepCheckpointer:
    """The two methods the coordinator and the recovery loop read, over a
    shared list of committed steps."""

    def __init__(self, steps):
        self._steps = steps

    def newest_loadable_step(self):
        return self._steps[-1] if self._steps else None

    def latest_step(self):
        return self.newest_loadable_step()


class _Journal:
    def __init__(self):
        self.rows = []

    def record(self, kind, **fields):
        self.rows.append({"kind": kind, **fields})


def _rank_runs(exchanges, attempt_of, *, max_restarts=2, steps=None, timeout=60.0):
    """Every rank runs ``attempt_of(rank)`` under run_with_recovery with a
    coordinator over its exchange; returns (results, errors, coordinators,
    journals)."""
    steps = [] if steps is None else steps
    journals = [_Journal() for _ in exchanges]
    coords = [CoordinatedRecovery(ex, max_restarts=max_restarts,
                                  checkpointer=_StepCheckpointer(steps), journal=j)
              for ex, j in zip(exchanges, journals)]
    results, errors = [None] * len(exchanges), [None] * len(exchanges)

    def work(r):
        try:
            results[r] = run_with_recovery(attempt_of(r, coords[r]),
                                           checkpointer=coords[r].checkpointer,
                                           journal=journals[r], coordinator=coords[r],
                                           description=f"rank {r}")
        except Exception as e:  # asserted by the caller
            errors[r] = e

    _join_all([threading.Thread(target=work, args=(r,), daemon=True)
               for r in range(len(exchanges))], timeout=timeout)
    return results, errors, coords, journals


def _sweeping_attempt(exchanges, steps, sweeps=3):
    """An attempt that commits ``sweeps`` barrier-committed steps from the
    published resume step and returns the steps it ran."""
    def attempt_of(r, coord):
        def attempt(restart):
            ran = []
            for sweep in range(coord.resume_step or 0, sweeps):
                ex = exchanges[r]
                ex.barrier(f"checkpoint_commit/{sweep + 1}/ready")
                if r == 0 and (not steps or steps[-1] < sweep + 1):
                    steps.append(sweep + 1)
                ex.barrier(f"checkpoint_commit/{sweep + 1}/published")
                ran.append(sweep + 1)
            return ran
        return attempt
    return attempt_of


def test_rank_killed_at_a_commit_rolls_every_rank_back_attributed():
    """Rank 1 dies at the sweep-2 commit: both ranks roll back to step 1
    (the last step both committed), finish, and name rank 1."""
    recovery.reset_counts()
    group = InProcessExchange.create_group(NUM_RANKS, timeout=5.0)
    killer = faultinject.die_at_barrier(group[1], "checkpoint_commit/2/ready", rank=1)
    exchanges = [group[0], killer]
    steps: list = []
    results, errors, coords, journals = _rank_runs(
        exchanges, _sweeping_attempt(exchanges, steps), steps=steps)
    assert errors == [None, None], errors
    assert killer.state["fired"] == 1
    assert results[0] == results[1] == [2, 3]
    assert [c.resume_step for c in coords] == [1, 1]
    assert all(c.generation == 1 for c in coords)
    for j in journals:
        restarts = [row for row in j.rows if row["kind"] == "coordinated_restart"]
        assert restarts and restarts[0]["origin_rank"] == 1 and restarts[0]["step"] == 1
    aborts0 = [row for row in journals[0].rows if row["kind"] == "peer_abort"]
    assert aborts0 and aborts0[0]["origin_rank"] == 1
    assert recovery.counts["coordinated_restarts"] == 2 and recovery.counts["peer_aborts"] == 1


def test_flapping_rank_exhausts_the_job_budget_on_every_rank():
    """A rank that dies every attempt spends the job's shared budget; every
    rank gives up naming it."""
    group = InProcessExchange.create_group(NUM_RANKS, timeout=5.0)
    killer = faultinject.die_at_barrier(group[1], "checkpoint_commit/1/ready", rank=1,
                                        times=None)
    exchanges = [group[0], killer]
    steps: list = []
    _, errors, coords, journals = _rank_runs(exchanges, _sweeping_attempt(exchanges, steps),
                                             max_restarts=1, steps=steps)
    assert all(e is not None for e in errors)
    assert killer.state["fired"] == 2  # the first attempt and the one restart
    for j in journals:
        failure = [row for row in j.rows if row["kind"] == "run_failure"][-1]
        assert failure["origin_rank"] == 1 and failure["restarts_used"] == 2


def test_rendezvous_timeout_gives_up_attributed():
    """A rank that is gone (it never reaches the restart rendezvous) ends the
    job with the rendezvous' ExchangeTimeout naming it."""
    group = InProcessExchange.create_group(NUM_RANKS, timeout=0.5)
    journal = _Journal()
    coord = CoordinatedRecovery(group[0], max_restarts=2, journal=journal)
    CoordinatedRecovery(group[1], max_restarts=2)

    def attempt(restart):
        group[0].allgather("sweep", 0)  # rank 1 never arrives

    with pytest.raises(ExchangeTimeout) as ei:
        run_with_recovery(attempt, coordinator=coord, journal=journal)
    assert list(ei.value.missing_ranks) == [1]
    failure = [row for row in journal.rows if row["kind"] == "run_failure"][-1]
    assert "original_error" in failure


def test_a_fatal_error_is_never_retried_on_any_rank():
    """A sticky CUDA error classifies fatal: its rank gives up at once and
    posts no marker; its peer then times out and gives up too (the
    rendezvous is never reached), so no rank retries."""
    recovery.reset_counts()
    group = InProcessExchange.create_group(NUM_RANKS, timeout=0.5)
    calls = [0, 0]

    def attempt_of(r, coord):
        def attempt(restart):
            calls[r] += 1
            if r == 1:
                raise RuntimeError("CUDA error: an illegal memory access was encountered")
            group[0].allgather("sweep", 0)
        return attempt

    _, errors, _, _ = _rank_runs(group, attempt_of)
    assert "illegal memory access" in str(errors[1])
    assert isinstance(errors[0], ExchangeTimeout)
    assert calls == [1, 1] and recovery.counts["retries"] == 0


def test_detached_recovery_keeps_coordination_failures_fatal():
    calls = []

    def attempt(restart):
        calls.append(restart)
        raise PeerAbort("t", origin_rank=1, cause="x")

    with pytest.raises(PeerAbort):
        tres.run_with_recovery(attempt, max_restarts=3)
    assert calls == [0]


def test_data_axis_exchange_fences_through_its_base():
    """A DataAxisExchange fences its base; its markers carry the base's
    process rank and read back as data ranks (two model ranks a data row)."""
    group = InProcessExchange.create_group(4, timeout=1.0)
    views = []
    for r, ex in enumerate(group):
        view = multihost.DataAxisExchange.__new__(multihost.DataAxisExchange)
        view.base, view.rank, view.num_ranks, view._stride = ex, r // 2, 2, 2
        views.append(view)
    for v in views:
        v.set_generation(0)
    assert all(v.generation == 0 and v.base.generation == 0 for v in views)
    views[2].post_abort({"rank": 1, "cause": "data row 1"})
    assert views[0].pending_abort()["rank"] == 1
    assert group[0].pending_abort()["rank"] == 2
    assert views[2].pending_abort() is None


# ---------------------------------------------------------------------------
# the fused program over two gloo ranks
# ---------------------------------------------------------------------------


def _assert_trees_equal(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_trees_equal(got[k], ref[k])
    else:
        np.testing.assert_array_equal(got, ref)


def _partitioned_recovery_task(tmp_path, fault):
    from tests import torch_partitioned_parity as PP

    path = PP.write_input(tmp_path / "data", num_files=2, rows_per_file=40)
    return dict(kind="partitioned_recovery", path=str(path), configs=PP.CONFIGS["dense"],
                re_columns=["userId"], program=PP.program(), sweeps=3, fault=fault)


@pytest.mark.parametrize("fault", ["commit", "all_gather"])
def test_partitioned_training_recovers_over_two_gloo_ranks(tmp_path, fault):
    """``train_partitioned`` under ``run_with_recovery(coordinator=)`` on two
    gloo ranks. A kill of rank 1 at the sweep-2 commit barrier is caught at
    the exchange: both ranks roll back to step 1, name rank 1 in their
    PeerAbort (rank 0) or restart (both), and end bitwise equal to the
    uninterrupted run. A kill inside the sweep's all-gather leaves rank 0
    blocked in a gloo collective, which no marker can wake: it ends at the
    group's collective timeout, the restart tears the group down and joins a
    new one on a fresh store prefix, and both ranks again end bitwise equal
    to the uninterrupted run."""
    from tests import torch_mesh_worker as W

    task = _partitioned_recovery_task(tmp_path, fault)
    (tmp_path / "ranks").mkdir()
    out = W.spawn_ranks(2, [task], tmp_path / "ranks", timeout_s=240, group_timeout_s=10)[0]
    for r in range(2):
        assert out[r]["fired"] == (1 if r == 1 else 0)
        np.testing.assert_array_equal(out[r]["losses"], out[r]["reference"]["losses"])
        _assert_trees_equal(out[r]["state"], out[r]["reference"]["state"])
        assert out[r]["resume_step"] == 1 and out[r]["generation"] == 1
        assert out[r]["origin_rank"] == 1
    # the survivor resumes after the fault: at once from a commit barrier,
    # after the group's 10 s collective timeout from inside an all-gather
    waited = out[0]["t_resumed"] - out[1]["t_fault"]
    assert (waited < 10.0) if fault == "commit" else (waited >= 9.0)
    if fault == "commit":
        assert out[0]["peer_abort_origin"] == 1
