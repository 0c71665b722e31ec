"""The port's span tracing (``photon_ml_torch/telemetry/tracing.py``) against
the JAX package's, on the CPU.

The Chrome-trace export of the same spans, the exchange wait tables and the
straggler report of the same tables equal the JAX package's; the span sites
of the port (the solvers' iterations, the exchanges, the stream) record what
they observe and change nothing; two spawned gloo ranks
(``tests/torch_mesh_worker.py``) merge their wait tables through the
group's exchange, each writes its own trace file, and the GAME drivers over
two ranks write one trace file a rank.
"""

import json
import threading

import numpy as np
import pytest
import torch

from photon_ml_torch.parallel import multihost as tmh
from photon_ml_torch.telemetry import tracing as tt
from photon_ml_tpu.parallel import multihost as jmh
from photon_ml_tpu.telemetry import tracing as jt
from tests import torch_driver_parity as P
from tests import torch_mesh_worker as W

SPANS = [
    ("phase/read", "phase", 0.5, 2.0, None),
    ("exchange/allgather", "exchange", 1.0, 0.25, {"tag": "partitioned_read/train", "rank": 0}),
    ("exchange/allgather", "exchange", 1.5, 0.5, {"tag": "step/3/x", "rank": 1, "seq": 4}),
    ("exchange/barrier", "exchange", 2.0, 0.125, {"tag": "step/4/x", "rank": 1}),
    ("exchange/kv_get", "exchange_io", 2.5, 0.0625, {"key": "k", "rank": 0}),
    ("solver/iteration", "solver", 3.0, 0.03125, {"i": np.int64(2), "error": "ValueError"}),
]


def _tracer(mod, spans=SPANS):
    """A rank-0 tracer of either package holding ``spans`` at fixed times."""
    tracer = mod.Tracer(rank=0)
    tracer._t0_perf = 0.0
    for name, cat, start, dur, attrs in spans:
        tracer.record(name, cat, start, dur, attrs)
    return tracer


def _strip(trace: dict) -> dict:
    out = dict(trace)
    out["otherData"] = {k: v for k, v in trace["otherData"].items() if k != "wall_t0"}
    return out


def test_chrome_trace_equals_the_jax_export():
    """The same spans export to the same Chrome-trace JSON: events, their
    keys and values, thread and process metadata, and the other data but
    the wall-clock anchor."""
    j, t = _tracer(jt).chrome_trace(), _tracer(tt).chrome_trace()
    assert _strip(t) == _strip(j)
    assert json.loads(json.dumps(t)) == t
    assert {e["ph"] for e in t["traceEvents"]} == {"M", "X"}
    assert {e["pid"] for e in t["traceEvents"] if e["ph"] == "X"} == {0, 1}


def test_wait_tables_and_straggler_report_match():
    """exchange_wait_tables pools digit runs of a tag and counts only the
    allgather and barrier waits; straggler_report names the least-waiting
    rank, a rank that never arrived and single-rank tags, as in the JAX
    package."""
    jtab, ttab = jt.exchange_wait_tables(_tracer(jt)), tt.exchange_wait_tables(_tracer(tt))
    assert ttab == jtab
    assert set(ttab[1]) == {"step/*/x"} and ttab[1]["step/*/x"]["count"] == 2
    tables = {
        0: {"a": {"count": 2, "wait_s": 3.0, "max_s": 2.0}, "b": {"count": 1, "wait_s": 1.0,
                                                                    "max_s": 1.0},
            "solo": {"count": 1, "wait_s": 0.5, "max_s": 0.5}},
        1: {"a": {"count": 2, "wait_s": 0.5, "max_s": 0.25}},
        2: {"a": {"count": 2, "wait_s": 1.5, "max_s": 1.0}, "b": {"count": 1, "wait_s": 4.0,
                                                                    "max_s": 4.0}},
    }
    for kw in ({}, {"num_ranks": 3}, {"num_ranks": 4}):
        assert tt.straggler_report(tables, **kw) == jt.straggler_report(tables, **kw)
    report = tt.straggler_report(tables)
    by_tag = {r["tag"]: r for r in report["tags"]}
    assert by_tag["a"]["straggler_rank"] == 1 and by_tag["a"]["reason"] == "least_wait"
    assert by_tag["b"]["straggler_rank"] == 1 and by_tag["b"]["reason"] == "never_arrived"
    assert tt.straggler_report({0: {"solo": {"count": 1, "wait_s": 0.1, "max_s": 0.1}}}) == \
        jt.straggler_report({0: {"solo": {"count": 1, "wait_s": 0.1, "max_s": 0.1}}})
    assert tt.normalize_tag("checkpoint_commit/17/ready") == "checkpoint_commit/*/ready"


def test_span_without_a_tracer_is_the_null_object():
    """With no tracer installed ``span`` returns one shared object; with one
    it records name, category, attributes and an exception's type, and
    uninstall hands the tracer back."""
    assert tt.current_tracer() is None and not tt.tracing_active()
    assert tt.span("a", x=1) is tt.span("b") is tt._NULL_SPAN
    with tt.span("a"):
        pass
    tracer = tt.install_tracer(tt.Tracer(rank=3, capacity=16))
    try:
        with tt.span("ok", cat="c", n=1):
            pass
        with pytest.raises(KeyError), tt.span("bad"):
            raise KeyError("x")
    finally:
        assert tt.uninstall_tracer() is tracer
    assert tt.span("after") is tt._NULL_SPAN
    events = list(tracer.events())
    assert [(e.name, e.cat, e.attrs) for e in events] == [
        ("ok", "c", {"n": 1}), ("bad", "span", {"error": "KeyError"})]
    assert all(e.dur >= 0 and e.thread_name == threading.current_thread().name
               for e in events)


def test_ring_buffers_are_per_thread_and_bounded():
    """Each thread writes its own ring; a full ring keeps the newest spans
    and counts what it dropped, as the JAX package's does."""
    for mod in (jt, tt):
        tracer = mod.Tracer(rank=0, capacity=16)
        for i in range(20):
            tracer.record("main", "c", float(i), 0.0, {"i": i})

        def worker(tracer=tracer):
            for i in range(3):
                tracer.record("side", "c", float(i), 0.0, None)

        th = threading.Thread(target=worker, name="side-thread")
        th.start()
        th.join()
        assert tracer.dropped_events() == 4
        main = [e.attrs["i"] for e in tracer.events() if e.name == "main"]
        assert main == list(range(4, 20))
        names = {e["args"]["name"] for e in tracer.chrome_trace()["traceEvents"]
                 if e["name"] == "thread_name"}
        assert "side-thread" in names


def test_publish_and_best_effort_flush(tmp_path):
    """publish_trace writes trace-00000.json atomically; finalize_trace on
    one process reports from the local tables; flush_trace_best_effort
    journals the report and never raises, even into an unwritable path."""
    rows = []

    class Journal:
        def record(self, kind, **fields):
            rows.append((kind, fields))

    tracer = _tracer(tt)
    path = tt.publish_trace(tracer, tmp_path / "tr")
    assert path.endswith("trace-00000.json")
    assert json.loads(open(path).read())["otherData"]["rank"] == 0
    report = tt.flush_trace_best_effort(tracer, tmp_path / "tr2", journal=Journal())
    assert report == jt.straggler_report(jt.exchange_wait_tables(_tracer(jt))) | \
        {"dropped_events": [0]}
    assert rows == [("straggler_report", report)]
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert tt.flush_trace_best_effort(tracer, blocker / "sub") is None


def test_exchange_spans_match_the_jax_package():
    """Two virtual ranks on threads over each package's InProcessExchange,
    one shared tracer: the same allgather spans (tag, rank) and the same
    wait-table tags and counts; the single-process exchange traces zero-wait
    spans in both packages."""
    def run(mod, tracing):
        tracer = tracing.install_tracer(tracing.Tracer(rank=0))
        try:
            group = mod.InProcessExchange.create_group(2)

            def rank_main(ex):
                ex.allgather("read/train", ex.rank)
                ex.barrier("sweep/1")
                ex.allgather("sweep/2/x", [ex.rank])

            threads = [threading.Thread(target=rank_main, args=(ex,)) for ex in group]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            single = mod.SingleProcessExchange()
            single.allgather("solo", 1)
            single.barrier("solo")
        finally:
            tracing.uninstall_tracer()
        spans = sorted((e.name, e.cat, (e.attrs or {}).get("tag"), (e.attrs or {}).get("rank"))
                       for e in tracer.events())
        tables = tracing.exchange_wait_tables(tracer)
        return spans, {r: {k: v["count"] for k, v in t.items()} for r, t in tables.items()}

    assert run(tmh, tt) == run(jmh, jt)


def test_solver_iterations_are_spans_and_change_nothing():
    """An L-BFGS solve records one solver/iteration span an iteration; the
    solve with a tracer is bitwise the solve without one."""
    from photon_ml_torch.estimators import train_glm
    from photon_ml_torch.types import TaskType
    from tests.torch_parity import batches, make_data

    x, y, offsets, weights = make_data(0, 200, 5, True)
    _, tb = batches(x, y, offsets, weights)
    plain = train_glm(tb, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,))
    tracer = tt.install_tracer(tt.Tracer())
    seen = []
    try:
        traced = train_glm(tb, TaskType.LOGISTIC_REGRESSION, regularization_weights=(1.0,),
                           on_solve=lambda lam, r: seen.append(r.iterations))
    finally:
        tt.uninstall_tracer()
    assert torch.equal(traced[1.0].coefficients.means, plain[1.0].coefficients.means)
    iters = [e.attrs["i"] for e in tracer.events() if e.name == "solver/iteration"]
    assert iters == list(range(seen[0]))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two spawned gloo ranks: traced exchanges with rank 1 late at one
    barrier, then the partitioned GAME training and scoring drivers with
    --trace-dir and --telemetry-dir."""
    base = tmp_path_factory.mktemp("traced")
    music = base / "music"
    music.mkdir()
    P.write_music(music)
    extra = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]
    train = P.training_args(music, base / "train", extra, validation=False) + [
        "--distributed", "--partitioned-io", "--trace-dir", str(base / "train-tr"),
        "--telemetry-dir", str(base / "train-tel")]
    score = ["--input-data-path", str(music / "test"), "--model-input-dir",
             str(base / "train" / "best"), "--output-dir", str(base / "score"),
             "--distributed", "--partitioned-io", "--trace-dir", str(base / "score-tr"),
             "--telemetry-dir", str(base / "score-tel")]
    tasks = [dict(kind="traced_exchanges", dir=str(base / "exchanges"), late_s=0.5),
             dict(kind="driver_runs", runs=[("train", train), ("score", score)])]
    spawn_dir = base / "spawn"
    spawn_dir.mkdir()
    return base, W.spawn_ranks(2, tasks, spawn_dir)


def test_gather_straggler_report_over_two_ranks(two_ranks):
    """Both ranks compute the same merged report; rank 1, late at the
    barrier, is its straggler; each rank wrote its own trace file."""
    _, (exchanges, _) = two_ranks
    r0, r1 = exchanges
    assert r0["report"] == r1["report"]
    assert r0["files"] == r1["files"] == ["trace-00000.json", "trace-00001.json"]
    by_tag = {r["tag"]: r for r in r0["report"]["tags"]}
    assert {"early", "late", "step/*/sum", "trace/output_dir"} <= set(by_tag)
    assert by_tag["late"]["straggler_rank"] == 1 and by_tag["late"]["reason"] == "least_wait"
    assert by_tag["late"]["wait_s"][0] >= 0.4
    assert by_tag["step/*/sum"]["count"] == [2, 2]
    assert r0["report"]["num_ranks"] == 2 and r0["report"]["dropped_events"] == [0, 0]
    assert {"exchange/allgather", "exchange/barrier", "exchange/kv_get",
            "exchange/kv_set"} <= set(r0["spans"])


def test_partitioned_drivers_write_a_trace_a_rank(two_ranks):
    """The partitioned GAME drivers over two ranks: every rank writes its
    trace file, rank 0 journals the straggler report merged over both ranks
    (every exchange tag of the run named), and only rank 0 writes the
    journal."""
    from photon_ml_torch.telemetry import read_journal

    base, (_, drivers) = two_ranks
    assert all("summary" in run for rank in drivers for run in rank), drivers[0]
    for which in ("train", "score"):
        files = sorted(p.name for p in (base / f"{which}-tr").iterdir())
        assert files == ["trace-00000.json", "trace-00001.json"]
        traced = [json.loads((base / f"{which}-tr" / f).read_text()) for f in files]
        assert [t["otherData"]["rank"] for t in traced] == [0, 1]
        rows = read_journal(base / f"{which}-tel" / "run-journal.jsonl")
        report = [r for r in rows if r["kind"] == "straggler_report"]
        assert len(report) == 1 and report[0]["num_ranks"] == 2 and "partial" not in report[0]
        tags = {r["tag"] for r in report[0]["tags"]}
        waits = {tt.normalize_tag(e["args"]["tag"]) for t in traced for e in t["traceEvents"]
                 if e.get("name") in ("exchange/allgather", "exchange/barrier")}
        assert tags == waits and any(t.startswith("partitioned_read/") for t in tags)
        assert not (base / f"{which}-tel" / ".worker-1").exists()
