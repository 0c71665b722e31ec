"""The port's run telemetry (``photon_ml_torch/telemetry``, ``util/timed.py``,
``util/events.py``) against the JAX package's, on the CPU.

The registry and the phase histograms, the run journal (round trip,
atomic publish, idempotent close, rank gating, heartbeats), ``json_safe``,
the event emitter, and the solver telemetry of every estimator that takes a
``telemetry=``: ``train_glm`` (f64, equal iterations and reasons, values at
rel 1e-8), ``train_glm_grid`` and the tournaments (lane rows and summaries),
``train_glm_streaming``, ``GameEstimator.fit`` and ``refresh``, and the
model search's journal rows.
"""

import dataclasses
import enum
import importlib
import json
import math
import os

import numpy as np
import pytest
import torch

from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm import lane_search as tls
from photon_ml_torch.algorithm import refresh as trefresh
from photon_ml_torch.algorithm.coordinate_descent import run_coordinate_descent
from photon_ml_torch.hyperparameter import search_driver as tsd
from photon_ml_torch.io.stream_reader import ArrayChunkSource
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOpt
from photon_ml_torch.optim.optimizer import OptimizerType as TType
from photon_ml_torch.resilience import recovery
from photon_ml_torch.telemetry import io_counters as tio
from photon_ml_torch.telemetry import journal as tj
from photon_ml_torch.telemetry import layout as tlayout
from photon_ml_torch.telemetry import registry as treg
from photon_ml_torch.telemetry import resilience_counters as tres
from photon_ml_torch.telemetry import solver_trace as tst
from photon_ml_torch.telemetry import stream_counters as tstream
from photon_ml_torch.types import TaskType as TTask
from photon_ml_torch.util import events as tev
from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import lane_search as jls
from photon_ml_tpu.hyperparameter import search_driver as jsd
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
from photon_ml_tpu.optim.optimizer import OptimizerType as JType
from photon_ml_tpu.telemetry import journal as jj
from photon_ml_tpu.telemetry import registry as jreg
from photon_ml_tpu.telemetry import solver_trace as jst
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_tpu.util import events as jev
from tests.torch_game_parity import datasets, estimator_pair, game_arrays, model_to_plain
from tests.torch_parity import batches, make_data, normalizations

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

# the util namespaces re-export the decorator ``timed`` under the module's name
ttimed = importlib.import_module("photon_ml_torch.util.timed")
jtimed = importlib.import_module("photon_ml_tpu.util.timed")

LAMBDAS = (0.1, 1.0, 10.0)


class ListJournal:
    """A journal that keeps its rows in memory (kind plus fields)."""

    active = True

    def __init__(self):
        self.rows = []

    def record(self, kind, **fields):
        self.rows.append(dict(kind=kind, **fields))

    def heartbeat(self, *, registry=None, **cursor):
        self.rows.append(dict(kind="heartbeat", **cursor))


def _pairs(jrows, trows):
    assert [r["kind"] for r in trows] == [r["kind"] for r in jrows]
    for j, t in zip(jrows, trows):
        assert set(t) == set(j), (j["kind"], set(t) ^ set(j))
    return zip(jrows, trows)


def _same_row(j: dict, t: dict, rtol: float) -> None:
    """Strings, ints and bools equal; floats and float lists at ``rtol``."""
    for k, v in j.items():
        w = t[k]
        if isinstance(v, dict):
            _same_row(v, w, rtol)
        elif isinstance(v, float) or (isinstance(v, list) and v and isinstance(v[0], float)):
            np.testing.assert_allclose(np.asarray(w, np.float64), np.asarray(v, np.float64),
                                       rtol=rtol, atol=rtol * 1e-3, err_msg=k)
        else:
            assert w == v, (k, w, v)


# -- registry, phase timings, events ------------------------------------------


def test_histograms_and_timing_summary_match():
    """The same observations give the same summary in both registries; the
    phase timings land in the registry's timing/ histograms in both
    packages, counted per block."""
    values = [0.5, 0.25, 3.0, 1.5, 0.125, 7.0, 2.0]
    jh, th = jreg.MetricsRegistry().histogram("h"), treg.MetricsRegistry().histogram("h")
    jh.observe_many(values)
    th.observe_many(values)
    assert th.summary() == jh.summary()
    jtimed.reset_timings()
    ttimed.reset_timings()
    for name, k in (("read", 2), ("train", 3)):
        for _ in range(k):
            with jtimed.Timed(name):
                pass
            with ttimed.Timed(name, sync=lambda: None):
                pass
    js, ts = jtimed.timing_summary(), ttimed.timing_summary()
    assert set(ts) == set(js) == {"read", "train"}
    for name in js:
        assert set(ts[name]) == set(js[name]) and ts[name]["count"] == js[name]["count"]
    assert set(treg.default_registry().histograms("timing/")) == {"timing/read", "timing/train"}

    @ttimed.timed("decorated")
    def f(x):
        return 2 * x

    assert f(3) == 6 and ttimed.timing_summary()["decorated"]["count"] == 1
    ttimed.reset_timings()
    assert ttimed.timing_summary() == {}


def test_event_emitter_order_and_unregister():
    """Listeners run in registration order; unregistering is idempotent; a
    failing listener is logged and the rest still run, as in the JAX
    package; the events carry the JAX package's fields."""
    for ev in (jev, tev):
        seen = []
        em = ev.EventEmitter()
        assert not em.has_listeners

        def first(e, seen=seen):
            seen.append(("first", type(e).__name__))

        def boom(e):
            raise RuntimeError("listener failure")

        def last(e, seen=seen):
            seen.append(("last", getattr(e, "job_name", None)))

        for listener in (first, boom, last):
            em.register(listener)
        em.send(ev.TrainingStartEvent(job_name="j"))
        em.unregister(boom)
        em.unregister(boom)
        em.send(ev.TrainingFinishEvent(job_name="k", succeeded=False))
        em.unregister(first)
        em.unregister(last)
        assert not em.has_listeners
        assert seen == [("first", "TrainingStartEvent"), ("last", "j"),
                        ("first", "TrainingFinishEvent"), ("last", "k")]
    for name in ("Event", "SetupEvent", "TrainingStartEvent", "TrainingFinishEvent",
                 "OptimizationLogEvent"):
        jf = [f.name for f in dataclasses.fields(getattr(jev, name))]
        assert [f.name for f in dataclasses.fields(getattr(tev, name))] == jf


# -- json_safe and the journal --------------------------------------------------


class Color(enum.Enum):
    RED = 1


@dataclasses.dataclass
class Point:
    x: float
    tags: tuple


CASES = {
    "scalars": [1, 2.5, "s", True, None, float("nan"), float("inf")],
    "enum": {"c": Color.RED, 3: Color.RED},
    "dataclass": Point(x=1.5, tags=("a", 2)),
    "numpy": {"i": np.int32(4), "f": np.float64(0.25), "b": np.bool_(True),
              "a": np.arange(4.0).reshape(2, 2), "nan": np.array([1.0, np.nan])},
    "nested": {"set": {3}, "list": [np.float32(0.5), {"e": Color.RED}],
               "tuple": (np.int64(7), None)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_json_safe_matches(case):
    """Enums, dataclasses, numpy scalars and arrays, NaN/Inf: the port's
    values are the JAX package's."""
    assert tj.json_safe(CASES[case]) == jj.json_safe(CASES[case])


def test_json_safe_reads_torch_tensors():
    """A 0-d tensor is its scalar and a small tensor its list, as numpy's."""
    for t in (torch.tensor(3.5), torch.tensor(2, dtype=torch.int32), torch.arange(3.0),
              torch.tensor([[1.0, float("inf")]], dtype=torch.float64)):
        assert tj.json_safe(t) == jj.json_safe(t.numpy())


@pytest.mark.parametrize("durable", [True, False])
def test_journal_round_trip_and_atomic_publish(tmp_path, durable):
    """Rows stamp kind, seq, ts and elapsed_ms; the durable stage is
    readable while the journal is open and gone after the publish; close is
    idempotent; the rows read back equal in both packages' readers."""
    j = tj.RunJournal(tmp_path, rank=0, durable=durable)
    j.record("config", task=TTask.LOGISTIC_REGRESSION, n=np.int64(3), x=float("nan"))
    j.record_gauge("g", torch.tensor(1.5))
    j.record_timings({"read": {"count": 1, "total": 0.5}})
    assert os.path.exists(j.partial_path) == durable and not os.path.exists(j.path)
    if durable:
        live = tj.read_journal(j.partial_path)
        assert [r["kind"] for r in live] == ["journal_open", "config", "gauge", "phase_timing"]
    j.close()
    j.close()
    j.record("late", x=1)  # a closed journal writes nothing
    assert os.path.exists(j.path) and not os.path.exists(j.partial_path)
    rows = tj.read_journal(j.path)
    assert rows == jj.read_journal(j.path) == tj.RunJournal.read(j.path)
    assert [r["kind"] for r in rows] == ["journal_open", "config", "gauge", "phase_timing",
                                         "journal_close"]
    assert [r["seq"] for r in rows] == list(range(5))
    assert rows[1]["task"] == "LOGISTIC_REGRESSION" and rows[1]["x"] is None
    assert rows[2]["value"] == 1.5 and rows[-1]["records"] == 4
    assert all({"ts", "elapsed_ms"} <= set(r) for r in rows)
    # a torn last line (a killed run) is skipped only when tolerant
    with open(j.path, "a") as f:
        f.write('{"kind": "cut')
    with pytest.raises(json.JSONDecodeError):
        tj.read_journal(j.path)
    assert tj.read_journal(j.path, tolerant=True) == rows


def test_journal_rank_gating_and_heartbeats(tmp_path):
    """A journal of rank > 0 or without a directory writes nothing; a
    heartbeat carries the cursor, the registry's counter deltas and gauges
    (and no device memory on a CPU run)."""
    for inert in (tj.RunJournal(tmp_path / "r1", rank=1), tj.RunJournal(None)):
        assert not inert.active
        inert.record("x", a=1)
        inert.heartbeat(stage="s")
        inert.close()
    assert not (tmp_path / "r1").exists()
    reg = treg.MetricsRegistry()
    j = tj.RunJournal(tmp_path, rank=0)
    reg.counter("c").inc(2)
    reg.gauge("g").set(4)
    j.heartbeat(registry=reg, stage="train", sweep=1)
    reg.counter("c").inc(3)
    j.heartbeat(registry=reg, stage="train", sweep=2)
    j.heartbeat(registry=reg, stage="train", sweep=3)
    j.close()
    beats = [r for r in tj.read_journal(j.path) if r["kind"] == "heartbeat"]
    assert [b.get("counter_deltas") for b in beats] == [{"c": 2}, {"c": 3}, None]
    assert all(b["gauges"] == {"g": 4.0} and "hbm_bytes" not in b for b in beats)
    assert tj.heartbeat_cursor(beats[0]) == {"stage": "train", "sweep": 1}


def test_counters_feed_the_registry(tmp_path):
    """The I/O, stream, layout and resilience counters land under the JAX
    package's names; resilience.recovery.counts is a view of the same
    counters."""
    recovery.reset_counts()
    tres.reset_resilience_metrics()
    tres.drain_quarantine_events()  # spans an earlier test of this process left
    tio.record_bytes_decoded(5)
    tio.set_input_bytes_total(9)
    tio.record_score_bytes_written(2)
    tstream.record_chunk_decode_ms(1.5)
    tstream.set_overlap_fraction(0.25)
    tstream.set_game_stream_evidence(chunk_loads=3, chunk_visits=6, sweeps=2)
    tlayout.record_hybrid_layout("h", k_hot=1, k_hot_padded=8, hot_coverage=0.5, hot_nnz=1,
                                 tail_nnz=1, tail_width=1, hybrid_bytes=10, ell_bytes=12)
    tlayout.record_block_head("h", width=4, num_blocks=2, k_hot_padded=8)
    recovery.counts["retries"] += 2
    tres.record_checkpoint_restore()
    tres.record_quarantined_block("p", 1, 10, 20, "crc")
    snap = treg.default_registry().snapshot()
    assert snap["counters"]["resilience/retries"] == 2 and recovery.counts["retries"] == 2
    assert recovery.counts["checkpoint_restores"] == tres.checkpoint_restores() == 1
    assert tres.drain_quarantine_events() == [
        {"path": "p", "block_index": 1, "byte_start": 10, "byte_end": 20, "reason": "crc"}]
    assert tres.drain_quarantine_events() == []
    assert tio.input_bytes_total() == 9 and tstream.overlap_fraction() == 0.25
    assert tstream.game_stream_evidence() == {"chunk_loads": 3, "chunk_visits": 6, "sweeps": 2}
    assert snap["gauges"]["layout/h/block_head_replication"] == 1.0
    assert snap["counters"]["layout/h/builds"] == 1
    recovery.reset_counts()
    assert dict(recovery.counts.items()) == dict.fromkeys(recovery.counts.keys(), 0)
    tlayout.reset_layout_metrics()
    tstream.reset_stream_metrics()
    assert not any(k.startswith(("layout/", "stream/"))
                   for k in treg.default_registry().snapshot()["gauges"])


# -- solver telemetry ----------------------------------------------------------


def _glm_data(seed=0, n=300, d=6):
    x, y, offsets, weights = make_data(seed, n, d, True)
    jb, tb = batches(x, y, offsets, weights)
    return jb, tb, x


@pytest.mark.parametrize("kind", ["LBFGS", "TRON", "OWLQN"])
def test_train_glm_rows_match(kind):
    """One convergence row and one heartbeat a λ: equal iterations, reasons
    and cursors, values and value histories at rel 1e-8 (f64); the
    registry's solver/glm histograms count the solves."""
    jb, tb, _ = _glm_data()
    jrows, trows = ListJournal(), ListJournal()
    jreg_, treg_ = jreg.MetricsRegistry(), treg.MetricsRegistry()
    alpha = 0.5 if kind == "OWLQN" else 0.0
    jest.train_glm(jb, JTask.LOGISTIC_REGRESSION, optimizer=JOpt(JType[kind], 40),
                   regularization_weights=LAMBDAS, elastic_net_alpha=alpha,
                   telemetry=jst.SolverTelemetry(journal=jrows, registry=jreg_))
    test_.train_glm(tb, TTask.LOGISTIC_REGRESSION, optimizer=TOpt(TType[kind], 40),
                    regularization_weights=LAMBDAS, elastic_net_alpha=alpha,
                    telemetry=tst.SolverTelemetry(journal=trows, registry=treg_))
    assert [r["kind"] for r in trows.rows] == ["convergence", "heartbeat"] * len(LAMBDAS)
    for j, t in _pairs(jrows.rows, trows.rows):
        _same_row(j, t, 1e-8)
    js, ts = jreg_.snapshot(), treg_.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["histograms"]["solver/glm/iterations"] == js["histograms"]["solver/glm/iterations"]


def test_solver_result_row_reads_the_host_once_a_solve():
    """The row of a SolverResult matches the JAX row of the same values."""
    from photon_ml_torch.optim.common import SolverResult

    hist = torch.tensor([3.0, 2.0, 1.5, float("nan")], dtype=torch.float64)
    r = SolverResult(coefficients=torch.zeros(2), value=torch.tensor(1.5, dtype=torch.float64),
                     gradient_norm=torch.tensor(0.01, dtype=torch.float64), iterations=2,
                     reason=2, value_history=hist, grad_norm_history=hist)
    row = tst.solver_result_row(r)
    assert row == {"iterations": 2, "reason": "FUNCTION_VALUES_WITHIN_TOLERANCE",
                   "converged": True, "value": 1.5, "gradient_norm": 0.01,
                   "value_history": [3.0, 2.0, 1.5]}


@pytest.mark.parametrize("limit", [None, 2])
def test_grid_lane_rows_and_summary_match(limit):
    """train_glm_grid's lane rows (keyed by λ) and its convergence_lanes
    summary: iterations and reasons equal, values at rel 1e-8; the
    per-lane iteration histogram is fed; rows cap at max_lane_rows."""
    jb, tb, _ = _glm_data(1)
    kw = {} if limit is None else {"max_lane_rows": limit}
    jrows, trows = ListJournal(), ListJournal()
    jreg_, treg_ = jreg.MetricsRegistry(), treg.MetricsRegistry()
    jest.train_glm_grid(jb, JTask.LOGISTIC_REGRESSION, optimizer=JOpt(JType.LBFGS, 50),
                        regularization_weights=LAMBDAS,
                        telemetry=jst.SolverTelemetry(journal=jrows, registry=jreg_, **kw))
    test_.train_glm_grid(tb, TTask.LOGISTIC_REGRESSION, optimizer=TOpt(TType.LBFGS, 50),
                         regularization_weights=LAMBDAS,
                         telemetry=tst.SolverTelemetry(journal=trows, registry=treg_, **kw))
    assert [r["kind"] for r in trows.rows] == \
        ["convergence"] * (limit or len(LAMBDAS)) + ["convergence_lanes"]
    for j, t in _pairs(jrows.rows, trows.rows):
        _same_row(j, t, 1e-8)
    js, ts = jreg_.snapshot(), treg_.snapshot()
    assert ts["counters"] == js["counters"]
    assert ts["histograms"][tst.LANE_ITERS_METRIC] == js["histograms"][jst.LANE_ITERS_METRIC]


def test_tournament_and_search_journal_rows_match():
    """A tournament's lane rows keyed by (l2, l1), and the model search's
    search_round and search_complete rows (its lane telemetry included):
    the same kinds and keys, counts and configurations equal, metrics at
    rel 1e-7."""
    jb, tb, x = _glm_data(2, n=400, d=5)
    jv, tv, _ = _glm_data(3, n=300, d=5)
    jn, tn = normalizations("STANDARDIZATION", x, intercept_index=4)

    def configs(mod):
        l2 = np.geomspace(0.01, 10.0, 4)
        return mod.LaneConfigs(l2=l2, l1=0.1 * l2, tolerance=np.full(4, 1e-8))

    jrows, trows = ListJournal(), ListJournal()
    jest.train_glm_tournament(jb, JTask.LOGISTIC_REGRESSION, configs(jls), normalization=jn,
                              optimizer=JOpt(JType.LBFGS, 40), intercept_index=4,
                              telemetry=jst.SolverTelemetry(journal=jrows))
    test_.train_glm_tournament(tb, TTask.LOGISTIC_REGRESSION, configs(tls), normalization=tn,
                               optimizer=TOpt(TType.LBFGS, 40), intercept_index=4,
                               telemetry=tst.SolverTelemetry(journal=trows))
    for j, t in _pairs(jrows.rows, trows.rows):
        _same_row(j, t, 1e-8)
    space = "lambda=1e-3:1e2:log"
    common = dict(rounds=2, lane_budget=3, seed=0, intercept_index=4)
    jrows, trows = ListJournal(), ListJournal()
    jsd.run_model_search(jb, jv, JTask.LOGISTIC_REGRESSION, jsd.parse_search_space(space),
                         searcher="sobol", normalization=jn, optimizer=JOpt(JType.LBFGS, 40),
                         journal=jrows, telemetry=jst.SolverTelemetry(journal=jrows), **common)
    tsd.run_model_search(tb, tv, TTask.LOGISTIC_REGRESSION, tsd.parse_search_space(space),
                         searcher="sobol", normalization=tn, optimizer=TOpt(TType.LBFGS, 40),
                         journal=trows, telemetry=tst.SolverTelemetry(journal=trows), **common)
    kinds = [r["kind"] for r in trows.rows]
    assert kinds.count("search_round") == 2 and kinds[-1] == "search_complete"
    for j, t in _pairs(jrows.rows, trows.rows):
        if j["kind"] == "search_round":
            for k in ("round", "source", "lanes", "warm_lanes", "metric"):
                assert t[k] == j[k]
            np.testing.assert_allclose(t["best_metric"], j["best_metric"], rtol=1e-7)
        elif j["kind"] == "search_complete":
            assert t["configs"] == j["configs"] and t["metric"] == j["metric"]
            np.testing.assert_allclose(t["best_config"]["lambda"], j["best_config"]["lambda"],
                                       rtol=1e-12)
        else:
            _same_row(j, t, 1e-7)


def test_search_failure_is_journaled():
    """A search whose metric is never finite raises after its rounds; a
    failure inside a round journals search_failure before it propagates."""
    _, tb, _ = _glm_data(4, n=200, d=5)
    _, tv, _ = _glm_data(5, n=100, d=5)
    rows = ListJournal()
    with pytest.raises(ValueError):
        tsd.run_model_search(tb, tv, TTask.LOGISTIC_REGRESSION,
                             tsd.parse_search_space("lambda=1:2"), rounds=1, lane_budget=2,
                             optimizer=TOpt(TType.TRON, 5), journal=rows)
    assert [r["kind"] for r in rows.rows] == ["search_failure"]
    assert rows.rows[0]["round"] == 0 and "ValueError" in rows.rows[0]["error"]


def test_streaming_rows_and_heartbeats():
    """train_glm_streaming: a heartbeat every outer iteration (an epoch
    boundary) and one convergence row a λ; the rows match train_glm's
    (the same solves) in iterations and reasons; the decode histogram and
    the epoch gauges are fed."""
    _, tb, x = _glm_data(6, n=240, d=5)
    tstream.reset_stream_metrics()
    y = tb.labels.numpy()
    rows = ListJournal()
    source = ArrayChunkSource(x, y, chunk_rows=64, offsets=tb.offsets.numpy(),
                              weights=tb.weights.numpy())
    test_.train_glm_streaming(source, TTask.LOGISTIC_REGRESSION, optimizer=TOpt(TType.LBFGS, 20),
                              regularization_weights=(0.5, 5.0), device="cpu",
                              telemetry=tst.SolverTelemetry(journal=rows))
    conv = [r for r in rows.rows if r["kind"] == "convergence"]
    beats = [r for r in rows.rows if r["kind"] == "heartbeat"]
    assert [r["lambda"] for r in conv] == [0.5, 5.0] and all(r["chunks"] == 4 for r in conv)
    assert len(beats) == sum(r["iterations"] for r in conv)
    assert beats[0]["stage"] == "glm_streaming" and beats[0]["n_lambdas"] == 2
    ref = ListJournal()
    test_.train_glm(tb, TTask.LOGISTIC_REGRESSION, optimizer=TOpt(TType.LBFGS, 20),
                    regularization_weights=(0.5, 5.0), telemetry=tst.SolverTelemetry(journal=ref))
    ref_conv = [r for r in ref.rows if r["kind"] == "convergence"]
    assert [(r["iterations"], r["reason"]) for r in conv] == \
        [(r["iterations"], r["reason"]) for r in ref_conv]
    assert tstream.chunks_per_epoch() == 4
    assert tstream.chunk_decode_summary()["count"] >= 4 * len(beats)


@pytest.mark.parametrize("iterations", [1, 2])
def test_game_estimator_rows_match(iterations):
    """GameEstimator.fit with telemetry: the fixed effect's convergence rows
    and the random effects' lane rows and summaries at each outer
    iteration, with the evaluation metrics, then a heartbeat a sweep:
    equal kinds, keys, iterations and reasons, values at rel 1e-8; the
    fit's models equal the fit without telemetry."""
    a = game_arrays(3, n=300, n_users=12)
    jd, td = datasets(a)
    je, te = estimator_pair(num_iterations=iterations, lane_iterations=8)
    jrows, trows = ListJournal(), ListJournal()
    jr = dataclasses.replace(je, telemetry=jst.SolverTelemetry(journal=jrows)).fit(jd)
    tr = dataclasses.replace(te, telemetry=tst.SolverTelemetry(journal=trows)).fit(td)
    kinds = [r["kind"] for r in trows.rows]
    assert kinds.count("heartbeat") == iterations and kinds.count("convergence_lanes") == \
        2 * iterations
    for j, t in _pairs(jrows.rows, trows.rows):
        _same_row(j, t, 1e-8)
    plain = te.fit(td)
    for cid, m in tr.model.models.items():
        ref = plain.model.models[cid]
        got = m.glm.coefficients.means if hasattr(m, "glm") else m.coefficients
        want = ref.glm.coefficients.means if hasattr(ref, "glm") else ref.coefficients
        assert torch.equal(got, want)
    assert model_to_plain(jr.model).keys() == tr.model.models.keys()


def test_coordinate_descent_rows_carry_metrics():
    """run_coordinate_descent with a training evaluator: each update's row
    carries its evaluation, and an update whose info is None journals a
    coordinate_update row."""
    from photon_ml_torch.evaluation.evaluators import EvaluationData, parse_evaluator

    a = game_arrays(4, n=200, n_users=8)
    _, td = datasets(a)
    _, te = estimator_pair(num_iterations=1, lane_iterations=4)
    sequence, coords = te._build_coordinates(td, None)
    rows = ListJournal()
    data = EvaluationData(labels=td.host_array("labels"), offsets=td.host_array("offsets"),
                          weights=td.host_array("weights"), ids=td.ids)
    run_coordinate_descent(coords, sequence, 1, training_evaluator=parse_evaluator("AUC"),
                           training_data=data, telemetry=tst.SolverTelemetry(journal=rows))
    conv = [r for r in rows.rows if r["kind"] in ("convergence", "convergence_lanes")]
    assert {r["coordinate"] for r in conv} == set(sequence)
    assert all("train:AUC" in r["evaluation"] for r in conv if "evaluation" in r)
    tel = tst.SolverTelemetry(journal=rows)
    tel.record_coordinate("mf", 0, None, metrics={"train:AUC": 0.5})
    assert rows.rows[-1] == {"kind": "coordinate_update", "coordinate": "mf",
                             "outer_iteration": 0, "evaluation": {"train:AUC": 0.5}}


def test_refresh_heartbeats():
    """GameEstimator.refresh with telemetry: a heartbeat after each refreshed
    coordinate (a carried one commits without), the position and the
    coordinate count as its cursor, the JAX package's rows."""
    from photon_ml_tpu.algorithm import refresh as jrefresh

    a = game_arrays(11, n=300, n_users=10)
    jd, td = datasets(a)
    je, te = estimator_pair(num_iterations=1, lane_iterations=6)
    jmodel, tmodel = je.fit(jd).model, te.fit(td).model
    jrows, trows = ListJournal(), ListJournal()
    dataclasses.replace(je, telemetry=jst.SolverTelemetry(journal=jrows)).refresh(
        jd, jmodel, jrefresh.RefreshPolicy(gradient_tolerance=0.05))
    dataclasses.replace(te, telemetry=tst.SolverTelemetry(journal=trows)).refresh(
        td, tmodel, trefresh.RefreshPolicy(gradient_tolerance=0.05))
    beats = [r for r in trows.rows if r["kind"] == "heartbeat"]
    assert beats == [r for r in jrows.rows if r["kind"] == "heartbeat"]
    assert [b["position"] for b in beats] == [2, 3]
    assert all(b["stage"] == "game_refresh" and b["num_coordinates"] == 3 for b in beats)


def test_no_sink_builds_no_row():
    """With no live sink the telemetry reads nothing and returns nothing;
    an inert journal (rank > 0) counts as no sink."""
    inert = tst.SolverTelemetry(journal=tj.RunJournal(None), emitter=tev.EventEmitter())
    assert not inert._has_sink()
    assert inert.record_lanes("x", object()) == {} and inert.record_solve("x", object()) == {}
    seen = []
    em = tev.EventEmitter()
    em.register(seen.append)
    _, tb, _ = _glm_data(7, n=120, d=4)
    test_.train_glm(tb, TTask.LOGISTIC_REGRESSION, optimizer=TOpt(TType.LBFGS, 10),
                    regularization_weights=(1.0,), telemetry=tst.SolverTelemetry(emitter=em))
    assert [type(e).__name__ for e in seen] == ["OptimizationLogEvent"]
    assert seen[0].coordinate_id == "glm" and seen[0].metrics["lambda"] == 1.0
    assert math.isfinite(seen[0].metrics["value"])
