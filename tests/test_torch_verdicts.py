"""The port's verdicts (``photon_ml_torch/telemetry/verdicts.py``) against
the JAX package's, on the CPU: the rule registry, the row, artifact,
multichip and history judgements over artifacts the tests write to a
temporary directory, and the journal, ledger and coordination findings over
synthetic journal rows carrying every pathology the rules name.
"""

import dataclasses
import re

import pytest

from photon_ml_torch.telemetry import bench_history as tb
from photon_ml_torch.telemetry import verdicts as tv
from photon_ml_tpu.telemetry import bench_history as jb
from photon_ml_tpu.telemetry import verdicts as jv
from tests.test_torch_bench_history import write_history

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


#: the details where the JAX package cites its own tracker item or notes file;
#: the port's text leaves the citation out
CITATIONS = ((re.compile(r"\([A-Z]+ \d+'s point is that (it must not)\)"), r"(\1)"),
             (re.compile(r"; [A-Z]+\.md\)"), ")"))


def _detail(text: str) -> str:
    for pattern, repl in CITATIONS:
        text = pattern.sub(repl, text)
    return text


def _plain(items):
    return [dict(dataclasses.asdict(v), detail=_detail(v.detail)) for v in items]


def test_rule_registry_matches():
    assert [(r.pattern, r.name, r.higher_better) for r in tv.registered_rules()] == \
        [(r.pattern, r.name, r.higher_better) for r in jv.registered_rules()]
    for metric in ("fe_hot_loop_stream_gbps", "serve_scores_per_sec", "nope"):
        t, j = tv.rule_for(metric), jv.rule_for(metric)
        assert (t is None) == (j is None)
        if t is not None:
            assert (t.pattern, t.name) == (j.pattern, j.name)
    for name in ("WIN", "REGRESSION", "FLAT", "INFO", "PATHOLOGY", "WARNING", "NO_EVIDENCE",
                 "BLOWOUT_RATIO", "FLAT_BAND", "RECOMPILE_STORM_REDUNDANT_MIN",
                 "SIGNATURE_CHURN_MIN", "COMPILE_DOMINATED_FRACTION"):
        assert getattr(tv, name) == getattr(jv, name)


@pytest.mark.parametrize("rounds", [(1, 2, 3), (2,), (3, 1)])
def test_artifact_and_history_judgements_match(tmp_path, rounds):
    """judge_row/judge_artifact on every round (a salvaged one included),
    judge_multichip on each multichip round, history_findings and
    regressions over the whole directory: equal verdicts."""
    write_history(tmp_path, rounds=rounds)
    th, jh = tb.load_history(str(tmp_path)), jb.load_history(str(tmp_path))
    for tart, jart in zip(th.artifacts + [th.sidecar], jh.artifacts + [jh.sidecar]):
        tver, jver = tv.judge_artifact(tart), jv.judge_artifact(jart)
        assert _plain(tver) == _plain(jver)
        assert _plain(tv.regressions(tver)) == _plain(jv.regressions(jver))
        for trow, jrow in zip(tart.all_rows, jart.all_rows):
            assert _plain([tv.judge_row(trow, tart)]) == _plain([jv.judge_row(jrow, jart)])
    for tm, jm in zip(th.multichip, jh.multichip):
        assert dataclasses.asdict(tv.judge_multichip(tm)) == \
            dataclasses.asdict(jv.judge_multichip(jm))
    assert _plain(tv.history_findings(th)) == _plain(jv.history_findings(jh))


def _sig(n):
    return {"leaves": [{"path": "arg0.x", "kind": "array", "shape": [n, 3], "dtype": "float32",
                        "sharding": None}], "static": []}


def _journal(*, closed=True):
    """Rows with every journal finding the rules name: a run failure, the
    stream overlap, pad fraction, quarantine, preemption and give-up
    counters, a straggler report, and the ledger's recompile storm (with
    its attribution), signature churn, compile-dominated seconds and a
    memory overcommit forecast."""
    counters = {"resilience/quarantined_blocks": 2, "resilience/preemptions": 1,
                "resilience/checkpoint_restores": 1, "resilience/epochs_resumed": 3,
                "resilience/giveups": 1,
                "xla/serve/score/compiles": 9, "xla/serve/score/recompiles": 8,
                "xla/train/step/compiles": 2, "xla/coord/fe_solve/compiles": 1}
    gauges = {"stream/overlap_fraction": 0.001, "stream/chunks_per_epoch": 4.0,
              "serve/pad_fraction": 0.8, "xla/serve/score/signatures": 2.0,
              "xla/train/step/signatures": 2.0, "xla/coord/re_bucket_solve/signatures": 11.0,
              "xla/coord/fe_solve/signatures": None}
    rows = [
        {"kind": "journal_open", "seq": 0, "ts": 1.0, "elapsed_ms": 0.0},
        {"kind": "config", "streaming_prefetch": True},
        {"kind": "heartbeat", "sweep": 3, "compiles": 5, "hbm_bytes": 10},
        {"kind": "program_compile", "label": "serve/score", "hbm_forecast_bytes": 9 * 10 ** 10,
         "device_bytes_limit": 8 * 10 ** 10, "signature": _sig(8)},
        {"kind": "program_compile", "label": "serve/score", "hbm_forecast_bytes": 9 * 10 ** 10,
         "device_bytes_limit": 8 * 10 ** 10, "signature": _sig(16)},
        {"kind": "program_compile", "label": "train/step", "hbm_forecast_bytes": None,
         "device_bytes_limit": None},
        {"kind": "program_recompile", "label": "serve/score",
         "summary": "arg0.x: shape [8, 3] -> [16, 3]"},
        {"kind": "program_recompile", "label": "serve/score",
         "summary": "arg0.x: shape [16, 3] -> [32, 3]"},
        {"kind": "run_failure", "error": "RuntimeError('x')", "transient": True,
         "preemption": False, "restarts_used": 2},
        {"kind": "straggler_report", "num_ranks": 2, "tags": [
            {"tag": "stream/*", "wait_s": [0.4, 0.0], "count": [1, 1], "missing_ranks": [],
             "straggler_rank": 1, "reason": "never_arrived"}]},
        {"kind": "metrics", "snapshot": {
            "counters": counters, "gauges": gauges,
            "histograms": {"jax/backend_compile_seconds": {"count": 12, "total": 40.0}}}},
    ]
    if closed:
        rows.append({"kind": "journal_close", "elapsed_ms": 60000.0})
    else:
        rows[-1]["elapsed_ms"] = 60000.0
    return rows


@pytest.mark.parametrize("closed", [True, False])
def test_journal_findings_match(closed):
    rows = _journal(closed=closed)
    t, j = tv.journal_findings(rows), jv.journal_findings(rows)
    assert _plain(t) == _plain(j)
    rules = {v.rule for v in t}
    assert {"recompile-storm", "signature-churn", "compile-dominated",
            "hbm-overcommit-forecast", "overlap-with-prefetch-on", "pad-fraction-high",
            "quarantine-nonzero", "preemption-restarts", "restart-budget-exhausted",
            "run-failure", "straggler-attribution"} <= rules
    assert ("journal-finalized" in rules) is not closed
    storm = next(v for v in t if v.rule == "recompile-storm")
    assert "[16, 3] -> [32, 3]" in storm.detail
    assert tv.journal_findings([]) == jv.journal_findings([]) == []


def test_a_quiet_ledger_has_no_finding():
    """A journal whose labels compiled once a signature (a training run on a
    built card) carries no ledger finding."""
    rows = [{"kind": "metrics", "snapshot": {
        "counters": {"xla/train/step/compiles": 0, "xla/coord/fe_solve/compiles": 0},
        "gauges": {"xla/train/step/signatures": 1.0, "xla/coord/fe_solve/signatures": 2.0},
        "histograms": {"jax/backend_compile_seconds": {"count": 0, "total": 0.0}}}},
        {"kind": "journal_close", "elapsed_ms": 90000.0}]
    assert tv.journal_findings(rows) == jv.journal_findings(rows) == []


def _coordination_rows(storm: bool):
    rows = []
    for gen in (1, 2, 3):
        for rank in (0, 1, 2):
            rows.append({"kind": "coordinated_restart", "rank": rank, "generation": gen,
                         "origin_rank": 2 if storm else gen % 3, "exhausted": storm and gen == 3,
                         "ts": float(gen * 10 + rank)})
        rows.append({"kind": "peer_abort", "rank": 0, "generation": gen, "ts": gen * 10.0 + 5})
        rows.append({"kind": "abort_written", "rank": 2, "generation": gen,
                     "ts": gen * 10.0 + 4})
    rows.append({"kind": "run_failure", "origin_rank": 2, "restarts_used": 3,
                 "max_restarts": 3})
    return rows


@pytest.mark.parametrize("storm", [True, False])
def test_coordination_findings_and_abort_marker_match(storm):
    rows = _coordination_rows(storm)
    assert _plain(tv.coordination_findings(rows)) == _plain(jv.coordination_findings(rows))
    assert tv.last_abort_marker(rows) == jv.last_abort_marker(rows)
    rules = {v.rule for v in tv.coordination_findings(rows)}
    assert ("restart-storm" in rules) is storm
    assert tv.coordination_findings([]) == [] and tv.last_abort_marker([]) is None
