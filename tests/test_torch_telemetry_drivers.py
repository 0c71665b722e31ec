"""The four drivers with their telemetry flags, the port against the JAX
package, on the CPU and the fixtures of ``tests/test_torch_drivers.py`` and
``tests/test_torch_serving.py``.

Each driver runs once in each package with ``--telemetry-dir`` and
``--trace-dir`` (the GLM driver also with ``--enable-diagnostics
--num-bootstraps``, the GAME training driver of the port also with
``--profile-dir``). The journals hold the same row kinds with the same keys
but for the rows of the program ledger and its probes, which the port adds
in a later step: the difference is asserted to be exactly that set. The
JAX package's program ledger needs ``jax.core.trace_state_clean``, which the
installed JAX lacks, so its ledger is not installed here (its rows are the
excluded ones). The drivers train in float32, so values hold at the
drivers' tolerances; the port's outputs with telemetry are bitwise its
outputs without.
"""

import json
import re

import numpy as np
import pytest

from photon_ml_torch.cli import game_scoring_driver as tscore
from photon_ml_torch.cli import game_training_driver as ttrain
from photon_ml_torch.cli import glm_driver as tglm
from photon_ml_torch.cli import serve_driver as tserve
from photon_ml_torch.telemetry import read_journal
from photon_ml_tpu.cli import game_scoring_driver as jscore
from photon_ml_tpu.cli import game_training_driver as jtrain
from photon_ml_tpu.cli import glm_driver as jglm
from photon_ml_tpu.cli import serve_driver as jserve
from tests import torch_driver_parity as P

#: journal rows and fields only the JAX package writes until the port's
#: program ledger and probes land: the compile-count and live-buffer gauges
#: and the heartbeat's compile count; ``hbm_bytes`` is the JAX package's
#: live device buffers, which the port reports on a CUDA device only
STEP2_ROWS = {("gauge", "jax/backend_compile_count"), ("gauge", "device/live_buffer_bytes")}
STEP2_FIELDS = {"compiles"}
CPU_FIELDS = {"hbm_bytes"}
STEP2_METRICS = {"jax/backend_compile_count", "jax/backend_compile_seconds"}
STAMPS = {"seq", "ts", "elapsed_ms"}
EXTRA = P.FE_ARGS + P.PER_USER_ARGS + ["--coordinate-descent-iterations", "2"]


def _kind(row):
    return ("gauge", row["name"]) if row["kind"] == "gauge" else row["kind"]


def _signature(rows) -> set:
    """(row kind, field) of every row's fields but the stamps."""
    return {(_kind(r), k) for r in rows for k in r if k not in STAMPS}


def _metric_names(rows) -> set:
    snap = [r for r in rows if r["kind"] == "metrics"][-1]["snapshot"]
    return {name for part in snap.values() for name in part if not name.startswith("timing/")}


def _assert_same_rows(jdir, tdir, *, heartbeats: bool = True):
    """The JAX journal's rows and fields less the port's are exactly the
    ledger's and probes' (and the CPU's device-memory field), and the port
    writes none the JAX package does not; the metric names (phase timings
    apart, each package timing its own blocks) likewise."""
    jrows = read_journal(jdir / "run-journal.jsonl")
    trows = read_journal(tdir / "run-journal.jsonl")
    js, ts = _signature(jrows), _signature(trows)
    expected = {(k, f) for k, f in js if k in STEP2_ROWS}
    if heartbeats:
        expected |= {("heartbeat", f) for f in STEP2_FIELDS | CPU_FIELDS}
    assert js - ts == expected
    assert ts - js == set()
    assert _metric_names(jrows) - _metric_names(trows) == STEP2_METRICS
    assert _metric_names(trows) - _metric_names(jrows) == set()
    assert [r["kind"] for r in trows][0] == "journal_open" == [r["kind"] for r in jrows][0]
    assert trows[-1]["kind"] == "journal_close" and not (tdir / "run-journal.jsonl.partial"
                                                         ).exists()
    return jrows, trows


def _fresh_process_state() -> None:
    """Both packages' process-wide registries and quarantine rings emptied:
    a worker's earlier tests (of either package) leave metrics and
    quarantined spans there that the drivers' journals would carry."""
    from photon_ml_torch.telemetry import registry as treg
    from photon_ml_torch.telemetry import resilience_counters as tres
    from photon_ml_tpu.telemetry import registry as jreg
    from photon_ml_tpu.telemetry import resilience_counters as jres

    treg.default_registry().reset()
    jreg.default_registry().reset()
    tres.drain_quarantine_events()
    jres.drain_quarantine_events()


def _trace_files(d) -> list:
    return sorted(p.name for p in d.iterdir())


@pytest.fixture(scope="module", autouse=True)
def own_registries():
    """Both packages' process-wide registries as they were before this
    module, restored after it: the fixtures below empty them."""
    from photon_ml_torch.telemetry import registry as treg
    from photon_ml_tpu.telemetry import registry as jreg

    saved = [(reg, dict(reg._metrics)) for reg in (treg.default_registry(),
                                                   jreg.default_registry())]
    yield
    for reg, metrics in saved:
        with reg._lock:
            reg._metrics.clear()
            reg._metrics.update(metrics)


@pytest.fixture(scope="module", autouse=True)
def no_jax_ledger():
    """The JAX package's program ledger stays uninstalled (see the module
    docstring); nothing else of the JAX drivers changes."""
    import photon_ml_tpu.telemetry.program_ledger as ledger

    mp = pytest.MonkeyPatch()
    mp.setattr(ledger, "install_ledger", lambda led: led)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def glm(tmp_path_factory):
    base = tmp_path_factory.mktemp("glm")
    P.write_logistic(str(base / "data"))
    _fresh_process_state()

    def args(out, telemetry=True):
        a = ["--input-data-path", str(base / "data" / "train"), "--validation-data-path",
             str(base / "data" / "test"), "--output-dir", str(base / out),
             "--task-type", "LOGISTIC_REGRESSION", "--regularization-weights", "0.1,1,10"]
        if telemetry:
            a += ["--enable-diagnostics", "--num-bootstraps", "3", "--telemetry-dir",
                  str(base / f"{out}-tel"), "--trace-dir", str(base / f"{out}-tr")]
        return a

    seen = {"j": [], "t": []}
    jglm.events.register(seen["j"].append)
    tglm.events.register(seen["t"].append)
    try:
        j = jglm.main(args("j"))
        t = tglm.main(args("t"), device="cpu")
    finally:
        jglm.events.unregister(seen["j"].append)
        tglm.events.unregister(seen["t"].append)
    plain = tglm.main(args("plain", telemetry=False), device="cpu")
    return base, j, t, plain, seen


def test_glm_driver_journal_and_events_match(glm):
    """The GLM driver's journal rows (config, a convergence row and a
    heartbeat a λ, phase timings, the trace's straggler report, the
    registry's snapshot) match the JAX driver's up to the ledger's rows; the
    per-λ iterations equal the trace's solver/iteration spans; the events
    come in the JAX driver's order."""
    base, j, t, _, seen = glm
    jrows, trows = _assert_same_rows(base / "j-tel", base / "t-tel")
    jconv = [r for r in jrows if r["kind"] == "convergence"]
    tconv = [r for r in trows if r["kind"] == "convergence"]
    assert [r["lambda"] for r in tconv] == [r["lambda"] for r in jconv] == [0.1, 1.0, 10.0]
    assert _trace_files(base / "t-tr") == _trace_files(base / "j-tr") == ["trace-00000.json"]
    trace = json.loads((base / "t-tr" / "trace-00000.json").read_text())
    train = [e for e in trace["traceEvents"] if e.get("name") == "phase/glm train"][0]
    spans = [e for e in trace["traceEvents"] if e.get("name") == "solver/iteration"
             and train["ts"] <= e["ts"] <= train["ts"] + train["dur"]]
    # the training phase's iterations; the diagnostics' refits add their own
    assert len(spans) == sum(r["iterations"] for r in tconv)
    assert {e["name"] for e in trace["traceEvents"]} >= {"phase/glm train", "phase/glm diagnose"}
    assert [type(e).__name__ for e in seen["t"]] == [type(e).__name__ for e in seen["j"]] == \
        ["SetupEvent", "TrainingStartEvent"] + ["OptimizationLogEvent"] * 3 + \
        ["TrainingFinishEvent"]
    tconf, jconf = (json.loads(seen[k][0].config_summary) for k in "tj")
    assert tconf.pop("trace_dir").endswith("t-tr") and jconf.pop("trace_dir").endswith("j-tr")
    assert tconf == jconf


def _report_tables(text: str) -> dict:
    """{section title: [[cell, ...], ...]} of the text report's tables."""
    out, section = {}, None
    for line in text.splitlines():
        m = re.match(r"^\d+\.\d+ (.*)$", line)
        if m:
            section = m.group(1)
        elif line.startswith("  ") and "|" in line and section is not None:
            out.setdefault(section, []).append([c.strip() for c in line.split("|")])
    return out


def test_glm_driver_diagnostic_report_matches(glm):
    """diagnostic-report.{html,txt} written in the DIAGNOSED stage: the same
    chapters, sections and tables as the JAX driver's report; the validation
    metrics table within the drivers' 1e-3; the models with telemetry and
    diagnostics bitwise the models without."""
    base, j, t, plain, _ = glm
    assert t.stage.name == j.stage.name == "DIAGNOSED" and t.best_lambda == j.best_lambda
    jt, tt = ((base / d / "diagnostic-report.txt").read_text() for d in ("j", "t"))
    heads = [line for line in jt.splitlines() if re.match(r"^\d+\.(\d+)? ", line)]
    assert heads == [line for line in tt.splitlines() if re.match(r"^\d+\.(\d+)? ", line)]
    assert (base / "t" / "diagnostic-report.html").read_text().startswith("<!DOCTYPE html>")
    jtab, ttab = _report_tables(jt), _report_tables(tt)
    assert set(ttab) == set(jtab)
    for title in jtab:
        assert len(ttab[title]) == len(jtab[title]) and ttab[title][0] == jtab[title][0], title
    metrics = "Validation metrics per regularization weight"
    for jrow, trow in zip(jtab[metrics][1:], ttab[metrics][1:]):
        np.testing.assert_allclose(np.asarray(trow, float), np.asarray(jrow, float), atol=1e-3)
    for lam, model in plain.models.items():
        assert np.array_equal(model.coefficients.means.numpy(),
                              t.models[lam].coefficients.means.numpy())
    for name in ("models-text", "glm-summary.json"):
        a, b = base / "t" / name, base / "plain" / name
        if a.is_dir():
            for f in sorted(a.iterdir()):
                assert f.read_bytes() == (b / f.name).read_bytes(), f.name
        else:
            got, ref = json.loads(a.read_text()), json.loads(b.read_text())
            assert got["validation_metrics"] == ref["validation_metrics"]


@pytest.fixture(scope="module")
def game(tmp_path_factory):
    base = tmp_path_factory.mktemp("game")
    P.write_music(base)
    _fresh_process_state()

    def targs(out, telemetry=True):
        a = P.training_args(base, base / out, EXTRA)
        if telemetry:
            a += ["--telemetry-dir", str(base / f"{out}-tel"), "--trace-dir",
                  str(base / f"{out}-tr")]
        return a

    # the runs without telemetry first: each package's registry then holds
    # the same runs' metrics when the next driver snapshots it
    ttrain.main(targs("plain", telemetry=False), device="cpu")
    jsum = jtrain.main(targs("jt"))
    tsum = ttrain.main(targs("tt") + ["--profile-dir", str(base / "tt-prof")], device="cpu")

    def sargs(model, out, telemetry=True):
        a = ["--input-data-path", str(base / "test"), "--model-input-dir", str(base / model),
             "--output-dir", str(base / out), "--evaluators", "RMSE"]
        if telemetry:
            a += ["--telemetry-dir", str(base / f"{out}-tel"), "--trace-dir",
                  str(base / f"{out}-tr")]
        return a

    tscore.main(sargs("tt/best", "ts-plain", telemetry=False), device="cpu")
    jscore.main(sargs("jt/best", "js"))
    tscore.main(sargs("tt/best", "ts"), device="cpu")

    def vargs(model, out, telemetry=True):
        a = ["--requests-avro", str(base / "test"), "--model-input-dir", str(base / model),
             "--output-dir", str(base / out), "--num-requests", "40", "--request-rows", "4",
             "--microbatch-shapes", "32,128", "--max-wait-ms", "5"]
        if telemetry:
            a += ["--telemetry-dir", str(base / f"{out}-tel"), "--trace-dir",
                  str(base / f"{out}-tr")]
        return a

    jserve.main(vargs("jt/best", "jv"))
    tserve.main(vargs("tt/best", "tv"), device="cpu")
    return base, jsum, tsum


def test_game_training_driver_journal_matches(game):
    """The GAME training driver: the config row, the fixed effect's
    convergence rows and the per-user lane rows and summaries with their
    evaluations, a heartbeat a sweep, the straggler report and the
    snapshot, as the JAX driver writes them but the ledger's; the same rows
    for the same coordinates and sweeps; best metrics within 1e-3."""
    base, jsum, tsum = game
    jrows, trows = _assert_same_rows(base / "jt-tel", base / "tt-tel")

    def shape(rows):
        return [(r["kind"], r.get("coordinate"), r.get("outer_iteration"), r.get("stage"),
                 r.get("sweep")) for r in rows if r["kind"] in
                ("convergence_lanes", "heartbeat", "config")
                or (r["kind"] == "convergence" and "lane" not in r)]

    assert shape(trows) == shape(jrows)
    jc = [r for r in jrows if r["kind"] == "config"][0]
    tc = [r for r in trows if r["kind"] == "config"][0]
    assert {k: v for k, v in tc.items() if k not in STAMPS} == \
        {k: v for k, v in jc.items() if k not in STAMPS}
    assert tsum["best_metric"] == pytest.approx(jsum["best_metric"], rel=1e-3)


def test_game_training_driver_traces_and_profile(game):
    """One host trace file (trace-00000.json) with the driver's phases and
    the solvers' iterations; the --profile-dir Chrome trace of the run;
    the coefficient files bitwise those of the run without telemetry."""
    base, _, _ = game
    assert _trace_files(base / "tt-tr") == _trace_files(base / "jt-tr") == ["trace-00000.json"]
    trace = json.loads((base / "tt-tr" / "trace-00000.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"phase/read training data", "phase/train config 0", "solver/iteration"} <= names
    profiles = list((base / "tt-prof").iterdir())
    assert len(profiles) == 1 and "traceEvents" in json.loads(profiles[0].read_text())
    for f in sorted((base / "plain" / "best").rglob("*")):
        if f.is_file():
            rel = f.relative_to(base / "plain" / "best")
            assert (base / "tt" / "best" / rel).read_bytes() == f.read_bytes(), rel


def test_scoring_driver_journal_matches(game):
    """The scoring driver: a heartbeat a dataset, the scoring summary, the
    straggler report and the snapshot, as the JAX driver writes them; the
    summaries' evaluations within 1e-3; the scores bitwise those of the run
    without telemetry."""
    base, _, _ = game
    jrows, trows = _assert_same_rows(base / "js-tel", base / "ts-tel")
    js = [r for r in jrows if r["kind"] == "scoring_summary"][0]
    ts = [r for r in trows if r["kind"] == "scoring_summary"][0]
    assert ts["num_scored"] == js["num_scored"] == 400
    assert ts["evaluations"]["RMSE"] == pytest.approx(js["evaluations"]["RMSE"], rel=1e-3)
    for f in sorted((base / "ts-plain" / "scores").iterdir()):
        assert (base / "ts" / "scores" / f.name).read_bytes() == f.read_bytes()
    assert _trace_files(base / "ts-tr") == ["trace-00000.json"]


def test_serve_driver_journal_matches(game):
    """The serve driver: the serving summary (the JAX driver's keys) and the
    serving counters and latency histogram in the snapshot; the trace holds
    the micro-batches' and the resident scorer's spans."""
    base, _, _ = game
    jrows, trows = _assert_same_rows(base / "jv-tel", base / "tv-tel", heartbeats=False)
    ts = [r for r in trows if r["kind"] == "serving_summary"][0]
    js = [r for r in jrows if r["kind"] == "serving_summary"][0]
    assert set(ts) == set(js) and ts["num_requests"] == js["num_requests"] == 40
    assert ts["program_compiles"] is None
    snap = [r for r in trows if r["kind"] == "metrics"][0]["snapshot"]
    assert snap["counters"]["serve/requests"] >= 40 and \
        snap["histograms"]["serve/latency_ms"]["count"] >= 40
    trace = json.loads((base / "tv-tr" / "trace-00000.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"serve/batch", "serve/score"} <= names
