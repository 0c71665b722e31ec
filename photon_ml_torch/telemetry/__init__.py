"""Structured run telemetry (the port's own copies): the metrics registry,
the JSONL run journal, span tracing, solver convergence telemetry and the
counters the I/O, streaming, resilience, layout, serving and refresh layers
feed.

Counterpart of ``photon_ml_tpu/telemetry``; reference the PhotonLogger /
OptimizationStatesTracker / PhotonOptimizationLogEvent triple (photon-lib
util/PhotonLogger.scala:34-90, OptimizationStatesTracker.scala:82-101,
photon-client event/ emitted from Driver.scala:120-393). The JAX package's
program ledger, probes, verdicts and bench history are ROADMAP.md item 19,
step 2.
"""

from photon_ml_torch.telemetry import serving_counters
from photon_ml_torch.telemetry.journal import (
    JOURNAL_FILENAME,
    JOURNAL_PARTIAL_SUFFIX,
    RunJournal,
    json_safe,
    read_journal,
)
from photon_ml_torch.telemetry.layout import (
    LAYOUT_METRIC_PREFIX,
    record_hybrid_layout,
    reset_layout_metrics,
)
from photon_ml_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from photon_ml_torch.telemetry.tracing import (
    Tracer,
    current_tracer,
    exchange_wait_tables,
    finalize_trace,
    flush_trace_best_effort,
    gather_straggler_report,
    install_tracer,
    publish_trace,
    span,
    straggler_report,
    tracing_active,
    uninstall_tracer,
)

# solver_trace imports optim.common, which imports tracing from here: load
# it on first use
_LAZY = {
    "SolverTelemetry": "photon_ml_torch.telemetry.solver_trace",
    "lane_rows": "photon_ml_torch.telemetry.solver_trace",
    "lane_summary": "photon_ml_torch.telemetry.solver_trace",
    "solver_result_row": "photon_ml_torch.telemetry.solver_trace",
}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


__all__ = [
    "JOURNAL_FILENAME",
    "JOURNAL_PARTIAL_SUFFIX",
    "RunJournal",
    "json_safe",
    "read_journal",
    "LAYOUT_METRIC_PREFIX",
    "record_hybrid_layout",
    "reset_layout_metrics",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "SolverTelemetry",
    "lane_rows",
    "lane_summary",
    "solver_result_row",
    "Tracer",
    "current_tracer",
    "exchange_wait_tables",
    "finalize_trace",
    "flush_trace_best_effort",
    "gather_straggler_report",
    "install_tracer",
    "publish_trace",
    "span",
    "straggler_report",
    "tracing_active",
    "uninstall_tracer",
    "serving_counters",
]
