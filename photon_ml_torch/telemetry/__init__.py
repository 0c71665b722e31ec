"""Structured run telemetry (the port's own copies): the metrics registry,
the JSONL run journal, span tracing, solver convergence telemetry, the
counters the I/O, streaming, resilience, layout, serving and refresh layers
feed, the device and compile probes, the program ledger, and the verdicts
and bench history that judge a run.

Counterpart of ``photon_ml_tpu/telemetry``; reference the PhotonLogger /
OptimizationStatesTracker / PhotonOptimizationLogEvent triple (photon-lib
util/PhotonLogger.scala:34-90, OptimizationStatesTracker.scala:82-101,
photon-client event/ emitted from Driver.scala:120-393). The ledger and the
probes keep the JAX package's names (``jax/backend_compile_count``,
``xla/<label>/...``); in the port a compile is a kernel or host-library build
or a CUDA graph capture.
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
from photon_ml_torch.telemetry.probes import (
    GATE_REPS,
    CompileMonitor,
    MarginalResult,
    MarginalTimer,
    compile_count,
    install_compile_listener,
    live_buffer_bytes,
    median_spread,
    read_scalar,
    scan_step_marginal,
    stream_calibration,
)
from photon_ml_torch.telemetry.program_ledger import (
    ProgramLedger,
    current_ledger,
    install_ledger,
    ledger_active,
    ledger_call,
    uninstall_ledger,
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
    "GATE_REPS",
    "CompileMonitor",
    "MarginalResult",
    "MarginalTimer",
    "compile_count",
    "install_compile_listener",
    "live_buffer_bytes",
    "median_spread",
    "read_scalar",
    "scan_step_marginal",
    "stream_calibration",
    "ProgramLedger",
    "current_ledger",
    "install_ledger",
    "ledger_active",
    "ledger_call",
    "uninstall_ledger",
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
