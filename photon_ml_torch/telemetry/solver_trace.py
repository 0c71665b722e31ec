"""Solver telemetry: SolverResult and lane traces -> events, journal rows
and registry metrics (the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/solver_trace.py``; reference
photon-client event/PhotonOptimizationLogEvent (emitted from
Driver.scala:120-393) and photon-lib OptimizationStatesTracker.scala:82-101.

- one single-vector solve (a fixed-effect coordinate, a sequential
  ``train_glm`` λ) → one ``convergence`` row: iterations, reason, value,
  gradient norm and the trimmed value history;
- lane solves (λ-grid lanes, random-effect buckets) → per-lane rows
  (capped) and a ``convergence_lanes`` tally of reasons across lanes.

Each record is read to the host once a solve, never once an iteration, and
only when a sink would consume it. The sinks are a RunJournal, an
EventEmitter and a MetricsRegistry, each optional.
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch.optim.common import (
    ConvergenceReason,
    LaneResult,
    LaneTrace,
    LaneTraces,
    SolverResult,
    lane_trace_of,
)
from photon_ml_torch.util.events import EventEmitter, OptimizationLogEvent

#: per-lane rows written to the journal before falling back to tally-only
MAX_LANE_ROWS = 128

#: registry namespace for solver convergence metrics
SOLVER_METRIC_PREFIX = "solver/"

#: the cross-coordinate per-lane iteration histogram, fed here for lane
#: traces and by the lane scheduler (``algorithm/lane_scheduler.py``)
LANE_ITERS_METRIC = "solver/lane_iters"


def reset_solver_metrics(registry=None) -> None:
    """Drop the per-run ``solver/*`` and ``scheduler/*`` metrics (drivers
    call it at run start)."""
    from photon_ml_torch.telemetry.registry import default_registry

    reg = registry or default_registry()
    reg.remove_prefix(SOLVER_METRIC_PREFIX)
    reg.remove_prefix("scheduler/")


def _reason_name(code) -> str:
    try:
        return ConvergenceReason(int(code)).name
    except ValueError:
        return f"UNKNOWN_{int(code)}"


def solver_result_row(result: SolverResult, *, max_history: int = 64) -> dict:
    """One journal-ready dict from a single-vector SolverResult (one host
    transfer for the value, the gradient norm and the history)."""
    iterations = int(result.iterations)
    host = torch.cat([result.value.detach().reshape(1).double(),
                      result.gradient_norm.detach().reshape(1).double(),
                      result.value_history.detach().double()]).cpu().numpy()
    values = host[2:]
    history = [float(v) for v in values[: min(iterations + 1, max_history, len(values))]
               if np.isfinite(v)]
    return {
        "iterations": iterations,
        "reason": _reason_name(result.reason),
        "converged": bool(result.converged),
        "value": float(host[0]),
        "gradient_norm": float(host[1]),
        "value_history": history,
    }


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _as_host_trace(trace) -> LaneTrace:
    """One LaneTrace of host numpy arrays: each field read once (the
    per-bucket traces of a LaneTraces merge here, in numpy). Takes a
    LaneTrace, a LaneTraces or a lane-batched LaneResult."""
    if isinstance(trace, LaneResult):
        trace = lane_trace_of(trace)
    parts = trace.buckets if isinstance(trace, LaneTraces) else (trace,)
    fields = ("iterations", "reason", "value", "gradient_norm", "valid")
    merged = {f: np.concatenate([_numpy(getattr(t, f)) for t in parts]) for f in fields}
    return LaneTrace(**merged, scheduled=any(t.scheduled for t in parts))


def lane_summary(trace) -> dict:
    """Convergence-reason tallies and iteration statistics across lanes."""
    trace = _as_host_trace(trace)
    valid = np.asarray(trace.valid).astype(bool)
    iterations = np.asarray(trace.iterations)[valid]
    reasons = np.asarray(trace.reason)[valid]
    values = np.asarray(trace.value)[valid]
    n = int(valid.sum())
    if n == 0:
        return {"num_lanes": 0, "reasons": {}, "lanes_at_max_iterations": 0}
    codes, counts = np.unique(reasons, return_counts=True)
    tallies = {_reason_name(c): int(k) for c, k in zip(codes, counts)}
    return {
        "num_lanes": n,
        "iterations_min": int(iterations.min()),
        "iterations_mean": float(iterations.mean()),
        "iterations_max": int(iterations.max()),
        "iterations_total": int(iterations.sum()),
        "reasons": tallies,
        "lanes_at_max_iterations": int((reasons == int(ConvergenceReason.MAX_ITERATIONS)).sum()),
        "lanes_not_converged": int((reasons == int(ConvergenceReason.NOT_CONVERGED)).sum()),
        "value_mean": float(values.mean()),
        "value_max": float(values.max()),
    }


def lane_rows(trace, keys=None, limit: int = MAX_LANE_ROWS):
    """Per-lane convergence dicts (valid lanes only), ``keys[i]`` merged in
    when given (e.g. ``{"lambda": 0.1}`` per λ-grid lane)."""
    trace = _as_host_trace(trace)
    valid = np.asarray(trace.valid).astype(bool)
    iterations = np.asarray(trace.iterations)
    reasons = np.asarray(trace.reason)
    values = np.asarray(trace.value)
    grads = np.asarray(trace.gradient_norm)
    rows = []
    for i in np.flatnonzero(valid)[:limit]:
        row = {
            "lane": int(i),
            "iterations": int(iterations[i]),
            "reason": _reason_name(reasons[i]),
            "value": float(values[i]),
            "gradient_norm": float(grads[i]),
        }
        if keys is not None and i < len(keys):
            key = keys[i]
            row.update(key if isinstance(key, dict) else {"key": key})
        rows.append(row)
    return rows


class SolverTelemetry:
    """Fan-out sink for solver and coordinate convergence telemetry.

    ``journal``/``emitter``/``registry`` are each optional; drivers build
    one and thread it through the estimators into the coordinate-descent
    loop and the GLM training paths.
    """

    def __init__(self, journal=None, emitter: EventEmitter | None = None, registry=None,
                 max_lane_rows: int = MAX_LANE_ROWS):
        self.journal = journal
        self.emitter = emitter
        self.registry = registry
        self.max_lane_rows = max_lane_rows

    def _has_sink(self) -> bool:
        """False when no sink would consume a record: building rows costs
        host reads of device tensors, so producers skip the work when the
        journal is absent or inert, the registry is absent and no listener
        is registered."""
        if self.journal is not None and getattr(self.journal, "active", True):
            return True
        if self.registry is not None:
            return True
        return self.emitter is not None and self.emitter.has_listeners

    def _journal(self, kind: str, row: dict) -> None:
        if self.journal is not None:
            self.journal.record(kind, **row)

    def heartbeat(self, stage: str, **cursor) -> None:
        """A liveness row at a sweep, epoch or λ boundary: the progress
        cursor and the registry's counter deltas. Inert without an active
        journal."""
        if self.journal is None or not getattr(self.journal, "active", False):
            return
        self.journal.heartbeat(registry=self.registry, stage=stage, **cursor)

    def _emit(self, coordinate_id: str, iteration: int, metrics: dict) -> None:
        if self.emitter is not None:
            self.emitter.send(OptimizationLogEvent(coordinate_id=coordinate_id,
                                                   iteration=iteration, metrics=metrics))

    def _count(self, coordinate_id: str, iterations: int, converged: bool) -> None:
        if self.registry is None:
            return
        self.registry.histogram(f"{SOLVER_METRIC_PREFIX}{coordinate_id}/iterations").observe(
            iterations)
        self.registry.counter(f"{SOLVER_METRIC_PREFIX}{coordinate_id}/solves").inc()
        if not converged:
            self.registry.counter(f"{SOLVER_METRIC_PREFIX}{coordinate_id}/not_converged").inc()

    def record_solve(self, coordinate_id: str, result: SolverResult, *,
                     outer_iteration: int = 0, extra: dict | None = None) -> dict:
        """One single-vector solve (FE coordinate, sequential λ step)."""
        if not self._has_sink():
            return {}
        row = solver_result_row(result)
        row.update(extra or {})
        row.update(coordinate=coordinate_id, outer_iteration=outer_iteration)
        self._journal("convergence", row)
        self._emit(coordinate_id, outer_iteration, row)
        self._count(coordinate_id, row["iterations"], row["converged"])
        return row

    def record_lanes(self, coordinate_id: str, trace, *, outer_iteration: int = 0, keys=None,
                     extra: dict | None = None) -> dict:
        """Lane solves (λ grid, RE buckets): per-lane rows + reason tally."""
        if not self._has_sink():
            return {}
        trace = _as_host_trace(trace)  # one read feeds the summary and the rows
        summary = lane_summary(trace)
        summary.update(extra or {})
        summary.update(coordinate=coordinate_id, outer_iteration=outer_iteration)
        for row in lane_rows(trace, keys=keys, limit=self.max_lane_rows):
            row.update(coordinate=coordinate_id, outer_iteration=outer_iteration)
            self._journal("convergence", row)
        self._journal("convergence_lanes", summary)
        self._emit(coordinate_id, outer_iteration, summary)
        if self.registry is not None and summary.get("num_lanes", 0) > 0:
            self.registry.histogram(f"{SOLVER_METRIC_PREFIX}{coordinate_id}/iterations").observe(
                summary["iterations_mean"])
            # the scheduler already observed the lanes of its own traces
            if not trace.scheduled:
                valid = np.asarray(trace.valid).astype(bool)
                self.registry.histogram(LANE_ITERS_METRIC).observe_many(
                    np.asarray(trace.iterations)[valid].tolist())
            self.registry.counter(f"{SOLVER_METRIC_PREFIX}{coordinate_id}/solves").inc(
                summary["num_lanes"])
            self.registry.counter(
                f"{SOLVER_METRIC_PREFIX}{coordinate_id}/lanes_at_max_iterations").inc(
                summary["lanes_at_max_iterations"])
        return summary

    def record_coordinate(self, coordinate_id: str, outer_iteration: int, info, *,
                          metrics: dict | None = None) -> None:
        """The block-coordinate-descent hook: dispatches on what a
        coordinate's update returned (a SolverResult for the fixed effect,
        lane traces for random-effect buckets, None for locked or MF)."""
        if not self._has_sink():
            return
        extra = {"evaluation": metrics} if metrics else None
        if isinstance(info, SolverResult):
            self.record_solve(coordinate_id, info, outer_iteration=outer_iteration, extra=extra)
        elif isinstance(info, (LaneTrace, LaneTraces)):
            self.record_lanes(coordinate_id, info, outer_iteration=outer_iteration, extra=extra)
        elif metrics:
            row = dict(coordinate=coordinate_id, outer_iteration=outer_iteration,
                       evaluation=metrics)
            self._journal("coordinate_update", row)
            self._emit(coordinate_id, outer_iteration, row)
