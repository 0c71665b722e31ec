"""Converged-lane scheduling for lane-batched random-effect solves.

Counterpart of ``photon_ml_tpu/algorithm/lane_scheduler.py``; reference
photon-api algorithm/RandomEffectCoordinate.scala:104-153, whose per-entity
solves are independent Spark tasks, so each entity pays only its own
iteration count. A bucket's lanes here advance in lock-step
(``optim/lanes.py``), and every evaluation of the loop evaluates every lane
of the bucket, so a bucket pays its worst lane's iterations in work per
evaluation. The scheduler gives the work back to the lanes that need it:

1. **Probe**: every bucket solves for ``LaneSchedulerConfig.probe_iterations``
   and each lane's convergence reason is read (one host read of the
   per-lane scalars per block).
2. **Rescue**: the lanes still at MAX_ITERATIONS are compacted across
   buckets of the same (capacity, width) into blocks padded to a power of
   two (at least :data:`MIN_RESCUE_LANES`) and solved again with the
   remaining ``max_iterations - probe_iterations`` budget, warm-started from
   their probe rows; the results scatter back into the [E, d] table. The
   padding bounds the set of block shapes, which a captured form of the
   lane loops would need.
3. **Cross-sweep active sets** (with both freeze tolerances set): entities
   whose coefficient change and final gradient norm fall below them are
   frozen and skipped by later sweeps' solves (still rescored by the
   coordinate); the final sweep runs everyone. ``freeze_rows`` presets the
   set from outside (the incremental refresh, ``algorithm/refresh.py``).

The lane loops stop when every lane is done (``optim/lanes.py``), so unlike
the JAX package's vmapped while-loops a bucket's loop already ends at its
worst lane, not at ``max_iterations``; what the scheduler saves here is the
evaluations of lanes that finished early, at the price of more, smaller
loops.

Compaction runs on the device (``data/game_data.compact_lane_blocks``:
``index_select`` over the resident bucket tensors), with values equal to the
JAX package's numpy compaction bit for bit; the host holds each bucket's
``entity_rows`` only (read once) and the per-lane scalars of each solve.

Over ranks: the JAX package's SPMD mode allgathers the per-lane flags so
that every rank runs one global program. In the port each rank solves its
own lanes with no collective (``parallel/distributed.py``), so each rank's
scheduler compacts its own stragglers and no collective sits inside the
scheduled solve; the solved table rows are shared afterwards exactly as
without a scheduler (``MeshLayout.share``).
"""

from __future__ import annotations

import dataclasses
import logging
from functools import partial
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import (
    _bucket_offsets,
    _gather_cells,
    _gather_rows,
    _mask_padding_lanes,
    _scatter_cells,
    _scatter_rows,
    _solve_bucket_entities,
    _with_scratch_column,
)
from photon_ml_torch.data.game_data import compact_lane_blocks
from photon_ml_torch.optim.common import ConvergenceReason, LaneTrace
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig, OptimizerConfig, OptimizerType
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.telemetry import tracing
from photon_ml_torch.telemetry.program_ledger import ledger_call
from photon_ml_torch.telemetry.registry import default_registry
from photon_ml_torch.telemetry.solver_trace import LANE_ITERS_METRIC

logger = logging.getLogger(__name__)

#: entity_rows of compacted padding lanes: out of range for any table
SENTINEL_ROW = np.iinfo(np.int32).max

#: rescue blocks are padded to at least this many lanes, bounding the
#: distinct block shapes at log2(E) per (cap, d) group
MIN_RESCUE_LANES = 8

#: registry namespace of the scheduler counters
SCHEDULER_METRIC_PREFIX = "scheduler/"



def _pow2_lanes(m: int) -> int:
    return 1 << (max(m, MIN_RESCUE_LANES) - 1).bit_length()


@dataclasses.dataclass
class SchedulerStats:
    """Per-sweep scheduling outcome of one coordinate's bucket set."""

    lanes_total: int = 0  # valid (non-padding) lanes across all buckets
    lanes_probed: int = 0  # lanes actually solved this sweep
    lanes_rescued: int = 0  # probed lanes re-run with the remaining budget
    lanes_frozen_skipped: int = 0  # lanes skipped by the active set
    lanes_newly_frozen: int = 0
    rescue_blocks: int = 0

    def merge(self, other: "SchedulerStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


# -- block solvers -------------------------------------------------------------
# One per projector, on the coordinate's bucket solves, with two extra
# per-lane outputs: the coefficient change and norm (the freeze inputs).


def _finish(objective, opt, b, full_offsets, w0s, num_rows):
    offsets = _bucket_offsets(b["sample_rows"], full_offsets)
    solved, trace = _solve_bucket_entities(objective, opt, b["features"], b["labels"],
                                           b["weights"], offsets, w0s)
    trace = _mask_padding_lanes(trace, b["entity_rows"], num_rows)
    delta = torch.linalg.norm(solved - w0s, dim=-1)
    return solved, trace, delta, torch.linalg.norm(solved, dim=-1)


@partial(ledger_call, label="scheduler/solve_identity", static_argnums=(0, 1))
def block_solve_identity(objective, opt: OptimizerConfig, b: Mapping[str, torch.Tensor],
                         full_offsets: torch.Tensor, table: torch.Tensor, matrix=None):
    """(table, trace, delta, wnorm) of one block on an [E, d] table."""
    w0s = _gather_rows(table, b["entity_rows"])
    solved, trace, delta, wnorm = _finish(objective, opt, b, full_offsets, w0s, table.shape[0])
    return _scatter_rows(table, b["entity_rows"], solved), trace, delta, wnorm


@partial(ledger_call, label="scheduler/solve_indexmap", static_argnums=(0, 1))
def block_solve_indexmap(objective, opt: OptimizerConfig, b: Mapping[str, torch.Tensor],
                         full_offsets: torch.Tensor, table_ext: torch.Tensor, matrix=None):
    """One INDEX_MAP block on the [E, d+1] table with its scratch column."""
    w0s = _gather_cells(table_ext, b["entity_rows"], b["col_index"])
    solved, trace, delta, wnorm = _finish(objective, opt, b, full_offsets, w0s,
                                          table_ext.shape[0])
    table_ext = _scatter_cells(table_ext, b["entity_rows"], b["col_index"], solved)
    table_ext[:, -1] = 0.0
    return table_ext, trace, delta, wnorm


@partial(ledger_call, label="scheduler/solve_random", static_argnums=(0, 1))
def block_solve_random(objective, opt: OptimizerConfig, b: Mapping[str, torch.Tensor],
                       full_offsets: torch.Tensor, table: torch.Tensor, matrix=None):
    """One RANDOM block: warm start table[rows] @ P, back-projection P w_k."""
    w0s = _gather_rows(table, b["entity_rows"]) @ matrix
    solved, trace, delta, wnorm = _finish(objective, opt, b, full_offsets, w0s, table.shape[0])
    return _scatter_rows(table, b["entity_rows"], solved @ matrix.T), trace, delta, wnorm


@partial(ledger_call, label="scheduler/extend_scratch")
def _extend_scratch(table: torch.Tensor) -> torch.Tensor:
    """[E, d] -> [E, d+1]: the INDEX_MAP scratch column that absorbs the
    pad slots' gathers and scatters."""
    return _with_scratch_column(table)


@partial(ledger_call, label="scheduler/strip_scratch")
def _strip_scratch(table_ext: torch.Tensor) -> torch.Tensor:
    return table_ext[:, :-1]


_BLOCK_SOLVERS = {
    ProjectorType.IDENTITY: block_solve_identity,
    ProjectorType.INDEX_MAP: block_solve_indexmap,
    ProjectorType.RANDOM: block_solve_random,
}


class LaneScheduler:
    """Per-coordinate probe/rescue state, kept across sweeps: each bucket's
    host ``entity_rows`` (read once; buckets do not change across sweeps),
    the frozen active set, and the carried per-lane (value, gradient norm)
    that frozen lanes report. Create one per random-effect coordinate (on
    each rank) and reuse it every sweep."""

    def __init__(self, config: LaneSchedulerConfig, registry=None,
                 warn_no_live_stop: bool = True):
        #: False when the probe is the whole solve (the refresh: probe
        #: budget == max_iterations, no rescue), where the warning about
        #: probe flags without a live function stop does not apply
        self.config = config
        self._registry = registry
        self._warned_no_live_stop = not warn_no_live_stop
        self._rows_h: list[np.ndarray] | None = None
        #: bool [table rows]; grows until the final sweep
        self.frozen_rows: np.ndarray | None = None
        #: per-block (value, gradient_norm) carried for lanes a later sweep skips
        self._carry: list[tuple[np.ndarray, np.ndarray]] | None = None
        self.total_stats = SchedulerStats()
        self.last_stats: SchedulerStats | None = None
        self._num_rows: int | None = None

    def registry(self):
        if self._registry is None:
            self._registry = default_registry()
        return self._registry

    def freeze_rows(self, mask: np.ndarray) -> None:
        """Preset the active set: table rows True in ``mask`` are frozen; a
        ``solve(final_sweep=False)`` skips their lanes and never scatters
        into their rows, so they carry over bitwise (the refresh's entry
        point; the freeze tolerances need not be set)."""
        self.frozen_rows = np.ascontiguousarray(mask, dtype=bool).copy()

    def _host_rows(self, blocks: Sequence[Mapping[str, torch.Tensor]]) -> list[np.ndarray]:
        if self._rows_h is None:
            self._rows_h = [b["entity_rows"].cpu().numpy().astype(np.int64) for b in blocks]
        if len(self._rows_h) != len(blocks):
            raise ValueError(
                "LaneScheduler is per-coordinate state: it was built over "
                f"{len(self._rows_h)} buckets but is now asked to "
                f"schedule {len(blocks)} — create one scheduler per "
                "random-effect coordinate")
        return self._rows_h

    # -- the scheduled solve ---------------------------------------------------

    def solve(self, objective, opt: OptimizerConfig, blocks: Sequence[Mapping[str, torch.Tensor]],
              full_offsets: torch.Tensor, table: torch.Tensor, *,
              projector: ProjectorType = ProjectorType.IDENTITY,
              matrix: torch.Tensor | None = None,
              final_sweep: bool = True) -> tuple[torch.Tensor, list[LaneTrace], SchedulerStats]:
        """Probe + rescue (+ active-set skip) over one coordinate's buckets.

        blocks: bucket field dicts (features/labels/weights/sample_rows/
            entity_rows[/col_index]); ``table`` the raw [E, d] table for
            every projector (the INDEX_MAP scratch column is handled here).
        Returns (updated table, per-bucket LaneTraces on the host, stats). A
        frozen (skipped) lane reports iterations 0 with its carried value and
        gradient norm and reason FUNCTION_VALUES_WITHIN_TOLERANCE.
        """
        cfg = self.config
        stats = SchedulerStats()
        if not blocks:
            self.last_stats = stats
            return table, [], stats
        if (opt.rel_function_tolerance is None
                and opt.optimizer_type in (OptimizerType.LBFGS, OptimizerType.OWLQN)
                and not self._warned_no_live_stop):
            self._warned_no_live_stop = True
            logger.warning(
                "lane scheduler active with optimizer_type=%s but no "
                "rel_function_tolerance: probe convergence flags rarely fire "
                "at the plain tolerance for warm starts, so most lanes will "
                "be rescued anyway — set rel_function_tolerance (e.g. 1e-6) "
                "to get the probe/rescue win", opt.optimizer_type.name)

        indexmap = projector == ProjectorType.INDEX_MAP
        if indexmap:
            table = _extend_scratch(table)
        num_rows = int(table.shape[0])
        if self._num_rows is None:
            self._num_rows = num_rows
        elif self._num_rows != num_rows:
            raise ValueError(
                "LaneScheduler is per-coordinate state: it was built over a "
                f"{self._num_rows}-row coefficient table but is now asked to "
                f"schedule a {num_rows}-row one — create one scheduler per "
                "random-effect coordinate")

        probe_iters = max(1, min(cfg.probe_iterations, opt.max_iterations))
        rescue_budget = opt.max_iterations - probe_iters
        base_opt = dataclasses.replace(opt, scheduler=None)
        probe_opt = dataclasses.replace(base_opt, max_iterations=probe_iters)
        rescue_opt = (dataclasses.replace(base_opt, max_iterations=rescue_budget)
                      if rescue_budget > 0 else None)
        block_solve = _BLOCK_SOLVERS[projector]

        freezing = cfg.freezes
        frozen = self.frozen_rows
        if freezing and frozen is None:
            frozen = np.zeros(num_rows, dtype=bool)
        # a preset active set (freeze_rows) skips even with the tolerances off
        skipping = freezing or frozen is not None
        if frozen is not None and len(frozen) != num_rows:
            raise ValueError(
                f"frozen-row mask covers {len(frozen)} rows but the "
                f"coefficient table has {num_rows} — freeze_rows() masks "
                "must match the coordinate's table")

        rows_h = self._host_rows(blocks)
        valid_h = [(r >= 0) & (r < num_rows) for r in rows_h]
        if skipping and not final_sweep and frozen.any():
            skip_h = [v & frozen[np.clip(r, 0, num_rows - 1)] for r, v in zip(rows_h, valid_h)]
        else:
            skip_h = [np.zeros(len(r), dtype=bool) for r in rows_h]
        solve_h = [v & ~s for v, s in zip(valid_h, skip_h)]
        stats.lanes_total = int(sum(v.sum() for v in valid_h))
        stats.lanes_frozen_skipped = int(sum(s.sum() for s in skip_h))

        e_sizes = [len(r) for r in rows_h]
        iters_out = [np.zeros(e, np.int64) for e in e_sizes]
        reason_out = [np.full(e, int(ConvergenceReason.FUNCTION_VALUES_WITHIN_TOLERANCE),
                              np.int64) for e in e_sizes]
        value_out = [np.zeros(e, np.float64) for e in e_sizes]
        gnorm_out = [np.zeros(e, np.float64) for e in e_sizes]
        delta_out = [np.zeros(e, np.float64) for e in e_sizes]
        wnorm_out = [np.zeros(e, np.float64) for e in e_sizes]
        if self._carry is not None:
            for i, (cv, cg) in enumerate(self._carry):
                value_out[i][:] = cv
                gnorm_out[i][:] = cg

        def scatter_back(trace, delta, wnorm, blk, lane):
            """Write one solved block's per-lane scalars (one host read) into
            the per-bucket outputs; (blk, lane) name each real lane's source,
            padding lanes carry blk -1. Iterations and deltas add (probe +
            rescue), the rest overwrite."""
            host = torch.stack([t.to(torch.float64) for t in (
                trace.iterations, trace.reason, trace.value, trace.gradient_norm, delta,
                wnorm)]).cpu().numpy()
            it, rs = host[0].astype(np.int64), host[1].astype(np.int64)
            vl, gn, dl, wn = host[2], host[3], host[4], host[5]
            for i in range(len(blocks)):
                mask = blk == i
                if not mask.any():
                    continue
                li = lane[mask]
                iters_out[i][li] += it[mask]
                reason_out[i][li] = rs[mask]
                value_out[i][li] = vl[mask]
                gnorm_out[i][li] = gn[mask]
                delta_out[i][li] += dl[mask]
                wnorm_out[i][li] = wn[mask]

        def run_compacted(lane_masks, o: OptimizerConfig, tab):
            """Solve only the masked lanes, grouped by (cap, d). Returns
            (table, lanes solved, blocks run)."""
            solved = n_blocks = 0
            for picks in _group_by_shape(blocks, lane_masks):
                pad_to = _pow2_lanes(sum(len(l) for _, l in picks))
                with tracing.span("scheduler/compaction", cat="scheduler",
                                  lanes=int(sum(len(l) for _, l in picks))):
                    fields, src_blk, src_lane = compact_lane_blocks(
                        blocks, picks, pad_to=pad_to, sentinel_row=SENTINEL_ROW)
                tab, trace, delta, wnorm = block_solve(objective, o, fields, full_offsets, tab,
                                                       matrix)
                scatter_back(trace, delta, wnorm, _pad_minus1(src_blk, pad_to),
                             _pad_zeros(src_lane, pad_to))
                solved += len(src_lane)
                n_blocks += 1
            return tab, solved, n_blocks

        # -- probe phase --------------------------------------------------------
        with tracing.span("scheduler/probe", cat="scheduler", lanes=stats.lanes_total,
                          frozen_skipped=stats.lanes_frozen_skipped):
            if not any(s.any() for s in skip_h):
                # whole buckets, original shapes: the unscheduled path's blocks
                for i, b in enumerate(blocks):
                    table, trace, delta, wnorm = block_solve(objective, probe_opt, b,
                                                             full_offsets, table, matrix)
                    blk = np.where(solve_h[i], i, -1).astype(np.int32)
                    scatter_back(trace, delta, wnorm, blk,
                                 np.arange(e_sizes[i], dtype=np.int64))
                stats.lanes_probed = int(sum(s.sum() for s in solve_h))
            else:
                # active-set compaction: only unfrozen lanes probe
                table, stats.lanes_probed, _ = run_compacted(solve_h, probe_opt, table)

        # -- rescue phase -------------------------------------------------------
        rescue_h = [s & (r_out == int(ConvergenceReason.MAX_ITERATIONS))
                    for s, r_out in zip(solve_h, reason_out)]
        n_rescue = int(sum(r.sum() for r in rescue_h))
        if rescue_opt is not None and n_rescue:
            with tracing.span("scheduler/rescue", cat="scheduler", lanes=n_rescue):
                table, _, rescue_blocks = run_compacted(rescue_h, rescue_opt, table)
            stats.rescue_blocks += rescue_blocks
            stats.lanes_rescued = n_rescue

        # -- active-set update --------------------------------------------------
        if freezing and not final_sweep:
            ftol = cfg.freeze_coefficient_tolerance
            gtol = cfg.freeze_gradient_tolerance
            for i in range(len(blocks)):
                quiet = (solve_h[i] & (delta_out[i] <= ftol * (1.0 + wnorm_out[i]))
                         & (gnorm_out[i] <= gtol))
                if quiet.any():
                    frozen[rows_h[i][quiet]] = True
                    stats.lanes_newly_frozen += int(quiet.sum())
            self.frozen_rows = frozen
        if final_sweep:
            # the active set does not outlive its training run
            self.frozen_rows = None

        self._carry = [(value_out[i].copy(), gnorm_out[i].copy()) for i in range(len(blocks))]
        traces = [
            LaneTrace(iterations=torch.from_numpy(iters_out[i].astype(np.int32)),
                      reason=torch.from_numpy(reason_out[i].astype(np.int32)),
                      value=torch.from_numpy(value_out[i]),
                      gradient_norm=torch.from_numpy(gnorm_out[i]),
                      valid=torch.from_numpy(valid_h[i]), scheduled=True)
            for i in range(len(blocks))]
        self._record(stats, traces)
        self.last_stats = stats
        self.total_stats.merge(stats)
        if indexmap:
            table = _strip_scratch(table)
        return table, traces, stats

    def _record(self, stats: SchedulerStats, traces: Sequence[LaneTrace]) -> None:
        """The ``scheduler/*`` counters and the per-lane iteration histogram."""
        reg = self.registry()
        p = SCHEDULER_METRIC_PREFIX
        reg.counter(p + "sweeps").inc()
        reg.counter(p + "lanes_probed").inc(stats.lanes_probed)
        reg.counter(p + "lanes_rescued").inc(stats.lanes_rescued)
        reg.counter(p + "lanes_frozen_skipped").inc(stats.lanes_frozen_skipped)
        reg.counter(p + "rescue_blocks").inc(stats.rescue_blocks)
        if self.frozen_rows is not None:
            reg.gauge(p + "frozen_rows").set(int(self.frozen_rows.sum()))
        hist = reg.histogram(LANE_ITERS_METRIC)
        for t in traces:
            hist.observe_many(t.iterations[t.valid].tolist())


def make_schedulers(re_specs) -> dict:
    """One LaneScheduler per RE spec whose OptimizerConfig carries a
    scheduler config; the rule ``train_distributed`` and
    ``train_partitioned`` share. Every rank builds its own (rank-local
    compaction, no collective)."""
    return {s.re_type: LaneScheduler(s.optimizer.scheduler)
            for s in re_specs if s.optimizer.scheduler is not None}


def _pad_minus1(arr: np.ndarray, length: int) -> np.ndarray:
    out = np.full(length, -1, np.int32)
    out[: len(arr)] = arr
    return out


def _pad_zeros(arr: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros(length, np.int64)
    out[: len(arr)] = arr
    return out


def _group_by_shape(blocks: Sequence[Mapping[str, torch.Tensor]],
                    lane_masks: Sequence[np.ndarray]) -> list[list[tuple[int, np.ndarray]]]:
    """Selected (block, lanes) picks grouped by (capacity, feature width), so
    each compacted block mixes only shape-compatible lanes."""
    groups: dict[tuple[int, int], list[tuple[int, np.ndarray]]] = {}
    for i, mask in enumerate(lane_masks):
        lanes = np.flatnonzero(mask)
        if not len(lanes):
            continue
        f = blocks[i]["features"]
        groups.setdefault((int(f.shape[1]), int(f.shape[2])), []).append((i, lanes))
    return list(groups.values())
