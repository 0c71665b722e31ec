"""Out-of-core GAME training: streamed coordinate-descent sweeps, with an
optional DuHL importance-ordered chunk schedule.

Counterpart of ``photon_ml_tpu/algorithm/streaming_game.py`` (reference
photon-lib algorithm/CoordinateDescent.scala:198-255, re-run chunk by
chunk; the DuHL working set is Duenner et al., arXiv:1702.07005, at chunk
granularity).

- **Per-sample scalars stay on the host; features stream.** The program
  keeps ``[n]`` numpy score vectors (one per coordinate), labels, weights,
  base offsets and entity indices. A feature block exists on the card one
  chunk at a time.
- **Entity-clustered chunks make the RE solves exact.** The chunk plan
  (``io/stream_reader.plan_entity_chunks``) packs whole entities into each
  chunk, so a chunk's per-entity bucket solves see the blocks the in-core
  path builds. Every RE type is checked before training; an entity that
  spans chunks fails at once.
- **The FE coordinate streams through** ``algorithm/streaming
  .StreamingGLMObjective``: the residual offsets overlay the chunk's
  offsets on the host, and every evaluation is one chunked epoch (on the
  card, the fused kernel B1 and its reduce on each chunk).
- **DuHL schedule (opt-in).** :class:`DuHLChunkSchedule` keeps a budget of
  the chunks with the largest importance pinned (their decoded host chunks
  cached, so FE epochs and RE solves skip the decoder), visits a few cold
  chunks round-robin, and re-ranks every sweep from the per-chunk sums of
  coefficient movement and final gradient norm that the bucket solves
  return. ``schedule=None`` is bitwise :class:`UniformChunkSchedule`.
- **Several ranks** (``partition=`` from ``io/stream_reader
  .plan_partitioned_game_stream``, with its ``exchange``): each rank
  streams its own whole chunks; the FE accumulators sum across ranks in
  rank order every epoch; after each sweep the ranks exchange the table
  rows they solved (:meth:`StreamingGameProgram._sync_re_tables`) and one
  allgathered importance signal drives the one global schedule, so every
  rank pins and evicts the same chunks.
- **Resume.** Sweep checkpoints go through ``io/checkpoint
  .commit_checkpoint`` (rank 0 writes, between exchange barriers when an
  exchange is attached); the fingerprint pins the chunk plan and the
  schedule, and the scores are recomputed from the restored tables through
  the same per-chunk steps, so a resumed run continues bitwise.

The JAX package's single-process multi-device ``mesh=`` has no counterpart:
several ranks are several processes (``partition=``). A random-effect spec
whose optimizer carries a lane scheduler solves each chunk's buckets through
one ``algorithm/lane_scheduler.LaneScheduler`` per (RE type, chunk), kept
across sweeps. The sweeps, chunk solves and exchanges record spans (``telemetry/tracing.py``),
and each train's chunk loads, visits and sweeps land in
``telemetry/stream_counters.py``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import (
    _gather_rows,
    _mask_padding_lanes,
    _scatter_rows,
    _solve_bucket_entities,
)
from photon_ml_torch.algorithm.streaming import StreamingGLMObjective, _pack_f64, _unpack_f64
from photon_ml_torch.data.batch import device_tensor
from photon_ml_torch.data.game_data import group_entities_into_buckets, pack_bucket_lanes
from photon_ml_torch.device import resolve_device
from photon_ml_torch.io.checkpoint import (
    DivergenceError,
    commit_checkpoint,
    fingerprint_mismatch,
    host_array,
)
from photon_ml_torch.io.partitioned_reader import _pack_i64, _unpack_i64
from photon_ml_torch.io.stream_reader import (
    DEFAULT_CHUNK_TIMEOUT,
    ChunkPrefetcher,
    ChunkSpec,
    DenseChunk,
    GameChunk,
    entities_spanning_chunks,
)
from photon_ml_torch.models.game import score_random_effect
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.optimizer import OptimizerConfig, resolve_auto_optimizer, solve
from photon_ml_torch.parallel.distributed import (
    FixedEffectStepSpec,
    GameTrainState,
    RandomEffectStepSpec,
)
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.resilience import recovery
from photon_ml_torch.telemetry import stream_counters, tracing
from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)

#: default entity size buckets, those of ``build_random_effect_dataset``, so
#: a chunk's entity blocks take the in-core path's capacities
DEFAULT_BUCKET_SIZES = (8, 32, 128, 512, 2048)

#: the parts of a sweep's seconds that :attr:`StreamingGameProgram.timings` sums
SWEEP_PARTS = ("fe_solve", "fe_decode", "fe_wait", "fe_copy", "fe_accumulate", "fe_exchange",
               "fe_refresh", "re_load", "re_solve", "re_sync", "loss", "fe_epochs",
               "fe_bytes")


def _fe_margin_chunk(w: torch.Tensor, features: torch.Tensor, objective: GLMObjective
                     ) -> torch.Tensor:
    """The pure FE margin of one chunk (no offsets) from normalized-space
    coefficients."""
    norm = objective.normalization
    eff = norm.effective_coefficients(w)
    return features.to(eff.dtype) @ eff - norm.margin_shift(eff)


def _solve_re_chunk_bucket(table: torch.Tensor, batch: dict, objective: GLMObjective,
                           opt: OptimizerConfig):
    """Solve one chunk-local entity bucket and write it into the [E, d]
    table. ``batch``: features [e, cap, d], labels/weights/offsets [e, cap],
    entity_rows [e] (global vocabulary rows; padding lanes carry the
    out-of-range sentinel E). Returns (table, per-lane trace, per-lane
    coefficient movement ‖Δw‖), the last two the DuHL importance signal."""
    w0 = _gather_rows(table, batch["entity_rows"])
    solved, trace = _solve_bucket_entities(objective, opt, batch["features"], batch["labels"],
                                           batch["weights"], batch["offsets"], w0)
    trace = _mask_padding_lanes(trace, batch["entity_rows"], table.shape[0])
    movement = torch.sqrt(torch.sum((solved - w0) ** 2, dim=-1))
    return _scatter_rows(table, batch["entity_rows"], solved), trace, movement


# ---------------------------------------------------------------------------
# Chunk schedules
# ---------------------------------------------------------------------------


class UniformChunkSchedule:
    """Every chunk, every sweep, in plan order; pins nothing. Bitwise
    ``schedule=None``."""

    mode = "uniform"

    def __init__(self, num_chunks: int):
        self.num_chunks = int(num_chunks)

    def plan_sweep(self) -> list[int]:
        return list(range(self.num_chunks))

    def pinned(self) -> "set[int]":
        return set()

    def record(self, chunk: int, importance: float) -> None:
        pass

    def sweep_done(self) -> None:
        pass

    def state_dict(self) -> dict:
        return {"mode": self.mode}

    def load_state(self, state: dict) -> None:
        pass

    def fingerprint(self) -> dict:
        return {"schedule": self.mode}


@dataclasses.dataclass(frozen=True)
class DuHLScheduleConfig:
    """The DuHL working-set budget: ``working_set_chunks`` chunks of the
    largest importance stay pinned and are solved every sweep;
    ``tail_chunks_per_sweep`` cold chunks rotate in round-robin.
    ``warmup_sweeps`` full sweeps come first: the importance is coefficient
    movement, large everywhere on the first solve."""

    working_set_chunks: int
    tail_chunks_per_sweep: int = 1
    warmup_sweeps: int = 2

    def __post_init__(self):
        if self.working_set_chunks < 1:
            raise ValueError("working_set_chunks must be >= 1")
        if self.tail_chunks_per_sweep < 1:
            raise ValueError("tail_chunks_per_sweep must be >= 1")
        if self.warmup_sweeps < 1:
            raise ValueError("warmup_sweeps must be >= 1")


class DuHLChunkSchedule:
    """Importance-ordered chunk schedule: ``warmup_sweeps`` sweeps visit
    every chunk; later sweeps visit the top ``B`` chunks by importance plus
    the next ``t`` cold chunks round-robin. Importance is a chunk's sum over
    its valid lanes of coefficient movement plus final gradient norm."""

    mode = "duhl"

    def __init__(self, config: DuHLScheduleConfig, num_chunks: int):
        self.config = config
        self.num_chunks = int(num_chunks)
        self.importance = np.zeros(self.num_chunks, dtype=np.float64)
        self.cursor = 0
        self.sweeps_done = 0

    def _working_set(self) -> "list[int]":
        b = min(self.config.working_set_chunks, self.num_chunks)
        # a stable sort breaks ties by chunk index: a resume replays the plan
        return [int(c) for c in np.argsort(-self.importance, kind="stable")[:b]]

    def plan_sweep(self) -> list[int]:
        if self.sweeps_done < self.config.warmup_sweeps:
            return list(range(self.num_chunks))
        visit = set(self._working_set())
        tail = [c for c in range(self.num_chunks) if c not in visit]
        for _ in range(min(self.config.tail_chunks_per_sweep, len(tail))):
            visit.add(tail[self.cursor % len(tail)])
            self.cursor += 1
        return sorted(visit)

    def pinned(self) -> "set[int]":
        if self.sweeps_done < self.config.warmup_sweeps:
            return set()
        return set(self._working_set())

    def record(self, chunk: int, importance: float) -> None:
        self.importance[chunk] = float(importance)

    def sweep_done(self) -> None:
        self.sweeps_done += 1

    def state_dict(self) -> dict:
        return {"mode": self.mode, "importance": [float(x) for x in self.importance],
                "cursor": int(self.cursor), "sweeps_done": int(self.sweeps_done)}

    def load_state(self, state: dict) -> None:
        if state.get("mode") != self.mode:
            raise ValueError(f"schedule state holds mode {state.get('mode')!r}, this run is "
                             f"{self.mode!r}")
        self.importance = np.asarray(state["importance"], dtype=np.float64)
        self.cursor = int(state["cursor"])
        self.sweeps_done = int(state["sweeps_done"])

    def fingerprint(self) -> dict:
        return {"schedule": self.mode,
                "working_set_chunks": int(self.config.working_set_chunks),
                "tail_chunks_per_sweep": int(self.config.tail_chunks_per_sweep),
                "warmup_sweeps": int(self.config.warmup_sweeps)}


# ---------------------------------------------------------------------------
# The working-set cache and the FE view of the stream
# ---------------------------------------------------------------------------


class _ChunkCache:
    """Load-through cache over a GAME chunk source that keeps only pinned
    chunks (the DuHL working set), as host arrays: a pinned chunk's FE
    epochs and RE solves skip the decoder but still copy its block to the
    card, so the working-set budget never holds device memory. ``loads``
    counts source decodes and ``load_seconds`` their time; :meth:`nbytes`
    is what the cache holds. Thread-safe: the FE prefetcher's thread loads
    through it."""

    def __init__(self, source):
        self.source = source
        self.loads = 0
        self.load_seconds = 0.0
        self._store: dict[int, GameChunk] = {}
        self._pinned: "set[int]" = set()
        self._lock = threading.Lock()

    def get(self, index: int) -> GameChunk:
        with self._lock:
            cached = self._store.get(index)
        if cached is not None:
            return cached
        t0 = time.perf_counter()
        chunk = self.source.load(self.source.specs[index])
        with self._lock:
            self.loads += 1
            self.load_seconds += time.perf_counter() - t0
            if index in self._pinned:
                self._store[index] = chunk
        return chunk

    def set_pinned(self, pinned: "set[int]") -> None:
        with self._lock:
            self._pinned = set(pinned)
            for idx in list(self._store):
                if idx not in self._pinned:
                    del self._store[idx]

    def nbytes(self) -> int:
        with self._lock:
            return int(sum(c.nbytes for c in self._store.values()))


class _FixedEffectChunkView:
    """The FE coordinate's view of the GAME stream: a dense chunk source whose
    every load replaces the chunk's offsets by the current residual (base
    offsets plus the other coordinates' scores) on the host, so
    ``StreamingGLMObjective`` runs the FE solve unchanged."""

    sparse = False

    def __init__(self, cache: _ChunkCache, shard: str, residual: np.ndarray):
        self._cache = cache
        self._shard = shard
        self._residual = residual
        src = cache.source
        self.specs: "list[ChunkSpec]" = src.specs
        self.chunk_rows = src.chunk_rows
        self.dim = src.dims[shard]
        self.dtype = np.dtype(src.dtype)

    @property
    def num_chunks(self) -> int:
        return len(self.specs)

    @property
    def total_records(self) -> int:
        return int(sum(s.num_records for s in self.specs))

    def load(self, spec: ChunkSpec) -> DenseChunk:
        chunk = self._cache.get(spec.index)
        rows = chunk.rows
        # the residual already holds the base offsets; padding rows take 0
        offsets = np.where(rows >= 0, self._residual[np.maximum(rows, 0)], 0.0
                           ).astype(chunk.offsets.dtype)
        return DenseChunk(features=chunk.features[self._shard], labels=chunk.labels,
                          offsets=offsets, weights=chunk.weights)


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamingGameResult:
    state: GameTrainState
    losses: "list[float]"
    sweeps: int
    chunk_loads: int
    chunk_visits: int

    def __iter__(self):
        return iter((self.state, self.losses))


class StreamingGameProgram:
    """Out-of-core GAME coordinate descent over an entity-clustered chunk
    source (``io/stream_reader.GameArrayChunkSource`` or
    ``GameAvroChunkSource``) on ``device`` (CUDA unless ``"cpu"``).

    The streamed surface: one dense primary FE coordinate and IDENTITY
    random effects, no normalization. The sweep replays the fused program's
    Gauss-Seidel recursion in its update order with its residual algebra,
    so a streamed fit matches the in-core fit to rounding.
    """

    def __init__(self, task: TaskType, source, fe: FixedEffectStepSpec,
                 re_specs: Sequence[RandomEffectStepSpec] = (), *,
                 num_entities: Mapping[str, int] | None = None,
                 bucket_sizes: Sequence[int] = DEFAULT_BUCKET_SIZES, schedule=None,
                 prefetch: bool = True, mesh=None, exchange=None, partition=None,
                 retry_policy=None, scalars: Mapping[str, object] | None = None,
                 device=None):
        if mesh is not None:
            raise ValueError(
                "StreamingGameProgram(mesh=) has no counterpart in the port: the JAX "
                "package's single-process multi-device mesh becomes one process per rank; "
                "stream over several ranks with partition= and exchange= "
                "(io/stream_reader.plan_partitioned_game_stream)")
        self.task = task
        self.source = source
        loss = loss_for_task(task)
        self._loss = loss
        self.device = resolve_device(device)
        # AUTO: L-BFGS on the streamed FE, NEWTON on eligible RE bucket solves
        self.fe = dataclasses.replace(
            fe, optimizer=resolve_auto_optimizer(fe.optimizer, loss=loss, small_dense=False))
        self.re_specs = tuple(
            dataclasses.replace(s, optimizer=resolve_auto_optimizer(
                s.optimizer, loss=loss, small_dense=True))
            for s in re_specs)
        for s in self.re_specs:
            if s.projector != ProjectorType.IDENTITY:
                raise ValueError(
                    f"streamed random-effect coordinate '{s.re_type}' uses projector "
                    f"{s.projector.name}; the streamed surface covers IDENTITY — train "
                    "projected coordinates in-core (train_distributed)")
        #: lane schedulers per (RE type, chunk): each chunk's buckets are a
        #: compaction universe of their own, so each keeps its own state
        self._lane_schedulers: dict = {}
        #: whether the sweep running is the run's last (the schedulers'
        #: active sets run everyone then)
        self._final_sweep = True
        self.bucket_sizes = tuple(int(b) for b in sorted(bucket_sizes))
        self.num_entities = dict(num_entities or {})
        self.schedule = schedule
        self.prefetch = bool(prefetch)
        self.exchange = exchange
        # an exchange without a partition only barriers the checkpoints; the
        # cross-rank sums are keyed off the partition
        self.partition = partition
        self._multi_rank = partition is not None and partition.num_ranks > 1
        if self._multi_rank and exchange is None:
            raise ValueError("a multi-rank GameStreamPartition needs the exchange it was "
                             "agreed over (pass exchange=)")
        if partition is not None:
            self._chunk_lo, self._chunk_hi = partition.chunk_range()
            self._num_chunks_global = int(partition.num_chunks)
        else:
            self._chunk_lo, self._chunk_hi = 0, source.num_chunks
            self._num_chunks_global = int(source.num_chunks)
        if self._multi_rank:
            missing = [s.re_type for s in self.re_specs if s.re_type not in self.num_entities]
            if missing:
                raise ValueError(
                    f"partitioned streamed GAME needs explicit num_entities for {missing} — "
                    "each rank sees only its local entities, so table sizes must come from "
                    "the agreed global vocabs (num_entities={t: len(vocabs[t])})")
        self.retry_policy = retry_policy
        self._cache = _ChunkCache(source)
        self._fe_objective = GLMObjective(loss, 0.0)
        self._re_objectives = {s.re_type: GLMObjective(loss, l2_weight=s.l2_weight)
                               for s in self.re_specs}
        self.update_order = (self.fe.feature_shard_id,) + tuple(s.re_type for s in self.re_specs)
        dupes = {n for n in self.update_order if self.update_order.count(n) > 1}
        if dupes:
            raise ValueError("coordinate names must be unique across the FE feature shard and "
                             f"RE types (duplicates: {sorted(dupes)})")
        self._re_by_name = {s.re_type: s for s in self.re_specs}
        self._scalars_arg = scalars
        #: seconds and counts summed over sweeps (:data:`SWEEP_PARTS`)
        self.timings = dict.fromkeys(SWEEP_PARTS, 0.0)
        self._scan_scalars()
        self._verify_clustering()
        if self._multi_rank:
            self._verify_rank_entity_partition()

    # -- one-time host scans ---------------------------------------------------

    def _row_plan_from_metadata(self):
        """The per-chunk global row arrays from the source's metadata, with
        no decode: an in-memory source's ``row_plan``, or a file source's
        per-chunk ``record_starts``."""
        src = self.source
        if getattr(src, "row_plan", None) is not None:
            return [np.asarray(r) for r in src.row_plan]
        if getattr(src, "record_starts", None) is not None:
            return [np.arange(start, start + spec.num_records, dtype=np.int64)
                    for start, spec in zip(src.record_starts, src.specs)]
        return None

    def _scan_scalars(self) -> None:
        """The ``[n]`` per-sample scalars on the host: from ``scalars``
        (``io/stream_reader.scan_game_stream`` collects them) or an
        in-memory source's arrays, else from one decode pass."""
        n = self.source.total_records
        self.n = n
        src = self.source
        scalars = self._scalars_arg
        if scalars is None and (getattr(src, "labels", None) is not None
                                and getattr(src, "entity_idx", None) is not None):
            scalars = {"labels": src.labels, "offsets": src.offsets, "weights": src.weights,
                       "entity_idx": src.entity_idx}
        row_plan = self._row_plan_from_metadata()
        if scalars is not None and row_plan is not None:
            self.labels = np.asarray(scalars["labels"])
            self.base_offsets = np.asarray(scalars["offsets"], dtype=self.labels.dtype)
            self.weights = np.asarray(scalars["weights"], dtype=self.labels.dtype)
            self.entity_idx = {t: np.asarray(v, dtype=np.int32)
                               for t, v in scalars["entity_idx"].items()}
            if len(self.labels) != n:
                raise ValueError(f"scalars cover {len(self.labels)} records but the chunk plan "
                                 f"holds {n}")
            self._set_dtype(self.labels.dtype)
            self._row_plan = row_plan
            seen = np.zeros(n, dtype=bool)
            for i, rows in enumerate(row_plan):
                if seen[rows].any():
                    raise ValueError(f"chunk {i} re-covers sample rows already assigned to "
                                     "another chunk — the plan must partition the sample axis")
                seen[rows] = True
            if not seen.all():
                raise ValueError(f"chunk plan covers {int(seen.sum())}/{n} sample rows")
        else:
            self.labels = None
            self._row_plan = [None] * self.source.num_chunks
            seen = np.zeros(n, dtype=bool)
            with tracing.span("stream_game/scan", cat="stream", chunks=self.source.num_chunks):
                for spec in self.source.specs:
                    chunk = self._cache.get(spec.index)
                    if self.labels is None:
                        dtype = chunk.labels.dtype
                        self.labels = np.zeros(n, dtype)
                        self.base_offsets = np.zeros(n, dtype)
                        self.weights = np.zeros(n, dtype)
                        self.entity_idx = {t: np.full(n, -1, np.int32) for t in chunk.entity_idx}
                    m = chunk.num_records
                    rows = chunk.rows[:m]
                    if seen[rows].any():
                        raise ValueError(f"chunk {spec.index} re-covers sample rows already "
                                         "assigned to another chunk — the plan must partition the "
                                         "sample axis")
                    seen[rows] = True
                    self._row_plan[spec.index] = np.asarray(rows)
                    self.labels[rows] = chunk.labels[:m]
                    self.base_offsets[rows] = chunk.offsets[:m]
                    self.weights[rows] = chunk.weights[:m]
                    for t, idx in chunk.entity_idx.items():
                        self.entity_idx[t][rows] = idx[:m]
            if self.labels is None:
                raise ValueError("streamed GAME needs a non-empty chunk plan")
            self._set_dtype(self.labels.dtype)
            if not seen.all():
                raise ValueError(f"chunk plan covers {int(seen.sum())}/{n} sample rows")
        for s in self.re_specs:
            if s.re_type not in self.entity_idx:
                raise ValueError(f"random-effect coordinate '{s.re_type}' has no entity index "
                                 "column in the chunk stream")
            if s.re_type not in self.num_entities:
                self.num_entities[s.re_type] = int(self.entity_idx[s.re_type].max() + 1)

    def _set_dtype(self, dtype) -> None:
        self.dtype = np.dtype(dtype)
        self.solve_dtype = self.dtype  # dense f32 or f64 chunks solve in their dtype
        self.torch_dtype = torch.from_numpy(np.zeros(0, self.solve_dtype)).dtype

    def _verify_clustering(self) -> None:
        for s in self.re_specs:
            spanning = entities_spanning_chunks(self._row_plan, self.entity_idx[s.re_type])
            if len(spanning):
                raise ValueError(
                    f"random-effect coordinate '{s.re_type}': {len(spanning)} entities span "
                    f"chunk boundaries (e.g. vocab rows {spanning[:5].tolist()}) — a per-chunk "
                    "solve would train them on partial data. Entity-cluster the chunk plan by "
                    "this type (cluster_by), sort the input by it, or train this coordinate "
                    "in-core.")

    def _verify_rank_entity_partition(self) -> None:
        """Every entity's rows must sit on one rank (whole chunks guarantee
        it for the cluster column; another RE type could straddle ranks).
        One allgather of each rank's present entity rows."""
        if not self.re_specs:
            return
        payload = {}
        for s in self.re_specs:
            idx = self.entity_idx[s.re_type]
            payload[s.re_type] = _pack_i64(np.unique(idx[idx >= 0]).astype(np.int64))
        gathered = self.exchange.allgather("stream_game/entity_partition", payload)
        for s in self.re_specs:
            per_rank = [_unpack_i64(g[s.re_type]) for g in gathered]
            ids, counts = np.unique(np.concatenate(per_rank), return_counts=True)
            overlap = ids[counts > 1]
            if len(overlap):
                owners = [r for r, present in enumerate(per_rank)
                          if np.isin(overlap[:5], present).any()]
                raise ValueError(
                    f"random-effect coordinate '{s.re_type}': {len(overlap)} entities have "
                    f"rows on more than one rank (e.g. vocab rows {overlap[:5].tolist()} on "
                    f"ranks {owners}) — a per-rank solve would train them on partial data. "
                    "Sort the input by the cluster column, nest this type inside it, or "
                    "train this coordinate in-core.")

    # -- state and scores ------------------------------------------------------

    def init_state(self) -> GameTrainState:
        fe_dim = self.source.dims[self.fe.feature_shard_id]
        return GameTrainState(
            fe_coefficients=torch.zeros((fe_dim,), dtype=self.torch_dtype, device=self.device),
            re_tables={s.re_type: torch.zeros(
                (self.num_entities[s.re_type], self.source.dims[s.feature_shard_id]),
                dtype=self.torch_dtype, device=self.device) for s in self.re_specs})

    def _zero_scores(self) -> "dict[str, np.ndarray]":
        return {name: np.zeros(self.n, self.solve_dtype) for name in self.update_order}

    def _residual(self, scores, skip=None) -> np.ndarray:
        """Base offsets plus every coordinate's score but ``skip``, summed
        in update order (the fused program's order), on the host."""
        total = self.base_offsets.astype(self.solve_dtype)
        for name in self.update_order:
            if name != skip:
                total = total + scores[name]
        return total

    def _to_device(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return device_tensor(a, dtype or self.torch_dtype, self.device)

    def _fe_margins(self, w: torch.Tensor, features: np.ndarray) -> np.ndarray:
        return _fe_margin_chunk(w, self._to_device(features), self._fe_objective).cpu().numpy()

    def _refresh_fe_scores(self, scores, fe_w) -> None:
        """The FE margin of every sample, chunk by chunk."""
        shard = self.fe.feature_shard_id
        for spec in self.source.specs:
            chunk = self._cache.get(spec.index)
            margins = self._fe_margins(fe_w, chunk.features[shard])
            scores[shard][self._row_plan[spec.index]] = \
                margins[:spec.num_records].astype(self.solve_dtype)

    def _refresh_re_scores_chunk(self, scores, re_type, table, chunk, spec) -> None:
        s = self._re_by_name[re_type]
        margins = score_random_effect(
            table, self._to_device(chunk.features[s.feature_shard_id]),
            self._to_device(chunk.entity_idx[re_type], torch.int32)).cpu().numpy()
        scores[re_type][self._row_plan[spec.index]] = \
            margins[:spec.num_records].astype(self.solve_dtype)

    def refresh_all_scores(self, state: GameTrainState) -> "dict[str, np.ndarray]":
        """Every coordinate's scores at ``state`` (a resume or warm start),
        chunk-outer so each chunk decodes once."""
        scores = self._zero_scores()
        shard = self.fe.feature_shard_id
        for spec in self.source.specs:
            chunk = self._cache.get(spec.index)
            margins = self._fe_margins(state.fe_coefficients, chunk.features[shard])
            scores[shard][self._row_plan[spec.index]] = \
                margins[:spec.num_records].astype(self.solve_dtype)
            for s in self.re_specs:
                self._refresh_re_scores_chunk(scores, s.re_type, state.re_tables[s.re_type],
                                              chunk, spec)
        return scores

    # -- coordinate solves -----------------------------------------------------

    def _solve_fe(self, scores, fe_w) -> torch.Tensor:
        residual = self._residual(scores, skip=self.fe.feature_shard_id)
        view = _FixedEffectChunkView(self._cache, self.fe.feature_shard_id, residual)
        objective = StreamingGLMObjective(
            view, self._loss, l2_weight=self.fe.l2_weight,
            # several ranks: the per-rank partial sums add in rank order every
            # epoch; keyed off the partition (a recovery exchange on a
            # one-rank program must not add anything)
            exchange=self.exchange if self._multi_rank else None,
            prefetch=self.prefetch, retry_policy=self.retry_policy, device=self.device)
        result = solve(self.fe.optimizer, objective, fe_w)
        t = objective.totals
        for part in ("decode", "wait", "copy", "accumulate", "exchange"):
            self.timings[f"fe_{part}"] += t[part]
        self.timings["fe_epochs"] += objective.epochs
        self.timings["fe_bytes"] += t["bytes"]
        return result.coefficients

    def _chunk_blocks(self, chunk: GameChunk, re_type: str, residual_local: np.ndarray,
                      sample_rows: bool = False):
        """The chunk's entity buckets, packed as ``build_random_effect_dataset``
        packs IDENTITY buckets, with lanes padded to a power of two.
        ``residual_local``: the CD residual in chunk-local rows. With
        ``sample_rows`` each block carries its slots' chunk-local rows (-1 on
        padding) in place of the offsets, the lane scheduler's form."""
        s = self._re_by_name[re_type]
        idx = chunk.entity_idx[re_type]
        m = chunk.num_records
        feats = chunk.features[s.feature_shard_id]
        labels, weights = chunk.labels, chunk.weights
        # chunk.rows are the stable sample ids (the in-core default unique ids)
        per_bucket = group_entities_into_buckets(idx[:m], chunk.rows[:m],
                                                 bucket_sizes=self.bucket_sizes)
        num_rows = self.num_entities[re_type]
        blocks = []
        for cap, members in per_bucket.items():
            if not members:
                continue
            e = len(members)
            e_pad = 1 << (e - 1).bit_length()
            be, rows_concat, lane, slot = pack_bucket_lanes(members)
            bf = np.zeros((e_pad, cap, feats.shape[1]), feats.dtype)
            bl = np.zeros((e_pad, cap), labels.dtype)
            bw = np.zeros((e_pad, cap), weights.dtype)
            bo = np.zeros((e_pad, cap), residual_local.dtype)
            bf[lane, slot] = feats[rows_concat]
            bl[lane, slot] = labels[rows_concat]
            bw[lane, slot] = weights[rows_concat]
            bo[lane, slot] = residual_local[rows_concat]
            ents = np.full((e_pad,), num_rows, np.int32)  # out-of-range sentinel
            ents[:e] = be
            block = {"features": self._to_device(bf), "labels": self._to_device(bl),
                     "weights": self._to_device(bw),
                     "entity_rows": self._to_device(ents, torch.int32)}
            if sample_rows:
                bs = np.full((e_pad, cap), -1, np.int32)
                bs[lane, slot] = rows_concat
                block["sample_rows"] = self._to_device(bs, torch.int32)
            else:
                block["offsets"] = self._to_device(bo)
            blocks.append(block)
        return blocks

    def _solve_re_chunk(self, re_type, table, chunk, residual_local, chunk_index: int = 0):
        """Every entity bucket of one chunk for one RE coordinate. Returns
        (table, importance): Σ over valid lanes of coefficient movement and
        final gradient norm."""
        s = self._re_by_name[re_type]
        objective = self._re_objectives[re_type]
        if s.optimizer.scheduler is not None:
            return self._solve_re_chunk_scheduled(re_type, table, chunk, residual_local,
                                                  chunk_index)
        importance = 0.0
        for batch in self._chunk_blocks(chunk, re_type, residual_local):
            table, trace, movement = _solve_re_chunk_bucket(table, batch, objective,
                                                            s.optimizer)
            signal = (movement + trace.gradient_norm).cpu().numpy()
            importance += float(np.where(trace.valid.cpu().numpy(), signal, 0.0).sum())
        return table, importance

    def _solve_re_chunk_scheduled(self, re_type, table, chunk, residual_local,
                                  chunk_index: int):
        """Probe/rescue lane scheduling of one chunk's buckets, by the
        chunk's own scheduler. The blocks' ``sample_rows`` and the residual
        are both chunk-local. The importance is the unscheduled path's: the
        valid lanes' coefficient movement (taken around the scheduled
        solve) and final gradient norms."""
        from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler

        s = self._re_by_name[re_type]
        key = (re_type, chunk_index)
        scheduler = self._lane_schedulers.get(key)
        if scheduler is None or scheduler.config != s.optimizer.scheduler:
            scheduler = LaneScheduler(s.optimizer.scheduler)
            self._lane_schedulers[key] = scheduler
        blocks = self._chunk_blocks(chunk, re_type, residual_local, sample_rows=True)
        rows = (torch.cat([b["entity_rows"] for b in blocks]).long() if blocks
                else torch.zeros(0, dtype=torch.long, device=table.device))
        rows = rows[rows < table.shape[0]]
        before = table[rows]
        table, traces, _stats = scheduler.solve(
            self._re_objectives[re_type], s.optimizer, blocks,
            self._to_device(residual_local), table, final_sweep=self._final_sweep)
        importance = float(torch.sqrt(torch.sum((table[rows] - before) ** 2, dim=-1)).sum())
        for trace in traces:
            importance += float(torch.where(trace.valid, trace.gradient_norm, 0.0).sum())
        return table, importance

    # -- the sweep -------------------------------------------------------------

    def _weighted_loss(self, scores) -> float:
        margins = self._residual(scores)
        losses = self._loss.loss(torch.from_numpy(margins),
                                 torch.from_numpy(self.labels.astype(self.solve_dtype)))
        wloss = float(torch.sum(torch.from_numpy(self.weights.astype(self.solve_dtype))
                                * losses))
        wsum = float(self.weights.sum())
        if self._multi_rank:
            # the global training loss, the same on every rank (rank order, f64)
            gathered = self.exchange.allgather(
                "stream_game/loss", {"acc": _pack_f64(np.array([wloss, wsum], np.float64))})
            wloss, wsum = 0.0, 0.0
            for g in gathered:
                part = _unpack_f64(g["acc"])
                wloss += float(part[0])
                wsum += float(part[1])
        return wloss / max(wsum, 1.0)

    def _chunk_residual_local(self, scores, rows, m, skip) -> np.ndarray:
        """The CD residual of one chunk's rows in chunk-local rows (padding
        0), summed in :meth:`_residual`'s order."""
        vals = self.base_offsets[rows].astype(self.solve_dtype)
        for name in self.update_order:
            if name != skip:
                vals = vals + scores[name][rows]
        out = np.zeros(self.source.chunk_rows, self.solve_dtype)
        out[:m] = vals
        return out

    def _sweep(self, state: GameTrainState, scores, visit) -> GameTrainState:
        """One Gauss-Seidel sweep, chunk by chunk. The RE phase is chunk-outer
        (a visited chunk decodes once for every RE coordinate): chunks
        partition the samples and an entity sits in one chunk, so this sees
        the residuals the coordinate-outer order would."""
        fe_w = state.fe_coefficients
        tables = dict(state.re_tables)
        t0 = time.perf_counter()
        with tracing.span("stream_game/fe_solve", cat="stream"):
            fe_w = self._solve_fe(scores, fe_w)
            t1 = time.perf_counter()
            self._refresh_fe_scores(scores, fe_w)
            t2 = time.perf_counter()
        self.timings["fe_solve"] += t1 - t0
        self.timings["fe_refresh"] += t2 - t1
        re_names = [n for n in self.update_order if n != self.fe.feature_shard_id]
        # a chunk's importance adds over the RE coordinates before it is recorded
        chunk_importance: dict[int, float] = {}
        updated_rows: dict[str, set] = {name: set() for name in re_names}
        for chunk_index in visit:
            spec = self.source.specs[chunk_index]
            load0 = self._cache.load_seconds
            ta = time.perf_counter()
            chunk = self._cache.get(chunk_index)
            self.timings["re_load"] += self._cache.load_seconds - load0
            rows = self._row_plan[chunk_index]
            for name in re_names:
                with tracing.span("stream_game/re_chunk", cat="stream", coordinate=name,
                                  chunk=chunk_index):
                    residual = self._chunk_residual_local(scores, rows, spec.num_records,
                                                          skip=name)
                    tables[name], importance = self._solve_re_chunk(name, tables[name], chunk,
                                                                    residual, chunk_index)
                    self._refresh_re_scores_chunk(scores, name, tables[name], chunk, spec)
                if self._multi_rank:
                    idx = chunk.entity_idx[name][:spec.num_records]
                    updated_rows[name].update(np.unique(idx[idx >= 0]).tolist())
                chunk_importance[chunk_index] = chunk_importance.get(chunk_index, 0.0) + importance
            self.timings["re_solve"] += time.perf_counter() - ta - (
                self._cache.load_seconds - load0)
        # the schedule speaks global chunk ids: local k is global k + chunk_lo
        importance_global = {ci + self._chunk_lo: imp for ci, imp in chunk_importance.items()}
        if self._multi_rank:
            ts = time.perf_counter()
            tables = self._sync_re_tables(tables, updated_rows)
            importance_global = self._merge_importance(importance_global)
            self.timings["re_sync"] += time.perf_counter() - ts
        for chunk_index in sorted(importance_global):
            self.schedule.record(chunk_index, importance_global[chunk_index])
        return GameTrainState(fe_coefficients=fe_w, re_tables=tables)

    def _sync_re_tables(self, tables, updated_rows):
        """Rank-order merge of the sweep's table updates: each rank sends the
        (row, value) pairs its chunks solved, every rank writes every rank's
        rows in rank order. The rows partition across ranks, so every rank
        ends with the same whole tables (the f32 -> f64 -> f32 round trip is
        exact)."""
        payload = {}
        for name, rows in updated_rows.items():
            rows_arr = np.asarray(sorted(rows), np.int64)
            vals = tables[name].cpu().numpy()[rows_arr]
            payload[name] = {"rows": _pack_i64(rows_arr), "vals": _pack_f64(vals.ravel())}
        with tracing.span("stream_game/re_sync", cat="stream"):
            gathered = self.exchange.allgather("stream_game/re_sync", payload)
        out = {}
        for name, table in tables.items():
            if name not in payload:
                out[name] = table
                continue
            merged = table.cpu().numpy().copy()
            width = merged.shape[1]
            for g in gathered:
                rows_arr = _unpack_i64(g[name]["rows"])
                if len(rows_arr) == 0:
                    continue
                merged[rows_arr] = _unpack_f64(g[name]["vals"]).reshape(-1, width).astype(
                    merged.dtype)
            out[name] = self._to_device(merged)
        return out

    def _merge_importance(self, importance_global):
        """One allgathered importance signal: every rank sees every chunk's
        importance before the schedule records it, so pin and evict
        decisions are the same on every rank."""
        with tracing.span("stream_game/duhl_importance", cat="stream"):
            gathered = self.exchange.allgather(
                "stream_game/duhl_importance",
                {"imp": {str(ci): float(v) for ci, v in importance_global.items()}})
        merged: dict[int, float] = {}
        for g in gathered:
            for ci, v in g["imp"].items():
                merged[int(ci)] = float(v)
        return merged

    # -- checkpoints -----------------------------------------------------------

    def _fingerprint(self) -> dict:
        sched = ({"schedule": "uniform"} if self.schedule is None
                 else self.schedule.fingerprint())

        def opt_fields(opt: OptimizerConfig) -> list:
            return [opt.optimizer_type.name, int(opt.max_iterations), float(opt.tolerance),
                    None if opt.rel_function_tolerance is None
                    else float(opt.rel_function_tolerance),
                    int(opt.history), int(opt.max_cg_iterations), float(opt.l1_weight),
                    opt.scheduler is not None]

        part = self.partition
        return {
            "kind": "game_streaming",
            "task": self.task.name,
            "fe": [self.fe.feature_shard_id, float(self.fe.l2_weight),
                   *opt_fields(self.fe.optimizer)],
            "coordinates": [[s.re_type, s.feature_shard_id, float(s.l2_weight),
                             *opt_fields(s.optimizer)] for s in self.re_specs],
            "bucket_sizes": list(self.bucket_sizes),
            # the global geometry when partitioned: every rank's fingerprint
            # is the same, and another rank geometry fails naming "partition"
            "num_chunks": int(part.num_chunks if part is not None else self.source.num_chunks),
            "chunk_rows": int(part.chunk_rows if part is not None else self.source.chunk_rows),
            "total_records": int(part.total_records if part is not None
                                 else self.source.total_records),
            "partition": (None if part is None else {
                "num_ranks": int(part.num_ranks),
                "chunk_ranges": [list(r) for r in part.chunk_ranges],
                "plan": part.fingerprint}),
            "input": (None if getattr(self.source, "files", None) is None
                      else [[os.path.basename(f), int(os.path.getsize(f))]
                            for f in self.source.files]),
            **sched,
        }

    def _restore(self, checkpointer, fingerprint, step=None):
        ckpt = checkpointer.restore(step=step)
        if ckpt is None:
            return None
        if ckpt.meta.get("kind") != "game_streaming":
            raise ValueError(
                f"checkpoint at {checkpointer.directory} is not a streamed-GAME checkpoint "
                f"(kind={ckpt.meta.get('kind')!r}); use a fresh checkpoint directory")
        mismatch = fingerprint_mismatch(ckpt.meta.get("fingerprint"), fingerprint)
        if mismatch is not None:
            raise ValueError(
                f"streamed-GAME checkpoint at {checkpointer.directory} was written under a "
                f"different run fingerprint ({mismatch}); resume with the original chunk "
                "plan/schedule/optimizers, or use a fresh checkpoint directory")
        state = GameTrainState(
            fe_coefficients=self._to_device(np.asarray(ckpt.arrays["fe_coefficients"])),
            re_tables={k[len("re_tables/"):]: self._to_device(np.asarray(v))
                       for k, v in ckpt.arrays.items() if k.startswith("re_tables/")})
        return ckpt, state

    # -- entry point -----------------------------------------------------------

    def train(self, *, num_sweeps: int, state: GameTrainState | None = None,
              tolerance: float = 0.0, checkpointer=None, checkpoint_every: int = 1,
              resume: bool = True, resume_step: "int | None" = None,
              on_sweep=None) -> StreamingGameResult:
        """Run up to ``num_sweeps`` streamed sweeps.

        tolerance > 0 stops when a sweep's relative decrease of the training
        loss falls below it. checkpointer: an ``io/checkpoint
        .TrainingCheckpointer``; every ``checkpoint_every`` sweeps and at the
        last the state is committed, and with ``resume`` a run continues
        from the newest one (``resume_step`` pins the step a coordinated
        rollback published; 0 starts from scratch). on_sweep: an observer
        ``(sweeps_done, num_sweeps, loss)``."""
        if self.schedule is None:
            self.schedule = UniformChunkSchedule(self._num_chunks_global)
        fingerprint = self._fingerprint()
        start_sweep = 0
        losses: list[float] = []
        if resume_step == 0:
            resume = False
        if checkpointer is not None and resume and state is None:
            restored = self._restore(checkpointer, fingerprint,
                                     step=resume_step if resume_step else None)
            if restored is not None:
                ckpt, state = restored
                start_sweep = min(int(ckpt.step), num_sweeps)
                losses = [float(x) for x in ckpt.meta.get("losses", [])][:start_sweep]
                self.schedule.load_state(ckpt.meta["schedule_state"])
                recovery.counts["checkpoint_restores"] += 1
                recovery.counts["epochs_resumed"] += start_sweep
                logger.info("resuming streamed GAME from checkpoint sweep %d", start_sweep)
        fresh_state = state is None
        if fresh_state:
            state = self.init_state()
        scores = self._zero_scores() if fresh_state else self.refresh_all_scores(state)
        chunk_visits = 0
        for sweep in range(start_sweep, num_sweeps):
            # the schedule plans global chunk ids; each rank runs its range
            self._cache.set_pinned({g - self._chunk_lo for g in self.schedule.pinned()
                                    if self._chunk_lo <= g < self._chunk_hi})
            visit = [g - self._chunk_lo for g in self.schedule.plan_sweep()
                     if self._chunk_lo <= g < self._chunk_hi]
            chunk_visits += len(visit) * len(self.re_specs)
            self._final_sweep = sweep + 1 == num_sweeps
            with tracing.span("stream_game/sweep", cat="stream", sweep=sweep,
                              chunks=len(visit)):
                state = self._sweep(state, scores, visit)
            self.schedule.sweep_done()
            tl = time.perf_counter()
            losses.append(self._weighted_loss(scores))
            self.timings["loss"] += time.perf_counter() - tl
            if not np.isfinite(losses[-1]):
                raise DivergenceError(
                    f"streamed GAME sweep {sweep} produced non-finite loss"
                    + (f"; last good checkpoint: step {checkpointer.latest_step()} in "
                       f"{checkpointer.directory}" if checkpointer is not None else ""))
            if checkpointer is not None and ((sweep + 1) % max(1, checkpoint_every) == 0
                                             or sweep + 1 == num_sweeps):
                arrays = {"fe_coefficients": host_array(state.fe_coefficients),
                          **{f"re_tables/{k}": host_array(v)
                             for k, v in state.re_tables.items()}}
                commit_checkpoint(checkpointer, sweep + 1, arrays,
                                  {"kind": "game_streaming", "fingerprint": fingerprint,
                                   "losses": losses,
                                   "schedule_state": self.schedule.state_dict()},
                                  exchange=self.exchange)
            if on_sweep is not None:
                on_sweep(sweep + 1, num_sweeps, losses[-1])
            if (tolerance > 0.0 and len(losses) >= 2
                    and abs(losses[-2] - losses[-1]) <= tolerance * max(abs(losses[-2]), 1e-12)):
                logger.info("streamed GAME reached loss plateau at sweep %d", sweep)
                break
        # the sweeps this call ran (restored sweeps excluded, as the loads
        # and visits are)
        stream_counters.set_game_stream_evidence(chunk_loads=self._cache.loads,
                                                 chunk_visits=chunk_visits,
                                                 sweeps=len(losses) - start_sweep)
        return StreamingGameResult(state=state, losses=losses, sweeps=len(losses) - start_sweep,
                                   chunk_loads=self._cache.loads, chunk_visits=chunk_visits)

    def cache_bytes(self) -> int:
        """Host bytes the pinned working set holds now."""
        return self._cache.nbytes()


# ---------------------------------------------------------------------------
# Streamed validation scoring
# ---------------------------------------------------------------------------


def score_game_stream(state: GameTrainState, source, task: TaskType, fe_feature_shard_id: str,
                      re_feature_shards: "Mapping[str, str]", *, prefetch: bool = True,
                      retry_policy=None, chunk_timeout: float = DEFAULT_CHUNK_TIMEOUT,
                      return_scalars: bool = False):
    """Score a dataset chunk by chunk against a streamed GAME model: per
    chunk, the FE margin, every RE coordinate's score and the chunk's
    offsets, written into an ``[n]`` host vector through the sweep's
    per-chunk steps (so it matches ``GameModel.score_dataset(ds) + offsets``
    to rounding). The source must be built with the training index maps and
    vocabularies; an unseen entity has index -1 and scores 0.

    ``re_feature_shards`` maps each RE type of ``state.re_tables`` to its
    coordinate's feature shard. The computation runs on the device of the
    state's tensors. ``return_scalars=True`` also returns the ``[n]``
    labels, offsets and weights from the same pass."""
    missing = [t for t in state.re_tables if t not in re_feature_shards]
    if missing:
        raise ValueError(f"re_feature_shards is missing shard assignments for {missing}")
    objective = GLMObjective(loss_for_task(task), 0.0)
    device = state.fe_coefficients.device
    n = source.total_records
    dtype = np.dtype(source.dtype)
    scores = np.zeros(n, dtype)
    scalars = ({k: np.zeros(n, dtype) for k in ("labels", "offsets", "weights")}
               if return_scalars else None)
    starts = getattr(source, "record_starts", None)
    with tracing.span("stream_game/score", cat="stream", chunks=source.num_chunks), \
            ChunkPrefetcher(source, prefetch=prefetch, retry_policy=retry_policy,
                            chunk_timeout=chunk_timeout) as chunks:
        for spec, chunk in zip(source.specs, chunks):
            m = chunk.num_records
            w = state.fe_coefficients
            total = _fe_margin_chunk(
                w, device_tensor(chunk.features[fe_feature_shard_id], w.dtype, device),
                objective).cpu().numpy().astype(dtype)
            for re_type, table in state.re_tables.items():
                total = total + score_random_effect(
                    table, device_tensor(chunk.features[re_feature_shards[re_type]],
                                         table.dtype, device),
                    device_tensor(chunk.entity_idx[re_type], torch.int32, device)
                ).cpu().numpy().astype(dtype)
            total = total + np.asarray(chunk.offsets, dtype)
            if getattr(chunk, "rows", None) is not None:
                rows = np.asarray(chunk.rows[:m])
            elif starts is not None:
                rows = np.arange(starts[spec.index], starts[spec.index] + m)
            else:
                raise ValueError("the validation chunk source carries neither row ids nor "
                                 "record starts — scores cannot be placed")
            scores[rows] = total[:m]
            if scalars is not None:
                scalars["labels"][rows] = chunk.labels[:m]
                scalars["offsets"][rows] = chunk.offsets[:m]
                scalars["weights"][rows] = chunk.weights[:m]
    if return_scalars:
        return scores, scalars
    return scores
