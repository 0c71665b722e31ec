"""Chunked out-of-core input for streamed GLM and GAME solves: the port of
``photon_ml_tpu/io/stream_reader.py``.

A streamed epoch walks a fixed chunk plan. A background thread decodes the
next chunk into host numpy buffers (:class:`DenseChunk`,
:class:`SparseChunk`) while the caller copies the current one to the device
and accumulates its contribution (``algorithm/streaming.py``).

- **Fixed chunk shapes.** Every chunk pads to the plan's ``chunk_rows`` with
  zero-weight rows, and sparse chunks share one ELL width, flat-tail length
  and hot-column set, resolved over the whole input.
- **The decode thread is numpy-only.** It never touches a device; the
  consumer makes the one host-to-device copy per chunk
  (:meth:`DenseChunk.to_device`), a plain synchronous copy.
- **Bounded and hang-free.** Producer and consumer meet at a depth-bounded
  queue with timeouts both ways and a bounded join on close; a wedged side
  raises :class:`StreamDecodeError`.
- **GAME chunks** (:class:`GameChunk`) are entity-clustered: every entity of
  the cluster column sits in one chunk (:func:`plan_entity_chunks`,
  :func:`plan_entity_chunks_avro`), so a random effect's per-chunk solve is
  exact. :func:`plan_partitioned_stream` and
  :func:`plan_partitioned_game_stream` give each rank of a group its own
  slice of the chunks, agreed over the metadata exchange.
- **Classified failures.** A chunk's decode runs under a
  ``resilience.RetryPolicy``; what survives it reaches the consumer's stack
  as a :class:`StreamDecodeError` naming the chunk. One port-side shape:
  when the surviving cause is transient, the wrapper is a
  :class:`TransientStreamDecodeError`, so ``run_with_recovery`` restarts on
  it (the JAX package's wrapper keeps only the cause's message, and an
  ``OSError(EIO)`` wrapped there classifies fatal).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import queue
import threading
import time
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch, device_tensor
from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.resilience import (
    RetryPolicy,
    TransientError,
    default_io_policy,
    is_transient,
)

#: consumer-side wait bound per chunk (seconds)
DEFAULT_CHUNK_TIMEOUT = 120.0

#: bounded join of the producer thread at close
JOIN_TIMEOUT = 10.0


class StreamDecodeError(RuntimeError):
    """A chunk failed to decode (after classified retries) or the prefetch
    pipeline wedged; the message names the chunk."""


class TransientStreamDecodeError(StreamDecodeError, TransientError):
    """A :class:`StreamDecodeError` whose cause classifies transient."""


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """One planned chunk: ``runs`` are contiguous (file, start_block,
    num_blocks) container-block ranges whose records fill the chunk."""

    index: int
    num_records: int
    runs: tuple[tuple[str, int, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class DenseChunk:
    """One dense chunk on the host: numpy ``features [chunk_rows, d]``,
    ``labels``, ``offsets``, ``weights`` (zero-weight padding rows)."""

    features: np.ndarray
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in (self.features, self.labels, self.offsets,
                                          self.weights)))

    def to_device(self, device) -> LabeledPointBatch:
        """The chunk as a batch on ``device``: one copy per array."""
        dtype = torch.from_numpy(self.features[:0]).dtype
        return LabeledPointBatch(
            features=device_tensor(self.features, dtype, device),
            labels=device_tensor(self.labels, dtype, device),
            offsets=device_tensor(self.offsets, dtype, device),
            weights=device_tensor(self.weights, dtype, device))


@dataclasses.dataclass(frozen=True)
class SparseChunk:
    """One sparse chunk on the host: the arrays of
    ``data/sparse_batch.coo_host_arrays`` (flat tail, ELL block, hybrid
    head, per-sample columns)."""

    host: dict

    @property
    def nbytes(self) -> int:
        arrays = [self.host[k] for k in ("rows", "cols", "vals", "labels", "offsets", "weights")]
        arrays += list(self.host["extra"].values())
        return int(sum(np.asarray(a).nbytes for a in arrays if a is not None))

    def to_device(self, device):
        from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch

        return SparseLabeledPointBatch.from_host(self.host, device=device)


class ChunkSource:
    """Protocol of streamed chunk sources.

    specs: the epoch's chunk plan (fixed, re-iterable); chunk_rows: the
    padded row count of every chunk; dim: the feature-space size; sparse:
    True when ``load`` yields :class:`SparseChunk`; dtype: the numpy dtype
    of the features; load(spec): decode and assemble one chunk on the host
    (pure and idempotent: it is retried on transient failures).
    """

    specs: "list[ChunkSpec]"
    chunk_rows: int
    dim: int
    sparse: bool = False
    dtype = np.float32

    def load(self, spec: ChunkSpec):
        raise NotImplementedError

    @property
    def num_chunks(self) -> int:
        return len(self.specs)

    @property
    def total_records(self) -> int:
        return int(sum(s.num_records for s in self.specs))


def _pad_dense_chunk(features: np.ndarray, labels: np.ndarray, offsets: np.ndarray,
                     weights: np.ndarray, chunk_rows: int) -> DenseChunk:
    """Zero-weight padding to the fixed chunk shape (numpy only)."""
    n = features.shape[0]
    pad = chunk_rows - n
    if pad < 0:
        raise ValueError(f"chunk has {n} rows > plan chunk_rows {chunk_rows}")
    if pad:
        features = np.pad(features, ((0, pad), (0, 0)))
        labels = np.pad(labels, (0, pad))
        offsets = np.pad(offsets, (0, pad))
        weights = np.pad(weights, (0, pad))
    return DenseChunk(features=features, labels=labels, offsets=offsets, weights=weights)


class ArrayChunkSource(ChunkSource):
    """Dense in-memory source: row ranges of a host [n, d] array.
    ``decode_hook`` (called once per ``load``, in the loading thread) injects
    decode cost or faults."""

    sparse = False

    def __init__(self, features: np.ndarray, labels: np.ndarray, *,
                 offsets: np.ndarray | None = None, weights: np.ndarray | None = None,
                 chunk_rows: int, decode_hook: Callable[[], None] | None = None):
        self.features = np.asarray(features)
        n = self.features.shape[0]
        self.dtype = self.features.dtype
        self.labels = np.asarray(labels, dtype=self.dtype)
        self.offsets = (np.zeros((n,), self.dtype) if offsets is None
                        else np.asarray(offsets, dtype=self.dtype))
        self.weights = (np.ones((n,), self.dtype) if weights is None
                        else np.asarray(weights, dtype=self.dtype))
        self.chunk_rows = int(chunk_rows)
        self.dim = int(self.features.shape[1])
        self.decode_hook = decode_hook
        self.specs = [ChunkSpec(index=i, num_records=min(self.chunk_rows, n - lo))
                      for i, lo in enumerate(range(0, n, self.chunk_rows))]

    def load(self, spec: ChunkSpec) -> DenseChunk:
        if self.decode_hook is not None:
            self.decode_hook()
        lo = spec.index * self.chunk_rows
        hi = lo + spec.num_records
        # copies, not views: a real decode materializes fresh buffers
        return _pad_dense_chunk(np.array(self.features[lo:hi]), np.array(self.labels[lo:hi]),
                                np.array(self.offsets[lo:hi]), np.array(self.weights[lo:hi]),
                                self.chunk_rows)


class SparseArrayChunkSource(ChunkSource):
    """Sparse in-memory source: host COO triples chunked by row ranges into
    fixed-layout ELL (+ optional hybrid head) chunks. One global layout for
    every chunk, resolved at construction: one ELL width (the widest row
    after the head), one flat-tail length, one hot-column set ranked over
    the whole input."""

    sparse = True

    def __init__(self, rows, cols, vals, labels, *, dim: int, chunk_rows: int, offsets=None,
                 weights=None, hybrid=None, dtype=np.float64,
                 decode_hook: Callable[[], None] | None = None):
        from photon_ml_torch.data.sparse_batch import (
            coalesce_coo,
            rank_hot_columns,
            resolve_hybrid_policy,
        )

        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        self.rows, self.cols, self.vals = coalesce_coo(rows, cols, vals)
        self.labels = np.asarray(labels, dtype=dtype)
        n = self.labels.shape[0]
        self.offsets = (np.zeros((n,), dtype) if offsets is None
                        else np.asarray(offsets, dtype=dtype))
        self.weights = (np.ones((n,), dtype) if weights is None
                        else np.asarray(weights, dtype=dtype))
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.chunk_rows = int(chunk_rows)
        self.decode_hook = decode_hook
        self.specs = [ChunkSpec(index=i, num_records=min(self.chunk_rows, n - lo))
                      for i, lo in enumerate(range(0, n, self.chunk_rows))]
        # row ranges of the row-sorted entries, one per chunk
        self._bounds = np.searchsorted(self.rows, np.arange(0, n + self.chunk_rows,
                                                            self.chunk_rows))
        policy = resolve_hybrid_policy(hybrid)
        if policy is not None and policy.hot_ids is None:
            uniq, cnt = np.unique(self.cols, return_counts=True)
            hot = rank_hot_columns(uniq, cnt, len(self.vals), policy)
            policy = dataclasses.replace(policy, hot_ids=tuple(int(c) for c in hot))
        self.hybrid_policy = policy
        if policy is not None:
            hot_sorted = np.sort(np.asarray(policy.hot_ids, dtype=np.int64))
            pos = np.searchsorted(hot_sorted, self.cols)
            is_hot = hot_sorted[np.minimum(pos, len(hot_sorted) - 1)] == self.cols
            tail_rows = self.rows[~is_hot]
        else:
            tail_rows = self.rows
        counts = np.bincount(tail_rows, minlength=n) if n else np.zeros(0, int)
        self.ell_width = int(counts.max()) if len(counts) else 0
        # every row fits the agreed width: the flat tail holds one inert entry
        self.flat_nnz = 1
        # without a head, each entry's slot in its row's ELL block (the
        # entries are row-sorted and coalesced): a chunk then fills its block
        # by one scatter, the arrays ``coo_host_arrays`` would build
        self._slot = None
        if policy is None:
            first = np.searchsorted(self.rows, self.rows, side="left")
            self._slot = (np.arange(len(self.rows)) - first).astype(np.int32)

    def load(self, spec: ChunkSpec) -> SparseChunk:
        from photon_ml_torch.data.sparse_batch import _torch_dtype, coo_host_arrays

        if self.decode_hook is not None:
            self.decode_hook()
        lo = spec.index * self.chunk_rows
        hi = lo + spec.num_records
        a, b = self._bounds[spec.index], self._bounds[spec.index + 1]
        labels = np.zeros((self.chunk_rows,), self.dtype)
        offsets = np.zeros((self.chunk_rows,), self.dtype)
        weights = np.zeros((self.chunk_rows,), self.dtype)
        labels[: spec.num_records] = self.labels[lo:hi]
        offsets[: spec.num_records] = self.offsets[lo:hi]
        weights[: spec.num_records] = self.weights[lo:hi]
        if self._slot is not None:
            width = max(1, self.ell_width)
            ell_vals = np.zeros((self.chunk_rows, width), dtype=self.dtype)
            ell_cols = np.zeros((self.chunk_rows, width), dtype=np.int32)
            rows, slots = self.rows[a:b] - lo, self._slot[a:b]
            ell_vals[rows, slots] = self.vals[a:b]
            ell_cols[rows, slots] = self.cols[a:b]
            return SparseChunk(dict(
                rows=np.zeros(1, np.int64), cols=np.zeros(1, np.int64),
                vals=np.zeros(1, self.dtype), labels=labels, offsets=offsets, weights=weights,
                dim=self.dim, dtype=_torch_dtype(self.dtype),
                extra=dict(ell_vals=ell_vals, ell_cols=ell_cols), layout=None))
        return SparseChunk(coo_host_arrays(
            self.rows[a:b] - lo, self.cols[a:b], self.vals[a:b], labels, dim=self.dim,
            offsets=offsets, weights=weights, dtype=_torch_dtype(self.dtype),
            ell=self.ell_width, pad_nnz_to=self.flat_nnz, hybrid=self.hybrid_policy))


class DenseRecordAssembler:
    """TrainingExample record dicts -> one fixed-shape dense chunk, with the
    per-record semantics of ``io/data_reader.records_to_game_dataset`` (label
    or response, a None offset is 0, a None weight is 1, name+term keys,
    duplicate (row, col) entries add up, the intercept column)."""

    def __init__(self, index_map, shard_config, dtype=np.float32):
        self.index_map = index_map
        self.shard_config = shard_config
        self.dtype = dtype

    def __call__(self, records: list, chunk_rows: int) -> DenseChunk:
        from photon_ml_torch.io.data_reader import (
            OFFSET,
            RESPONSE,
            WEIGHT,
            _apply_intercept,
            _record_bags,
            _scatter_dense,
        )
        from photon_ml_torch.io.index_map import feature_key

        n = len(records)
        labels = np.zeros((n,), np.float64)
        offsets = np.zeros((n,), np.float64)
        weights = np.ones((n,), np.float64)
        triples: list[tuple[int, int, float]] = []
        imap = self.index_map
        for i, record in enumerate(records):
            label = record.get("label", record.get(RESPONSE))
            if label is None:
                raise ValueError("record has neither 'label' nor 'response'")
            labels[i] = float(label)
            offset = record.get(OFFSET)
            offsets[i] = 0.0 if offset is None else float(offset)
            weight = record.get(WEIGHT)
            weights[i] = 1.0 if weight is None else float(weight)
            bags = _record_bags(record)
            for bag in self.shard_config.feature_bags:
                for feat in bags.get(bag, ()):
                    j = imap.get_index(feature_key(feat["name"], feat.get("term") or ""))
                    if j >= 0:
                        triples.append((i, j, float(feat["value"])))
        t = np.asarray(triples, dtype=np.float64) if triples else np.zeros((0, 3))
        x = _scatter_dense(n, imap.size, t[:, 0], t[:, 1], t[:, 2], self.dtype)
        if self.shard_config.has_intercept:
            _apply_intercept(x, imap, "features", {})
        return _pad_dense_chunk(x, labels.astype(self.dtype), offsets.astype(self.dtype),
                                weights.astype(self.dtype), chunk_rows)


def plan_chunks(files: Sequence[str], chunk_records: int, *, on_corrupt: str = "raise",
                indexes: "list[list[tuple[int, int, int]]] | None" = None,
                block_subset: "Sequence[tuple[int, int]] | None" = None,
                ) -> tuple[list[ChunkSpec], "list[list[tuple[int, int, int]]]"]:
    """Group contiguous container blocks into chunks of at most
    ``chunk_records`` records (an over-budget block forms its own chunk:
    blocks are the unit of decode). One header decode and one seek per block
    (``avro.scan_block_index``), never a data read. ``block_subset``: an
    optional (file_idx, block_idx) list to stream instead of every block.
    Returns (specs, per-file block indexes)."""
    if chunk_records <= 0:
        raise ValueError(f"chunk_records must be positive, got {chunk_records}")
    if indexes is None:
        indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
    if not any(len(ix) for ix in indexes):
        raise ValueError("no Avro blocks to stream")
    blocks = (list(block_subset) if block_subset is not None
              else [(fi, bi) for fi, file_index in enumerate(indexes)
                    for bi in range(len(file_index))])
    specs: list[ChunkSpec] = []
    cur: list[tuple[int, int]] = []
    cur_records = 0

    def flush():
        nonlocal cur, cur_records
        if not cur:
            return
        runs: list[tuple[str, int, int]] = []
        for fi, group in itertools.groupby(cur, key=lambda b: b[0]):
            bis = [bi for _, bi in group]
            # a gap in a file's blocks starts a new seek range
            run_start = prev = bis[0]
            for bi in bis[1:] + [None]:
                if bi is None or bi != prev + 1:
                    runs.append((files[fi], run_start, prev - run_start + 1))
                    run_start = bi
                prev = bi if bi is not None else prev
        specs.append(ChunkSpec(index=len(specs), num_records=cur_records, runs=tuple(runs)))
        cur, cur_records = [], 0

    for fi, bi in blocks:
        n_rec = indexes[fi][bi][0]
        if cur and cur_records + n_rec > chunk_records:
            flush()
        cur.append((fi, bi))
        cur_records += n_rec
    flush()
    return specs, indexes


class AvroChunkSource(ChunkSource):
    """Chunks from Avro container files through a record assembler, decoding
    only each chunk's block ranges (``io/avro.read_container_block_range``,
    the Python codec)."""

    sparse = False

    def __init__(self, files: Sequence[str], assembler: Callable[[list, int], DenseChunk], *,
                 chunk_records: int, on_corrupt: str = "raise", indexes=None,
                 block_subset=None, dim: int | None = None):
        self.files = [str(f) for f in files]
        self.assembler = assembler
        self.on_corrupt = on_corrupt
        self.dtype = np.dtype(getattr(assembler, "dtype", np.float32))
        self.specs, self.indexes = plan_chunks(self.files, chunk_records, on_corrupt=on_corrupt,
                                               indexes=indexes, block_subset=block_subset)
        self.chunk_rows = max((s.num_records for s in self.specs), default=0)
        if dim is not None:
            self.dim = int(dim)
        else:
            imap = getattr(assembler, "index_map", None)
            self.dim = int(imap.size) if imap is not None else 0
        self._file_pos = {f: i for i, f in enumerate(self.files)}
        #: payload bytes decoded so far
        self.bytes_decoded = 0

    def load(self, spec: ChunkSpec) -> DenseChunk:
        records: list = []
        payload_bytes = 0
        for path, start, count in spec.runs:
            index = self.indexes[self._file_pos[path]]
            payload_bytes += sum(sz for _, sz, _ in index[start:start + count])
            records.extend(avro_io.read_container_block_range(
                path, start, count, index=index, on_corrupt=self.on_corrupt))
        self.bytes_decoded += payload_bytes
        return self.assembler(records, self.chunk_rows)


_END = object()


class ChunkPrefetcher:
    """One epoch's chunk iterator: decode in a background thread ahead of
    the consumer (``prefetch=True``) or inline, with classified retry,
    bounded timeouts, and the epoch's decode and wait seconds.

    Use as a context manager; iterating yields each host chunk once, in plan
    order. ``close()`` (idempotent) stops the producer with a bounded join.
    """

    def __init__(self, source: ChunkSource, *, prefetch: bool = True, depth: int = 1,
                 retry_policy: RetryPolicy | None = None,
                 chunk_timeout: float = DEFAULT_CHUNK_TIMEOUT):
        self.source = source
        self.prefetch = bool(prefetch)
        self.depth = max(1, int(depth))
        self.policy = retry_policy if retry_policy is not None else default_io_policy()
        self.chunk_timeout = float(chunk_timeout)
        self.decode_seconds = 0.0
        self.wait_seconds = 0.0
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- producer -------------------------------------------------------------

    def _load_timed(self, spec: ChunkSpec):
        t0 = time.perf_counter()
        chunk = self.policy.call(self.source.load, spec, description=f"decode chunk {spec.index}")
        self.decode_seconds += time.perf_counter() - t0
        return chunk

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        for spec in self.source.specs:
            if self._stop.is_set():
                return
            try:
                chunk = self._load_timed(spec)
            except Exception as e:  # forwarded to the consumer's stack
                self._put((spec, e))
                return
            if not self._put((spec, chunk)):
                return
        self._put((None, _END))

    # -- consumer -------------------------------------------------------------

    def __enter__(self) -> "ChunkPrefetcher":
        if self.prefetch:
            self._thread = threading.Thread(target=self._producer, name="chunk-prefetch",
                                            daemon=True)
            self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # drain so a blocked put can finish, then a bounded join
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=JOIN_TIMEOUT)
            self._thread = None

    def _next_prefetched(self):
        deadline = time.perf_counter() + self.chunk_timeout
        t0 = time.perf_counter()
        while True:
            try:
                item = self._queue.get(timeout=0.2)
                self.wait_seconds += time.perf_counter() - t0
                return item
            except queue.Empty:
                if self._thread is not None and not self._thread.is_alive():
                    raise StreamDecodeError(
                        "prefetch thread died without forwarding a result") from None
                if time.perf_counter() > deadline:
                    raise StreamDecodeError(
                        f"no chunk arrived within {self.chunk_timeout:.0f}s (wedged decode?)"
                    ) from None

    def __iter__(self):
        if not self.prefetch:
            for spec in self.source.specs:
                try:
                    yield self._load_timed(spec)
                except Exception as e:
                    raise self._attributed(e, spec) from e
            return
        while True:
            spec, item = self._next_prefetched()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise self._attributed(item, spec) from item
            yield item

    @property
    def overlap_fraction(self) -> float:
        """The share of the epoch's decode time hidden behind the consumer."""
        if not self.prefetch or self.decode_seconds <= 0.0:
            return 0.0
        return max(0.0, self.decode_seconds - self.wait_seconds) / self.decode_seconds

    @staticmethod
    def _attributed(exc, spec: ChunkSpec | None) -> StreamDecodeError:
        where = (f"chunk {spec.index} (records={spec.num_records}, runs={list(spec.runs)})"
                 if spec is not None else "a chunk")
        cls = TransientStreamDecodeError if is_transient(exc) else StreamDecodeError
        return cls(f"streaming epoch failed decoding {where}: {type(exc).__name__}: {exc}")


def build_streaming_index_maps(files: Sequence[str], shard_configs: Mapping[str, object], *,
                               on_corrupt: str = "raise"):
    """Global feature index maps from one pass over the input, whose records
    are decoded and dropped (memory stays the vocabulary's), with the
    key set and sort of ``io/data_reader.build_index_maps``."""
    from photon_ml_torch.io.data_reader import build_index_maps

    return build_index_maps(
        itertools.chain.from_iterable(avro_io.read_container(f, on_corrupt=on_corrupt)
                                      for f in files),
        shard_configs)


# ---------------------------------------------------------------------------
# Entity-clustered GAME chunks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GameChunk:
    """One decoded GAME chunk on the host (numpy, padded to ``chunk_rows``):
    per-shard feature blocks, per-sample scalars, per-RE-type entity indices
    into the global vocabulary (-1 for absent entities and padding) and each
    slot's global sample row (``rows``, -1 for padding), through which the
    host-resident ``[n]`` score vectors are read and written chunk by chunk.
    Padding rows carry weight 0 and zero features."""

    features: "dict[str, np.ndarray]"
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    entity_idx: "dict[str, np.ndarray]"
    rows: np.ndarray
    num_records: int

    @property
    def nbytes(self) -> int:
        arrays = [*self.features.values(), self.labels, self.offsets, self.weights,
                  *self.entity_idx.values(), self.rows]
        return int(sum(a.nbytes for a in arrays))


def plan_entity_chunks(entity_idx: np.ndarray, chunk_records: int) -> "list[np.ndarray]":
    """Entity-clustered chunk plan over in-memory rows: whole entities (all
    rows of one entity index, in ascending row order) packed greedily into
    chunks of at most ``chunk_records`` rows. An entity larger than the
    budget forms its own chunk; rows of entity -1 (absent from the
    vocabulary: scored, never trained) split freely. Every entity's rows
    then sit in one chunk, so its per-chunk solve sees the block the
    in-core path builds. Returns the per-chunk global row arrays."""
    if chunk_records <= 0:
        raise ValueError(f"chunk_records must be positive, got {chunk_records}")
    entity_idx = np.asarray(entity_idx)
    n = len(entity_idx)
    if n == 0:
        return []
    # a stable sort groups each entity's rows, keeping their ascending order
    order = np.argsort(entity_idx, kind="stable")
    ents = entity_idx[order]
    boundaries = np.concatenate([[0], np.nonzero(ents[1:] != ents[:-1])[0] + 1, [n]])
    chunks: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    cur_n = 0

    def flush():
        nonlocal cur, cur_n
        if cur:
            chunks.append(np.concatenate(cur))
            cur, cur_n = [], 0

    for start, end in zip(boundaries[:-1], boundaries[1:]):
        if ents[start] < 0:
            group_rows = order[start:end]
            for lo in range(0, len(group_rows), chunk_records):
                sub = group_rows[lo:lo + chunk_records]
                if cur and cur_n + len(sub) > chunk_records:
                    flush()
                cur.append(sub)
                cur_n += len(sub)
            continue
        group = order[start:end]
        if cur and cur_n + len(group) > chunk_records:
            flush()
        cur.append(group)
        cur_n += len(group)
    flush()
    return chunks


def entities_spanning_chunks(row_plan: "Sequence[np.ndarray]", entity_idx: np.ndarray
                             ) -> np.ndarray:
    """Vocabulary rows of the entities whose samples land in more than one
    chunk of ``row_plan``: those a per-chunk solve would train on partial
    data. Empty when the plan entity-clusters this RE type."""
    entity_idx = np.asarray(entity_idx)
    chunk_of = np.full(len(entity_idx), -1, dtype=np.int64)
    for i, rows in enumerate(row_plan):
        chunk_of[rows] = i
    valid = entity_idx >= 0
    if not valid.any():
        return np.zeros((0,), dtype=np.int64)
    pairs = np.unique(np.stack([entity_idx[valid].astype(np.int64), chunk_of[valid]]), axis=1)
    ents, counts = np.unique(pairs[0], return_counts=True)
    return ents[counts > 1]


class GameArrayChunkSource:
    """Entity-clustered in-memory GAME chunk source: host arrays chunked by
    whole-entity row groups (:func:`plan_entity_chunks`). The per-sample
    scalars stay on the host; the feature blocks reach the device one chunk
    at a time.

    ``cluster_by``: the RE type whose entities group the chunks (needed when
    a random effect trains from this source); other RE types must nest
    inside those groups, which ``StreamingGameProgram`` checks.
    ``decode_hook`` runs once per load in the loading thread."""

    sparse = False

    def __init__(self, *, features: "Mapping[str, np.ndarray]", labels: np.ndarray,
                 entity_idx: "Mapping[str, np.ndarray]", offsets: np.ndarray | None = None,
                 weights: np.ndarray | None = None, chunk_records: int,
                 cluster_by: str | None = None, decode_hook: Callable[[], None] | None = None):
        self.features = {k: np.asarray(v) for k, v in features.items()}
        self.labels = np.asarray(labels)
        n = self.labels.shape[0]
        dtype = self.labels.dtype
        self.dtype = dtype
        self.offsets = (np.zeros((n,), dtype) if offsets is None
                        else np.asarray(offsets, dtype=dtype))
        self.weights = (np.ones((n,), dtype) if weights is None
                        else np.asarray(weights, dtype=dtype))
        self.entity_idx = {t: np.asarray(v, dtype=np.int32) for t, v in entity_idx.items()}
        self.decode_hook = decode_hook
        if cluster_by is not None and cluster_by not in self.entity_idx:
            raise ValueError(f"cluster_by={cluster_by!r} is not an entity-index column "
                             f"({sorted(self.entity_idx)})")
        self.cluster_by = cluster_by
        if cluster_by is not None:
            self.row_plan = plan_entity_chunks(self.entity_idx[cluster_by], chunk_records)
        else:
            self.row_plan = [np.arange(lo, min(lo + chunk_records, n))
                             for lo in range(0, n, chunk_records)]
        self.specs = [ChunkSpec(index=i, num_records=len(rows))
                      for i, rows in enumerate(self.row_plan)]
        self.chunk_rows = max((len(r) for r in self.row_plan), default=0)
        self.dims = {k: int(v.shape[1]) for k, v in self.features.items()}

    @property
    def num_chunks(self) -> int:
        return len(self.specs)

    @property
    def total_records(self) -> int:
        return int(sum(s.num_records for s in self.specs))

    def load(self, spec: ChunkSpec) -> GameChunk:
        if self.decode_hook is not None:
            self.decode_hook()
        idx = self.row_plan[spec.index]
        m = len(idx)
        # an entity-sorted input's chunks are row ranges: one slice copy each
        run = slice(int(idx[0]), int(idx[0]) + m) if m and int(idx[-1]) - int(idx[0]) + 1 == m \
            and bool(np.all(np.diff(idx) == 1)) else idx

        def pad1(a, fill=0):
            # one copy into the padded chunk: a chunk never aliases the source
            out = np.empty((self.chunk_rows,) + a.shape[1:], a.dtype)
            out[:m] = a[run]
            out[m:] = fill
            return out

        rows = np.full((self.chunk_rows,), -1, np.int64)
        rows[:m] = idx
        return GameChunk(features={k: pad1(v) for k, v in self.features.items()},
                         labels=pad1(self.labels), offsets=pad1(self.offsets),
                         weights=pad1(self.weights),
                         entity_idx={t: pad1(v, fill=-1) for t, v in self.entity_idx.items()},
                         rows=rows, num_records=len(idx))


def plan_entity_chunks_avro(files: Sequence[str], chunk_records: int, cluster_keys: np.ndarray,
                            *, indexes: "list[list[tuple[int, int, int]]] | None" = None,
                            on_corrupt: str = "raise"):
    """Entity-clustered Avro chunk plan at record granularity: a chunk is a
    record range that ends at the first change of the clustering entity at
    or after ``chunk_records`` rows (``cluster_keys``: the per-record key of
    the cluster column in file and record order; "" is an entity like any
    other). A chunk's ``runs`` are its covering block ranges (a boundary
    block decodes for both neighbours); a load slices the decoded records to
    the range. Returns (specs, per-file block indexes, per-chunk record
    starts, per-chunk leading-record skips into the first covering block)."""
    if chunk_records <= 0:
        raise ValueError(f"chunk_records must be positive, got {chunk_records}")
    if indexes is None:
        indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
    cluster_keys = np.asarray(cluster_keys).astype(str)
    total = sum(n for file_index in indexes for (n, _, _) in file_index)
    if len(cluster_keys) != total:
        raise ValueError(f"cluster_keys covers {len(cluster_keys)} records but the block index "
                         f"holds {total}")
    splittable = np.ones(total + 1, dtype=bool)
    if total > 1:
        splittable[1:total] = cluster_keys[1:] != cluster_keys[:-1]
    specs, starts, skips = _entity_chunks_over_blocks(files, indexes, chunk_records, splittable)
    return specs, indexes, starts, skips


def _entity_chunks_over_blocks(files: Sequence[str], indexes, chunk_records: int,
                               splittable: np.ndarray):
    """The record-granular chunk loop of :func:`plan_entity_chunks_avro` and
    :func:`plan_partitioned_game_stream` (``splittable[i]``: a chunk may end
    before record i). Returns (specs, starts, skips)."""
    blocks = [(fi, bi, file_index[bi][0]) for fi, file_index in enumerate(indexes)
              for bi in range(len(file_index))]
    if not blocks:
        raise ValueError("no Avro blocks to stream")
    total = sum(b[2] for b in blocks)
    if len(splittable) != total + 1:
        raise ValueError(f"boundary mask covers {len(splittable) - 1} records but the block "
                         f"index holds {total}")
    block_starts = np.concatenate([[0], np.cumsum([b[2] for b in blocks])]).astype(np.int64)
    specs: list[ChunkSpec] = []
    starts: list[int] = []
    skips: list[int] = []
    pos = 0
    while pos < total:
        end = min(pos + chunk_records, total)
        while end < total and not splittable[end]:
            end += 1
        first = int(np.searchsorted(block_starts, pos, side="right") - 1)
        last = int(np.searchsorted(block_starts, end, side="left") - 1)
        runs: list[tuple[str, int, int]] = []
        cover = [(blocks[i][0], blocks[i][1]) for i in range(first, last + 1)]
        for fi, group in itertools.groupby(cover, key=lambda b: b[0]):
            bis = [bi for _, bi in group]
            run_start = prev = bis[0]
            for bi in bis[1:] + [None]:
                if bi is None or bi != prev + 1:
                    runs.append((files[fi], run_start, prev - run_start + 1))
                    run_start = bi
                prev = bi if bi is not None else prev
        specs.append(ChunkSpec(index=len(specs), num_records=end - pos, runs=tuple(runs)))
        starts.append(int(pos))
        skips.append(int(pos - block_starts[first]))
        pos = end
    return specs, starts, skips


class GameAvroChunkSource:
    """GAME chunks from Avro container files, each decoded through the
    per-record assembly of the in-core read (``io/data_reader
    .records_to_game_dataset`` with agreed index maps and entity vocabs, on
    the CPU in the decode thread), so a streamed epoch sees the numbers the
    full read builds. Entity-clustered through :func:`plan_entity_chunks_avro`
    when ``cluster_by`` is given. ``chunk_plan``: a precomputed
    (specs, record starts, skips), as :func:`plan_partitioned_game_stream`
    gives each rank."""

    sparse = False

    def __init__(self, files: Sequence[str], shard_configs: "Mapping[str, object]",
                 index_maps: "Mapping[str, object]", *, chunk_records: int,
                 random_effect_id_columns: Sequence[str] = (),
                 entity_vocabs: "Mapping[str, np.ndarray] | None" = None,
                 cluster_by: str | None = None, cluster_keys: np.ndarray | None = None,
                 indexes=None, on_corrupt: str = "raise", dtype=np.float32, chunk_plan=None):
        self.files = [str(f) for f in files]
        self.shard_configs = dict(shard_configs)
        self.index_maps = dict(index_maps)
        self.re_columns = tuple(random_effect_id_columns)
        self.entity_vocabs = dict(entity_vocabs or {})
        self.on_corrupt = on_corrupt
        self.dtype = dtype
        #: payload bytes decoded so far
        self.bytes_decoded = 0
        if chunk_plan is not None:
            plan_specs, plan_starts, plan_skips = chunk_plan
            self.specs = list(plan_specs)
            self.record_starts = [int(s) for s in plan_starts]
            self._skips = [int(s) for s in plan_skips]
            self.indexes = (indexes if indexes is not None else
                            [avro_io.scan_block_index(f, on_corrupt=on_corrupt)
                             for f in self.files])
        elif cluster_by is not None:
            if cluster_keys is None:
                raise ValueError("cluster_by needs cluster_keys (the per-record entity keys "
                                 "collected by scan_game_stream's vocab pass)")
            self.specs, self.indexes, self.record_starts, self._skips = plan_entity_chunks_avro(
                self.files, chunk_records, cluster_keys, indexes=indexes, on_corrupt=on_corrupt)
        else:
            self.specs, self.indexes = plan_chunks(self.files, chunk_records,
                                                   on_corrupt=on_corrupt, indexes=indexes)
            self.record_starts = list(np.concatenate(
                [[0], np.cumsum([s.num_records for s in self.specs])[:-1]]).astype(int)) \
                if self.specs else []
            self._skips = [0] * len(self.specs)
        self.cluster_by = cluster_by
        self.chunk_rows = max((s.num_records for s in self.specs), default=0)
        self.dims = {shard: int(self.index_maps[shard].size) for shard in self.shard_configs}
        self._file_pos = {f: i for i, f in enumerate(self.files)}

    @property
    def num_chunks(self) -> int:
        return len(self.specs)

    @property
    def total_records(self) -> int:
        return int(sum(s.num_records for s in self.specs))

    def load(self, spec: ChunkSpec) -> GameChunk:
        from photon_ml_torch.io.data_reader import records_to_game_dataset

        records: list = []
        payload_bytes = 0
        for path, start, count in spec.runs:
            index = self.indexes[self._file_pos[path]]
            payload_bytes += sum(sz for _, sz, _ in index[start:start + count])
            records.extend(avro_io.read_container_block_range(
                path, start, count, index=index, on_corrupt=self.on_corrupt))
        self.bytes_decoded += payload_bytes
        skip = self._skips[spec.index]
        records = records[skip:skip + spec.num_records]
        ds = records_to_game_dataset(records, self.shard_configs, self.index_maps,
                                     random_effect_id_columns=self.re_columns,
                                     entity_vocabs=self.entity_vocabs, dtype=self.dtype,
                                     device="cpu").dataset
        n = spec.num_records
        pad = self.chunk_rows - n

        def pad1(a, fill=0):
            a = np.asarray(a)
            if pad:
                a = np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
            return a

        start = self.record_starts[spec.index]
        rows = np.arange(start, start + n, dtype=np.int64)
        return GameChunk(
            features={k: pad1(ds.host_array(f"shard/{k}")) for k in self.shard_configs},
            labels=pad1(ds.host_array("labels")), offsets=pad1(ds.host_array("offsets")),
            weights=pad1(ds.host_array("weights")),
            entity_idx={t: pad1(ds.host_array(f"entity_idx/{t}").astype(np.int32), fill=-1)
                        for t in self.re_columns},
            rows=pad1(rows, fill=-1), num_records=n)


def scan_game_stream(files: Sequence[str], shard_configs: "Mapping[str, object]",
                     random_effect_id_columns: Sequence[str], *, cluster_by: str | None = None,
                     on_corrupt: str = "raise", dtype=np.float32):
    """One pass over the input, its records decoded and dropped, collecting
    what a GAME chunk plan needs: the global feature index maps (the full
    read's key set and sort), the entity vocabularies (``np.unique`` of the
    keys, the in-core rule), the per-record keys of ``cluster_by``, the
    per-file block indexes and the ``[n]`` per-sample scalars (labels,
    offsets, weights with the in-core defaults, and entity indices).

    Returns ``(index_maps, entity_vocabs, cluster_keys, indexes, scalars)``;
    ``scalars`` feeds ``StreamingGameProgram(scalars=...)``."""
    from photon_ml_torch.io.data_reader import (
        META_DATA_MAP,
        OFFSET,
        RESPONSE,
        WEIGHT,
        build_index_maps,
    )

    indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
    re_cols = tuple(random_effect_id_columns)
    keys: dict[str, list[str]] = {c: [] for c in re_cols}
    cluster: list[str] = []
    labels: list[float] = []
    offsets: list[float] = []
    weights: list[float] = []

    def records():
        for f in files:
            for record in avro_io.read_container(f, on_corrupt=on_corrupt):
                label = record.get("label", record.get(RESPONSE))
                if label is None:
                    raise ValueError("record has neither 'label' nor 'response'")
                labels.append(float(label))
                offset = record.get(OFFSET)
                offsets.append(0.0 if offset is None else float(offset))
                weight = record.get(WEIGHT)
                weights.append(1.0 if weight is None else float(weight))
                meta = record.get(META_DATA_MAP) or {}
                for c in re_cols:
                    value = meta.get(c, record.get(c))
                    keys[c].append("" if value is None else str(value))
                if cluster_by is not None:
                    value = meta.get(cluster_by, record.get(cluster_by))
                    cluster.append("" if value is None else str(value))
                yield record

    index_maps = build_index_maps(records(), shard_configs)
    vocabs = {c: np.unique(np.asarray(v).astype(str)) for c, v in keys.items()}
    cluster_keys = np.asarray(cluster).astype(str) if cluster_by is not None else None
    # the vocabulary is the sorted set of keys, so searchsorted is the index
    entity_idx = {c: np.searchsorted(vocabs[c], np.asarray(v).astype(str)).astype(np.int32)
                  for c, v in keys.items()}
    scalars = {"labels": np.asarray(labels, dtype=dtype),
               "offsets": np.asarray(offsets, dtype=dtype),
               "weights": np.asarray(weights, dtype=dtype), "entity_idx": entity_idx}
    return index_maps, vocabs, cluster_keys, indexes, scalars


# ---------------------------------------------------------------------------
# Partitioned stream plans: each rank streams its own slice
# ---------------------------------------------------------------------------


def plan_partitioned_stream(path, shard_configs: Mapping[str, object], *, exchange,
                            chunk_records: int, on_corrupt: str = "raise", dtype=np.float32,
                            tag: str = "stream"):
    """Streaming over partitioned I/O for a GLM: each rank gets a chunk
    source over its contiguous block assignment (``partitioned_reader
    .assign_contiguous`` over payload sizes), with index maps agreed over
    the exchange (the union of the ranks' keys, sorted). The rank's vocab
    pass decodes only its blocks. The ranks' plans must share one
    fingerprint. Returns ``(source, index_maps, intercept_indices)``; train
    with ``estimators.train_glm_streaming(source, ..., exchange=exchange)``."""
    from photon_ml_torch.io.data_reader import build_index_maps
    from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap
    from photon_ml_torch.io.partitioned_reader import (
        _local_keys,
        _plan_fingerprint,
        assign_contiguous,
    )

    files = avro_io.list_avro_files(path)
    sizes = [int(os.path.getsize(f)) for f in files]
    indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
    blocks = [(fi, bi, payload) for fi, file_index in enumerate(indexes)
              for bi, (_, payload, _) in enumerate(file_index)]
    if not blocks:
        raise ValueError(f"no Avro blocks under {path!r}")
    ranges = assign_contiguous([b[2] for b in blocks], exchange.num_ranks)
    lo, hi = ranges[exchange.rank]
    my_blocks = [(fi, bi) for fi, bi, _ in blocks[lo:hi]]

    def my_records():
        for spec_fi, group in itertools.groupby(my_blocks, key=lambda b: b[0]):
            bis = [bi for _, bi in group]
            yield from avro_io.read_container_block_range(
                files[spec_fi], bis[0], len(bis), index=indexes[spec_fi], on_corrupt=on_corrupt)

    local_maps = build_index_maps(my_records(), shard_configs)
    payload = {"fingerprint": _plan_fingerprint(files, sizes, "stream-blocks", ranges),
               "keys": {shard: _local_keys(local_maps[shard], cfg)
                        for shard, cfg in shard_configs.items()}}
    gathered = exchange.allgather(f"stream_plan/{tag}", payload)
    fingerprints = {g["fingerprint"] for g in gathered}
    if len(fingerprints) != 1:
        raise RuntimeError(f"ranks disagree on the streaming block plan ({fingerprints}); the "
                           "input listing must be identical on every rank")
    index_maps: dict = {}
    intercepts: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        union: set[str] = set()
        for g in gathered:
            union.update(g["keys"][shard])
        imap = IndexMap.from_keys(union, add_intercept=cfg.has_intercept)
        index_maps[shard] = imap
        if cfg.has_intercept:
            ii = imap.get_index(INTERCEPT_KEY)
            if ii >= 0:
                intercepts[shard] = ii
    shard = next(iter(shard_configs))
    source = AvroChunkSource(files, DenseRecordAssembler(index_maps[shard], shard_configs[shard],
                                                         dtype),
                             chunk_records=chunk_records, on_corrupt=on_corrupt,
                             indexes=indexes, block_subset=my_blocks)
    return source, index_maps, intercepts


@dataclasses.dataclass(frozen=True)
class GameStreamPartition:
    """The multi-rank streamed-GAME plan every rank agrees on (each field is
    a function of the allgathered payloads, the same on every rank).

    ``chunk_ranges[rank]`` is the rank's [lo, hi) of global chunk ids (whole
    chunks, hence whole entities); ``payload_bytes[rank]`` the covering
    blocks' payload that a pass over its chunks decodes."""

    rank: int
    num_ranks: int
    num_chunks: int
    chunk_ranges: "tuple[tuple[int, int], ...]"
    chunk_rows: int
    total_records: int
    payload_bytes: "tuple[int, ...]"
    input_bytes: int
    fingerprint: str

    def chunk_range(self) -> "tuple[int, int]":
        return self.chunk_ranges[self.rank]


def plan_partitioned_game_stream(path, shard_configs: Mapping[str, object],
                                 random_effect_id_columns: Sequence[str], *, exchange,
                                 chunk_records: int, cluster_by: str,
                                 schedule_budget: "Mapping[str, object] | None" = None,
                                 on_corrupt: str = "raise", dtype=np.float32,
                                 tag: str = "stream_game"):
    """Streaming over partitioned I/O for GAME: entity-granular per-rank
    chunk assignments agreed over the exchange.

    Each rank decodes only a provisional contiguous block slice, collecting
    its feature keys, entity keys and a run-length encoding of the
    ``cluster_by`` column. One allgather unions the keys and concatenates
    the runs in rank order (merging a boundary run of one entity); every
    rank then rebuilds the same global entity-clustered chunk plan and
    assigns whole chunks contiguously to ranks. The plan's fields (input
    fingerprint, chunk budget, cluster column, RE columns, rank count,
    schedule budget) are compared field by field, and a disagreement fails
    naming the fields and each rank's value.

    Returns ``(source, index_maps, entity_vocabs, partition)``: a rank-local
    :class:`GameAvroChunkSource` over this rank's chunks (rows renumbered
    from 0), the agreed index maps and vocabularies, and the
    :class:`GameStreamPartition`."""
    from photon_ml_torch.io.data_reader import META_DATA_MAP, build_index_maps
    from photon_ml_torch.io.index_map import IndexMap
    from photon_ml_torch.io.partitioned_reader import (
        _local_keys,
        _plan_fingerprint,
        assign_contiguous,
    )

    if cluster_by is None:
        raise ValueError(
            "plan_partitioned_game_stream needs cluster_by (the RE type whose entities define "
            "chunk grouping) — a multi-rank streamed GAME run without entity clustering would "
            "split entities across ranks")
    re_cols = tuple(random_effect_id_columns)
    files = avro_io.list_avro_files(path)
    sizes = [int(os.path.getsize(f)) for f in files]
    indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
    blocks = [(fi, bi, payload) for fi, file_index in enumerate(indexes)
              for bi, (_, payload, _) in enumerate(file_index)]
    if not blocks:
        raise ValueError(f"no Avro blocks under {path!r}")
    ranges = assign_contiguous([b[2] for b in blocks], exchange.num_ranks)
    lo, hi = ranges[exchange.rank]
    my_blocks = [(fi, bi) for fi, bi, _ in blocks[lo:hi]]

    re_keys: "dict[str, set]" = {c: set() for c in re_cols}
    cluster_runs: "list[list]" = []  # [key, count] runs

    def my_records():
        for spec_fi, group in itertools.groupby(my_blocks, key=lambda b: b[0]):
            bis = [bi for _, bi in group]
            for record in avro_io.read_container_block_range(
                    files[spec_fi], bis[0], len(bis), index=indexes[spec_fi],
                    on_corrupt=on_corrupt):
                meta = record.get(META_DATA_MAP) or {}
                for c in re_cols:
                    value = meta.get(c, record.get(c))
                    re_keys[c].add("" if value is None else str(value))
                value = meta.get(cluster_by, record.get(cluster_by))
                key = "" if value is None else str(value)
                if cluster_runs and cluster_runs[-1][0] == key:
                    cluster_runs[-1][1] += 1
                else:
                    cluster_runs.append([key, 1])
                yield record

    local_maps = build_index_maps(my_records(), shard_configs)
    scan_bytes = sum(indexes[fi][bi][1] for fi, bi in my_blocks)
    budget = (None if schedule_budget is None
              else {k: schedule_budget[k] for k in sorted(schedule_budget)})
    plan_fields = {
        "input": _plan_fingerprint(files, sizes, "stream-game-blocks", ranges),
        "chunk_records": int(chunk_records),
        "cluster_by": str(cluster_by),
        "re_columns": list(re_cols),
        "num_ranks": int(exchange.num_ranks),
        "schedule": budget,
    }
    payload = {"plan": plan_fields,
               "keys": {shard: _local_keys(local_maps[shard], cfg)
                        for shard, cfg in shard_configs.items()},
               "entities": {c: sorted(re_keys[c]) for c in re_cols},
               "cluster_runs": cluster_runs}
    gathered = exchange.allgather(f"stream_game_plan/{tag}", payload)
    diffs = []
    for field in sorted(set().union(*[set(g["plan"]) for g in gathered])):
        values = [g["plan"].get(field) for g in gathered]
        if any(v != values[0] for v in values[1:]):
            diffs.append(f"{field}: " + ", ".join(f"rank{r}={v!r}" for r, v in enumerate(values)))
    if diffs:
        raise RuntimeError(
            "ranks disagree on the partitioned GAME stream plan — refusing to train on a "
            "silently-disagreed plan; differing fields: " + "; ".join(diffs))

    index_maps: dict = {}
    for shard, cfg in shard_configs.items():
        union: "set[str]" = set()
        for g in gathered:
            union.update(g["keys"][shard])
        index_maps[shard] = IndexMap.from_keys(union, add_intercept=cfg.has_intercept)
    vocabs = {c: np.unique(np.asarray(sorted(set().union(
        *[set(g["entities"][c]) for g in gathered]))).astype(str)) for c in re_cols}

    # the global cluster runs, in rank order; a boundary run of one entity
    # merges (it must land in one chunk)
    run_keys: "list[str]" = []
    run_counts: "list[int]" = []
    for g in gathered:
        for key, count in g["cluster_runs"]:
            if run_keys and run_keys[-1] == key:
                run_counts[-1] += int(count)
            else:
                run_keys.append(key)
                run_counts.append(int(count))
    total = int(sum(run_counts))
    index_total = sum(n for file_index in indexes for (n, _, _) in file_index)
    if total != index_total:
        raise RuntimeError(
            f"rank-local scans cover {total} records but the block index holds {index_total} "
            "— the input changed between the block scan and the key scan; re-run against a "
            "quiesced input")
    splittable = np.zeros(total + 1, dtype=bool)
    splittable[0] = True
    splittable[total] = True
    if run_counts:
        ends = np.cumsum(np.asarray(run_counts, dtype=np.int64))
        splittable[ends[:-1]] = True
    if chunk_records <= 0:
        raise ValueError(f"chunk_records must be positive, got {chunk_records}")
    specs, starts, skips = _entity_chunks_over_blocks(files, indexes, chunk_records, splittable)
    chunk_ranges = assign_contiguous([s.num_records for s in specs], exchange.num_ranks)
    empty = [r for r, (clo, chi) in enumerate(chunk_ranges) if chi <= clo]
    if empty:
        raise ValueError(
            f"the entity-clustered plan has {len(specs)} chunks for {exchange.num_ranks} ranks "
            f"— ranks {empty} would stream nothing; use a smaller --streaming-chunks budget "
            "(more chunks) or fewer ranks")
    file_pos = {f: i for i, f in enumerate(files)}

    def rank_payload(clo: int, chi: int) -> int:
        cover: "set[tuple[int, int]]" = set()
        for s in specs[clo:chi]:
            for run_path, start, count in s.runs:
                fi = file_pos[run_path]
                cover.update((fi, bi) for bi in range(start, start + count))
        return int(sum(indexes[fi][bi][1] for fi, bi in cover))

    payload_bytes = tuple(rank_payload(clo, chi) for clo, chi in chunk_ranges)
    fingerprint = hashlib.sha256(json.dumps(
        [plan_fields, starts, [list(r) for r in chunk_ranges]], sort_keys=True).encode()
    ).hexdigest()[:16]
    partition = GameStreamPartition(
        rank=int(exchange.rank), num_ranks=int(exchange.num_ranks), num_chunks=len(specs),
        chunk_ranges=tuple((int(a), int(b)) for a, b in chunk_ranges),
        chunk_rows=max(s.num_records for s in specs), total_records=total,
        payload_bytes=payload_bytes, input_bytes=int(sum(sizes)), fingerprint=fingerprint)
    clo, chi = chunk_ranges[exchange.rank]
    local_specs = [dataclasses.replace(s, index=i) for i, s in enumerate(specs[clo:chi])]
    base = starts[clo]
    source = GameAvroChunkSource(
        files, shard_configs, index_maps, chunk_records=chunk_records,
        random_effect_id_columns=re_cols, entity_vocabs=vocabs, cluster_by=cluster_by,
        indexes=indexes, on_corrupt=on_corrupt, dtype=dtype,
        chunk_plan=(local_specs, [starts[c] - base for c in range(clo, chi)],
                    [skips[c] for c in range(clo, chi)]))
    source.scan_bytes = scan_bytes
    return source, index_maps, vocabs, partition
