"""Chunked out-of-core input for streamed GLM solves: the GLM half of the
JAX package's ``photon_ml_tpu/io/stream_reader.py`` (its lines 1-306 and
871-1251).

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
import itertools
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
