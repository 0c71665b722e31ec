"""Rank-0-only JSONL run journal, atomically finalized into the output dir
(the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/journal.py``; reference photon-lib
util/PhotonLogger.scala:34-90 (spool locally, publish to the final
destination on close) crossed with PhotonOptimizationLogEvent /
OptimizationStatesTracker.scala:82-101. Every driver and estimator phase
appends typed records (phase timings, convergence rows, config summaries)
to a spool file, and ``close()`` moves it atomically to
``<dir>/run-journal.jsonl``.

Only rank 0 writes into shared output directories, while collectives still
run on every rank: a journal built on a rank > 0 is inert (every method is
a no-op), so callers never branch on the rank themselves.

With ``durable=True`` (the default) the spool is the staged file
``<dir>/<filename>.partial`` and every row is appended and fsync'd, so a
killed run leaves a readable journal; ``close()`` publishes it with one
``os.replace``. Heartbeat rows carry a progress cursor plus the registry's
counter deltas since the previous heartbeat.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import math
import os
import tempfile
import threading
import time

JOURNAL_FILENAME = "run-journal.jsonl"
#: suffix of the crash-durable stage file a live or killed run is readable at
JOURNAL_PARTIAL_SUFFIX = ".partial"


def _process_index() -> int:
    """The rank of this process in the ``torch.distributed`` group; 0 when
    no group is initialized."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def json_safe(obj):
    """Recursively coerce to strict-JSON values: numpy scalars and arrays,
    torch tensors (read to the host), enums, dataclasses; NaN/Inf become
    None (the driver summary convention)."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [json_safe(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return json_safe(dataclasses.asdict(obj))
    detach = getattr(obj, "detach", None)
    if detach is not None and hasattr(obj, "cpu"):  # a torch tensor: one host copy
        obj = detach().cpu().numpy()
    # numpy scalars and arrays without importing numpy
    item = getattr(obj, "item", None)
    shape = getattr(obj, "shape", None)
    if item is not None and shape == ():
        return json_safe(item())
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return json_safe(tolist())
    return str(obj)


#: fields the journal stamps onto every heartbeat row itself; everything
#: else in the row is the caller's progress cursor
_HEARTBEAT_BOOKKEEPING = frozenset(
    {"kind", "seq", "ts", "elapsed_ms", "counter_deltas", "gauges",
     "hbm_bytes", "compiles"}
)


def _live_hbm_bytes() -> "int | None":
    """Bytes the caching allocator holds for tensors on the current CUDA
    device; None unless CUDA is already initialized in this process (a
    heartbeat never initializes it, and a CPU run has no device memory to
    report)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    try:
        return int(torch.cuda.memory_allocated())
    except RuntimeError:
        return None


def heartbeat_cursor(row: dict) -> dict:
    """The caller-supplied progress cursor of one ``heartbeat`` row, with
    the journal's own bookkeeping fields stripped."""
    return {k: v for k, v in row.items() if k not in _HEARTBEAT_BOOKKEEPING}


class RunJournal:
    """``with RunJournal(out_dir) as j: j.record("phase_timing", ...)``.

    Records are dicts with a ``kind`` plus caller fields; ``seq``, ``ts``
    (wall clock) and ``elapsed_ms`` (monotonic since the journal opened)
    are stamped automatically. Inactive (rank > 0, or ``directory=None``)
    journals accept every call and write nothing.
    """

    def __init__(
        self,
        directory: str | os.PathLike | None,
        *,
        filename: str = JOURNAL_FILENAME,
        rank: int | None = None,
        durable: bool = True,
    ):
        self.directory = None if directory is None else str(directory)
        self.filename = filename
        self.rank = _process_index() if rank is None else int(rank)
        self.durable = bool(durable)
        self._seq = 0
        self._spool = None
        self._closed = False
        # several threads may write (the serve driver's swap poller): the
        # seq stamp and the write/flush/fsync are one atomic unit
        self._lock = threading.Lock()
        self._hb_counters: dict[str, int] = {}
        self._t0 = time.perf_counter()
        if self.active:
            if self.durable:
                # the spool is the stage file in the destination directory
                # (os.replace is atomic only within one filesystem)
                os.makedirs(self.directory, exist_ok=True)
                self._spool = open(self.partial_path, "w")
            else:
                self._spool = tempfile.NamedTemporaryFile(
                    mode="w", suffix=".jsonl", prefix="photon-journal-", delete=False)
            self.record("journal_open", pid=os.getpid(), rank=self.rank)

    @property
    def active(self) -> bool:
        return self.directory is not None and self.rank == 0 and not self._closed

    @property
    def path(self) -> str | None:
        """Final journal path (exists only after ``close()``)."""
        if self.directory is None:
            return None
        return os.path.join(self.directory, self.filename)

    @property
    def partial_path(self) -> str | None:
        """The crash-durable stage file a live (or killed) durable run is
        readable at."""
        if self.directory is None:
            return None
        return os.path.join(self.directory, self.filename + JOURNAL_PARTIAL_SUFFIX)

    def record(self, kind: str, **fields) -> None:
        if not self.active:
            return
        payload = json_safe(fields)
        with self._lock:
            if not self.active:  # closed while we serialized
                return
            row = {
                "kind": kind,
                "seq": self._seq,
                "ts": time.time(),
                "elapsed_ms": round((time.perf_counter() - self._t0) * 1e3, 3),
            }
            row.update(payload)
            self._seq += 1
            self._spool.write(json.dumps(row, allow_nan=False) + "\n")
            self._spool.flush()
            if self.durable:
                # a kill between rows loses at most the row being written
                os.fsync(self._spool.fileno())

    def record_timings(self, timings: dict[str, dict[str, float]]) -> None:
        """One ``phase_timing`` row per named phase, the shape
        ``util.timed.timing_summary()`` returns."""
        for name, summary in timings.items():
            self.record("phase_timing", name=name, **summary)

    def record_metrics(self, snapshot: dict) -> None:
        """Persist a full ``MetricsRegistry.snapshot()``."""
        self.record("metrics", snapshot=snapshot)

    def record_gauge(self, name: str, value) -> None:
        self.record("gauge", name=name, value=value)

    def heartbeat(self, *, registry=None, **cursor) -> None:
        """One liveness row: the caller's progress cursor plus the
        registry's counter deltas since the previous heartbeat and its
        current gauges. Observe-only."""
        if not self.active:
            return
        fields = dict(cursor)
        hbm = _live_hbm_bytes()
        if hbm is not None:
            fields["hbm_bytes"] = hbm
        if registry is not None:
            snap = registry.snapshot()
            counters = {str(k): int(v) for k, v in (snap.get("counters") or {}).items()}
            deltas = {k: v - self._hb_counters.get(k, 0) for k, v in counters.items()
                      if v != self._hb_counters.get(k, 0)}
            self._hb_counters = counters
            if deltas:
                fields["counter_deltas"] = deltas
            gauges = {k: v for k, v in (snap.get("gauges") or {}).items() if v is not None}
            if gauges:
                fields["gauges"] = gauges
        self.record("heartbeat", **fields)

    def close(self) -> None:
        """Atomically publish the spool as ``<directory>/<filename>``."""
        if self._closed or self._spool is None:
            self._closed = True
            return
        self.record("journal_close", records=self._seq)
        with self._lock:
            # a writer thread blocked on the lock re-checks `active` after
            # acquiring it, so nothing writes once the spool is closed
            self._closed = True
            self._spool.flush()
            os.fsync(self._spool.fileno())
            self._spool.close()
        if self.durable:
            os.replace(self._spool.name, self.path)
            return
        os.makedirs(self.directory, exist_ok=True)
        # stage in the destination directory first: os.replace is atomic
        # only within one filesystem, and the spool lives in the system tmp
        fd, staged = tempfile.mkstemp(dir=self.directory, prefix=".journal-", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as dst, open(self._spool.name, "rb") as src:
                dst.write(src.read())
            os.replace(staged, self.path)
        except BaseException:
            if os.path.exists(staged):
                os.unlink(staged)
            raise
        finally:
            os.unlink(self._spool.name)

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @staticmethod
    def read(path: str | os.PathLike) -> list[dict]:
        """Parse a finalized journal back into a list of record dicts."""
        return read_journal(path, tolerant=False)


def read_journal(path: str | os.PathLike, *, tolerant: bool = False) -> list[dict]:
    """Parse a JSONL journal. ``tolerant=True`` skips unparseable lines:
    the shape of a ``.partial`` stage whose last row was cut mid-write."""
    records: list[dict] = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if not tolerant:
                    raise
    return records
