"""Cross-rank run tracing: host-side spans, Chrome-trace export, straggler
attribution (the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/tracing.py``; reference photon-lib
util/Timed.scala:21-34 (wall-clock phase blocks) crossed with
util/PhotonLogger.scala:34-90 (spool locally, publish atomically). A run of
several ranks needs to know where the wall-clock went (decode, exchange
wait, device dispatch, checkpoint barrier) and which rank is the
straggler:

- ``span(name, **attrs)`` — a context manager over ``time.perf_counter``
  recording (name, category, start, duration, attrs) into a per-thread
  ring buffer. With no tracer installed it returns a shared null object.
  A span times the host only: it adds no ``torch.cuda.synchronize``, no
  host read of a device tensor and no collective, and never adds, skips,
  reorders or retries an exchange.
- Chrome-trace export: ``publish_trace`` writes ``trace-{rank:05d}.json``
  (complete ``"X"`` events, ``pid`` = rank, ``tid`` = thread) atomically
  into the trace directory: rank 0 creates it, a barrier, then every rank
  writes its own file. On the failure path a barrier that times out falls
  back to an unbarriered write, so a crash still leaves a timeline.
- Straggler attribution: every exchange op (``parallel/multihost.py``)
  records its blocking wait as a span carrying ``tag`` and ``rank``;
  ``exchange_wait_tables`` totals the waits per rank and tag, and
  ``straggler_report`` names, for every tag, the rank that arrived last
  (least wait) or never arrived. ``gather_straggler_report`` merges the
  per-rank tables through the run's ``MetadataExchange`` at run end.

Span durations are host wall-clock only; device time comes from
``util.timed.profile_trace`` (the drivers' ``--profile-dir``). Compare
fractions within one trace, not absolute span times across runs.
"""

from __future__ import annotations

import json
import logging
import os
import re
import tempfile
import threading
import time
from typing import Iterator, Mapping, NamedTuple

logger = logging.getLogger(__name__)

TRACE_FILE_FORMAT = "trace-{rank:05d}.json"

#: category carried by top-level exchange wait spans (allgather/barrier) —
#: the ONLY spans the straggler wait tables aggregate
EXCHANGE_CAT = "exchange"
#: category for point-to-point KV transport sub-operations (kv_get/kv_set):
#: visible in the timeline, excluded from the wait tables (their parent
#: allgather span already carries the full wait)
EXCHANGE_IO_CAT = "exchange_io"

#: span names aggregated into the per-tag exchange wait tables
_WAIT_SPAN_NAMES = frozenset({"exchange/allgather", "exchange/barrier"})

#: per-thread ring capacity (events); oldest events are overwritten —
#: bounded memory no matter how long a run traces
DEFAULT_CAPACITY = 65536


def _process_index() -> int:
    """The rank of this process in the ``torch.distributed`` group; 0 when
    no group is initialized (the journal's rank rule)."""
    from photon_ml_torch.telemetry.journal import _process_index as rank

    return rank()


class TraceEvent(NamedTuple):
    name: str
    cat: str
    start: float  # seconds since tracer start (perf_counter delta)
    dur: float  # seconds
    thread_id: int
    thread_name: str
    attrs: dict | None


class _Ring:
    """Fixed-capacity single-writer ring: the owning thread appends with no
    lock (plain list-slot assignment under the GIL); readers snapshot after
    the traced work quiesces."""

    __slots__ = ("items", "n", "cap")

    def __init__(self, capacity: int):
        self.items: list = [None] * capacity
        self.n = 0
        self.cap = capacity

    def append(self, item) -> None:
        self.items[self.n % self.cap] = item
        self.n += 1

    def snapshot(self) -> list:
        if self.n <= self.cap:
            return [e for e in self.items[: self.n]]
        k = self.n % self.cap
        return self.items[k:] + self.items[:k]

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)


class Tracer:
    """Collects spans from every thread of this process into per-thread
    ring buffers. One tracer per process (rank); install it with
    :func:`install_tracer` so the module-level :func:`span` hook feeds it.
    """

    def __init__(self, rank: int | None = None, *,
                 capacity: int = DEFAULT_CAPACITY):
        self.rank = _process_index() if rank is None else int(rank)
        self.capacity = max(16, int(capacity))
        self._t0_perf = time.perf_counter()
        # absolute wall anchor for cross-rank correlation with journal
        # ``ts`` rows; every duration in this module is a perf_counter
        # difference
        self.wall_t0 = time.time()
        self._local = threading.local()
        self._threads: list[tuple[int, str, _Ring]] = []
        self._lock = threading.Lock()  # buffer registration + export only

    # -- recording (hot path: no locks) --------------------------------------

    def _buffer(self) -> _Ring:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = _Ring(self.capacity)
            self._local.buf = buf
            t = threading.current_thread()
            with self._lock:
                # key by registration index, not thread ident: the OS
                # reuses idents, and two short-lived threads must not
                # merge into one timeline lane
                self._threads.append((len(self._threads), t.name, buf))
        return buf

    def record(self, name: str, cat: str, t_start: float, dur: float,
               attrs: dict | None) -> None:
        """t_start: absolute ``perf_counter`` reading at span entry."""
        self._buffer().append(
            (name, cat, t_start - self._t0_perf, dur, attrs)
        )

    # -- reading --------------------------------------------------------------

    def events(self) -> Iterator[TraceEvent]:
        with self._lock:
            threads = list(self._threads)
        for tid, tname, ring in threads:
            for name, cat, start, dur, attrs in ring.snapshot():
                yield TraceEvent(name, cat, start, dur, tid, tname, attrs)

    def dropped_events(self) -> int:
        with self._lock:
            return sum(ring.dropped for _, _, ring in self._threads)

    # -- Chrome-trace export ---------------------------------------------------

    def chrome_trace(self) -> dict:
        """Catapult/Perfetto JSON object: complete ``"X"`` events with µs
        timestamps, ``pid`` = rank (a span's explicit ``rank=`` attr wins —
        virtual-rank tests separate lanes that way), ``tid`` = a small
        stable per-thread index with ``thread_name`` metadata."""
        from photon_ml_torch.telemetry.journal import json_safe

        events: list[dict] = []
        pids: set[int] = {self.rank}
        with self._lock:
            threads = list(self._threads)
        for tid, tname, _ in threads:
            events.append({
                "ph": "M", "name": "thread_name", "pid": self.rank,
                "tid": tid, "args": {"name": tname},
            })
        for ev in self.events():
            pid = self.rank
            if ev.attrs and "rank" in ev.attrs:
                pid = int(ev.attrs["rank"])
                pids.add(pid)
            events.append({
                "ph": "X",
                "name": ev.name,
                "cat": ev.cat,
                "ts": ev.start * 1e6,
                "dur": ev.dur * 1e6,
                "pid": pid,
                "tid": ev.thread_id,
                "args": json_safe(ev.attrs or {}),
            })
        meta = [
            {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"rank {pid}"}}
            for pid in sorted(pids)
        ]
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "otherData": {
                "rank": self.rank,
                "wall_t0": self.wall_t0,
                "dropped_events": self.dropped_events(),
            },
        }


# ---------------------------------------------------------------------------
# The module-level span hook (inert by default)
# ---------------------------------------------------------------------------


_TRACER: Tracer | None = None


class _NullSpan:
    """Shared do-nothing span: the off path allocates nothing per call
    beyond the keyword dict Python builds for the ``span(...)`` call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_attrs", "_t0")

    def __init__(self, tracer: Tracer, name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        attrs = self._attrs
        if exc_type is not None:
            # the span records even when the traced call raises — an
            # ExchangeTimeout's wait leading up to the deadline is exactly
            # the straggler evidence
            attrs = dict(attrs) if attrs else {}
            attrs["error"] = exc_type.__name__
        self._tracer.record(self._name, self._cat, self._t0, dur,
                            attrs or None)
        return False


def span(name: str, *, cat: str = "span", **attrs):
    """``with span("io/decode_chunk", chunk=3): ...`` — records a complete
    event into the installed tracer; a shared null object when tracing is
    off (the default)."""
    tracer = _TRACER
    if tracer is None:
        return _NULL_SPAN
    return _Span(tracer, name, cat, attrs)


def tracing_active() -> bool:
    return _TRACER is not None


def current_tracer() -> Tracer | None:
    return _TRACER


def install_tracer(tracer: Tracer) -> Tracer:
    """Make ``tracer`` the process-wide span sink. Returns it."""
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall_tracer() -> Tracer | None:
    """Remove (and return) the installed tracer — callers pair this with
    install in a try/finally so a failed run never leaks tracing into the
    next one."""
    global _TRACER
    tracer, _TRACER = _TRACER, None
    return tracer


# ---------------------------------------------------------------------------
# Straggler attribution
# ---------------------------------------------------------------------------

_DIGITS_RE = re.compile(r"\d+")


def normalize_tag(tag: str) -> str:
    """Aggregation key for exchange tags: digit runs collapse to ``*`` so
    per-step/per-seq tags (``checkpoint_commit/7/ready``) pool into one
    row instead of one row per step."""
    return _DIGITS_RE.sub("*", tag)


def exchange_wait_tables(tracer: Tracer) -> dict[int, dict[str, dict]]:
    """Per-rank per-tag exchange wait totals from this tracer's spans:
    ``{rank: {tag: {"count", "wait_s", "max_s"}}}``. Rank comes from each
    span's ``rank`` attr (the exchange objects stamp it), so one shared
    tracer over virtual in-process ranks separates correctly; a real
    multi-process tracer simply holds its own rank only."""
    tables: dict[int, dict[str, dict]] = {}
    for ev in tracer.events():
        if ev.name not in _WAIT_SPAN_NAMES:
            continue
        attrs = ev.attrs or {}
        rank = int(attrs.get("rank", tracer.rank))
        tag = normalize_tag(str(attrs.get("tag", "")))
        row = tables.setdefault(rank, {}).setdefault(
            tag, {"count": 0, "wait_s": 0.0, "max_s": 0.0}
        )
        row["count"] += 1
        row["wait_s"] += ev.dur
        row["max_s"] = max(row["max_s"], ev.dur)
    return tables


def straggler_report(
    tables: Mapping[int, Mapping[str, dict]],
    *,
    num_ranks: int | None = None,
) -> dict:
    """Merge per-rank wait tables into the diagnostic: for every exchange
    tag, who arrived last?

    The rank with the LEAST total wait arrived last (everyone else's wait
    on that tag is time spent waiting for it); a rank with NO entry for a
    tag the others waited on never arrived at all (crashed or wedged),
    and is named ahead of any wait comparison. Single-rank tags are reported with no straggler.
    """
    if num_ranks is None:
        num_ranks = (max(tables) + 1) if tables else 1
    tags: set[str] = set()
    for table in tables.values():
        tags.update(table)
    rows = []
    for tag in sorted(tags):
        waits = []
        counts = []
        for r in range(num_ranks):
            entry = tables.get(r, {}).get(tag)
            waits.append(None if entry is None else entry["wait_s"])
            counts.append(0 if entry is None else entry["count"])
        present = [r for r in range(num_ranks) if waits[r] is not None]
        missing = [r for r in range(num_ranks) if waits[r] is None]
        if missing and present:
            straggler, reason = missing[0], "never_arrived"
        elif len(present) > 1:
            straggler = min(present, key=lambda r: waits[r])
            reason = "least_wait"
        else:
            straggler, reason = None, "single_rank"
        rows.append({
            "tag": tag,
            "wait_s": waits,
            "count": counts,
            "missing_ranks": missing if present else [],
            "straggler_rank": straggler,
            "reason": reason,
        })
    # the tags costing the run the most wait first — the line a human
    # pastes into a slow-run report
    rows.sort(key=lambda r: -sum(w or 0.0 for w in r["wait_s"]))
    return {"num_ranks": num_ranks, "tags": rows}


def gather_straggler_report(tracer: Tracer, exchange) -> dict:
    """Run-end merge through the existing ``MetadataExchange``: every rank
    sends ITS per-tag wait table + ring-drop count (one model-free small
    payload), every rank computes the same merged report (SPMD discipline
    — every rank must call; rank 0 is the one that journals it). The
    per-rank ``dropped_events`` list makes ring-buffer truncation visible
    in the report itself: a rank whose early exchange spans were evicted
    undercounts its waits, and the reader must know."""
    local = exchange_wait_tables(tracer).get(exchange.rank, {})
    gathered = exchange.allgather(
        "trace/straggler_table",
        {"table": local, "dropped": tracer.dropped_events()},
    )
    tables = {r: g["table"] for r, g in enumerate(gathered)}
    report = straggler_report(tables, num_ranks=exchange.num_ranks)
    report["dropped_events"] = [int(g["dropped"]) for g in gathered]
    return report


# ---------------------------------------------------------------------------
# Publication (score-writer directory discipline, journal atomicity)
# ---------------------------------------------------------------------------


def trace_path(directory: str | os.PathLike, rank: int) -> str:
    return os.path.join(str(directory), TRACE_FILE_FORMAT.format(rank=rank))


def publish_trace(tracer: Tracer, directory: str | os.PathLike, *,
                  exchange=None) -> str:
    """Atomically write this rank's ``trace-{rank:05d}.json``.

    Multi-rank (an exchange with num_ranks > 1): rank 0 creates the
    directory, a barrier, then EVERY rank writes its own part file —
    the ``io/score_writer.py`` carve-out to the rank-0-only rule; ranks
    never write each other's files. The barrier rides the exchange's
    bounded deadline: on the failure path (some rank already dead) the
    ``ExchangeTimeout`` is logged and the write proceeds unbarriered
    (``makedirs(exist_ok=True)``) so a crash still publishes a readable
    timeline — trace parts are per-rank files, so the fallback cannot
    collide.
    """
    from photon_ml_torch.resilience.errors import ExchangeTimeout

    directory = str(directory)
    if exchange is not None and exchange.num_ranks > 1:
        if exchange.rank == 0:
            os.makedirs(directory, exist_ok=True)
        try:
            exchange.barrier("trace/output_dir")
        except ExchangeTimeout as e:
            logger.warning(
                "trace publish barrier timed out (%s); publishing "
                "unbarriered — some rank likely died, its trace part may "
                "be missing", e,
            )
    os.makedirs(directory, exist_ok=True)
    path = trace_path(directory, tracer.rank)
    payload = json.dumps(tracer.chrome_trace())
    fd, staged = tempfile.mkstemp(
        dir=directory, prefix=f".trace-{tracer.rank:05d}-", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(staged, path)
    except BaseException:
        if os.path.exists(staged):
            os.unlink(staged)
        raise
    return path


def finalize_trace(tracer: Tracer, directory: str | os.PathLike, *,
                   exchange=None, gather: bool = True) -> dict:
    """The drivers' one flush call: publish this rank's trace file, then
    build the straggler report — merged across ranks through the exchange
    on the success path (``gather=True`` with a multi-rank exchange), from
    this tracer's local tables otherwise (single process, or the failure
    path where another collective could hang on the dead rank). On a
    MIXED-outcome run (this rank succeeded, another died before its
    run-end trace collectives) the merge allgather's bounded
    ``ExchangeTimeout`` degrades to the local report — it must never mask
    a successful result. Callers journal the returned report BEFORE
    closing the journal, so spans are flushed to disk first and a crash
    leaves a readable timeline."""
    from photon_ml_torch.resilience.errors import ExchangeTimeout

    publish_trace(tracer, directory,
                  exchange=exchange if gather else None)
    if gather and exchange is not None and exchange.num_ranks > 1:
        try:
            return gather_straggler_report(tracer, exchange)
        except ExchangeTimeout as e:
            logger.warning(
                "straggler merge timed out (%s); reporting this rank's "
                "local wait tables only", e,
            )
    # local fallback: report over the ranks this tracer actually OBSERVED
    # (all of them for a shared virtual-rank tracer; just this rank on a
    # real multi-process run — never blame unobserved peers as
    # "never_arrived" when their tables simply did not merge). A PARTIAL
    # report is flagged so the reader knows to merge the per-rank trace
    # files offline for the full picture.
    tables = exchange_wait_tables(tracer)
    report = straggler_report(tables)
    report["dropped_events"] = [tracer.dropped_events()]
    if exchange is not None and exchange.num_ranks > len(tables):
        # keep report["num_ranks"] == the universe its wait_s lists are
        # indexed by (the observed ranks); the true rank count rides a
        # separate field
        report["partial"] = True
        report["observed_ranks"] = sorted(tables)
        report["expected_num_ranks"] = exchange.num_ranks
    return report


def flush_trace_best_effort(tracer: Tracer, directory: str | os.PathLike, *,
                            exchange=None, gather: bool = True,
                            journal=None) -> dict | None:
    """Driver-teardown wrapper around :func:`finalize_trace` that NEVER
    raises: tracing is observability — a publication error (unwritable
    trace dir, a dead KV coordinator) in a ``finally`` would otherwise
    replace the run's own outcome and skip the journal rows that follow
    (the failure-path journal is the artifact that most needs to
    survive). Every error is logged with its traceback."""
    try:
        report = finalize_trace(tracer, directory, exchange=exchange,
                                gather=gather)
        if journal is not None:
            journal.record("straggler_report", **report)
        return report
    except Exception:
        logger.exception(
            "trace publication failed; continuing teardown (the run's own "
            "outcome and journal take precedence)"
        )
        return None
