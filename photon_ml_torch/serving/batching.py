"""Request queue and deadline-aware micro-batching loop for the resident
scorer.

Counterpart of ``photon_ml_tpu/serving/batching.py``; reference
photon-client cli/game/scoring/GameScoringDriver.scala (:133-194) scores one
partitioned dataset a job. An online service instead coalesces a stream of
small requests: a bounded queue feeds ONE consumer thread that flushes a
micro-batch on max-batch-rows or max-wait, whichever comes first, merges the
requests into one GameDataset (``concat_game_datasets``) and scores it with
one bucketed replay of :class:`serving.resident.ResidentScorer`; every
micro-batch costs a fixed host and launch overhead, so requests per
micro-batch is the throughput lever.

Failure discipline:

- **A poisoned request fails that request, never the loop.** A batch-level
  failure is classified (``resilience.classify_exception``) and then each
  request is re-scored alone, so only the poisoned one surfaces, as a
  :class:`RequestError` carrying its request id, while the rest resolve and
  the loop keeps serving.
- **A sticky CUDA error stops the server** (a difference from the JAX
  package, whose loop isolates every failure). Such an error
  (``resilience.CUDA_STICKY_PATTERNS``: an illegal address, a launch
  failure) leaves the CUDA context unusable, so per-request isolation would
  score later requests on a broken context. The loop fails the batch and
  every queued future with a :class:`ServeError` carrying the error, and
  stops; ``submit`` then raises.
- **Nothing waits unbounded.** ``submit`` times out typed when the bounded
  queue stays full; ``ServeFuture.result`` times out typed
  (:class:`ServeTimeout`); ``stop()`` joins the consumer with a bounded
  deadline and fails any still-queued futures.
- **Observable.** Per-request latency (``time.perf_counter``, submit to
  resolve), queue depth and the request, batch and pad counters feed the
  process-wide registry (``telemetry/serving_counters.py``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np

from photon_ml_torch.data.game_data import GameDataset, concat_game_datasets
from photon_ml_torch.resilience import CUDA_STICKY_PATTERNS, classify_exception
from photon_ml_torch.telemetry import serving_counters

#: default flush deadline: a request waits at most this long for batch
#: company before the loop dispatches what it has
DEFAULT_MAX_WAIT_MS = 2.0

#: default bounded queue depth; submit times out typed when exceeded
DEFAULT_QUEUE_DEPTH = 1024

#: default bound on ServeFuture.result — generous for a capture on a first
#: request, bounded so a wedged consumer surfaces typed instead of hanging
DEFAULT_RESULT_TIMEOUT = 60.0

#: bounded join for the consumer thread at stop()
JOIN_TIMEOUT = 10.0


class ServeError(RuntimeError):
    """Serving-layer failure (queue rejected, server stopped)."""


class RequestError(ServeError):
    """ONE request failed (poisoned input or scoring error); the message
    carries the request id. The serving loop itself keeps running."""


class ServeTimeout(ServeError):
    """A bounded serving deadline expired (result wait, queue admission) —
    the typed hang-free surface of a wedged consumer."""


class ServeFuture:
    """Result handle for one submitted request."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._event = threading.Event()
        self._scores: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block (bounded) for the request's scores; raises the request's
        own typed failure, or :class:`ServeTimeout` when no result arrives
        within ``timeout`` (default DEFAULT_RESULT_TIMEOUT) — a wedged
        serving loop surfaces here, attributed, never as a hang."""
        bound = DEFAULT_RESULT_TIMEOUT if timeout is None else float(timeout)
        if not self._event.wait(bound):
            raise ServeTimeout(
                f"request {self.request_id!r}: no result within "
                f"{bound:.1f}s (wedged serving loop?)"
            )
        if self._error is not None:
            raise self._error
        return self._scores

    def _resolve(self, scores: np.ndarray) -> None:
        # first write wins: a stop()-drain fail racing a late consumer
        # resolve must not leave a future carrying both states
        if self._event.is_set():
            return
        self._scores = scores
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        if self._event.is_set():
            return
        self._error = error
        self._event.set()


@dataclasses.dataclass
class _Queued:
    request_id: str
    dataset: GameDataset
    future: ServeFuture
    rows: int
    t_submit: float


class MicroBatchServer:
    """Bounded-queue micro-batching loop over a :class:`ResidentScorer`.

    Use as a context manager (or ``start()``/``stop()``); ``submit`` a
    GameDataset request, hold the returned :class:`ServeFuture`. The loop
    flushes a micro-batch when queued rows reach ``max_batch_rows``
    (default: the scorer's largest bucket) or the oldest queued request
    has waited ``max_wait_ms`` — whichever comes first.
    """

    def __init__(
        self,
        scorer,
        *,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        max_batch_rows: int | None = None,
        queue_depth: int = DEFAULT_QUEUE_DEPTH,
        submit_timeout: float = 1.0,
    ):
        self.scorer = scorer
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_batch_rows = int(
            max_batch_rows if max_batch_rows is not None
            else scorer.shapes[-1]
        )
        if self.max_batch_rows <= 0:
            raise ValueError("max_batch_rows must be positive")
        self.submit_timeout = float(submit_timeout)
        self._queue: "queue.Queue[_Queued]" = queue.Queue(
            maxsize=max(1, int(queue_depth))
        )
        self._carry: _Queued | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._seq = 0
        self._seq_lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatchServer":
        if self._thread is not None:
            raise ServeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._serve_loop, name="serve-microbatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent bounded shutdown: the consumer joins within
        JOIN_TIMEOUT and every still-queued request fails typed (never a
        silently-lost future)."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=JOIN_TIMEOUT)
        leftovers = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        try:
            while True:
                leftovers.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        for item in leftovers:
            item.future._fail(ServeError(
                f"request {item.request_id!r}: server stopped before "
                "serving it"
            ))

    def __enter__(self) -> "MicroBatchServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def swap_model(self, new_model) -> None:
        """Model refresh against a live serving loop: the scorer's guarded
        swap (``ResidentScorer.swap_model``) while the consumer keeps
        draining the queue. A micro-batch is scored wholly by the model
        current when it takes the scorer's lock; a layout-changing swap
        raises ``ModelSwapError`` naming the differing fields and the loop
        keeps serving the resident model."""
        self.scorer.swap_model(new_model)

    # -- producer side -------------------------------------------------------

    def submit(self, dataset: GameDataset,
               request_id: str | None = None) -> ServeFuture:
        """Enqueue one request; returns its future. Raises
        :class:`ServeTimeout` when the bounded queue stays full past
        ``submit_timeout`` (backpressure surfaces at the caller, typed),
        :class:`ServeError` when the server is not running."""
        if self._thread is None or self._stop.is_set():
            raise ServeError("server is not running (call start())")
        if dataset.num_samples == 0:
            raise ValueError("empty request dataset")
        with self._seq_lock:
            self._seq += 1
            rid = request_id if request_id is not None else f"req-{self._seq}"
        item = _Queued(
            request_id=rid,
            dataset=dataset,
            future=ServeFuture(rid),
            rows=dataset.num_samples,
            t_submit=time.perf_counter(),
        )
        try:
            self._queue.put(item, timeout=self.submit_timeout)
        except queue.Full:
            raise ServeTimeout(
                f"request {rid!r}: queue full "
                f"(depth {self._queue.maxsize}) for "
                f"{self.submit_timeout:.1f}s — the serving loop is not "
                "keeping up"
            ) from None
        serving_counters.record_request()
        serving_counters.set_queue_depth(self._queue.qsize())
        if self._stop.is_set() and not item.future.done():
            # the put raced a concurrent stop(): its drain may already
            # have missed this item, which would otherwise stall the
            # caller into a misattributed ServeTimeout — fail it typed
            # here (first write wins, so a consumer that did serve it in
            # the window keeps its result)
            item.future._fail(ServeError(
                f"request {rid!r}: server stopped before serving it"
            ))
        return item.future

    # -- consumer side -------------------------------------------------------

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            first = self._carry
            self._carry = None
            if first is None:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    continue
            batch = [first]
            rows = first.rows
            # the flush window opens when the batch starts FORMING, not at
            # the first request's submit time: under a burst the submit
            # anchor is already expired at pickup, degenerating every
            # flush to a single request — the window is the knob bounding
            # ADDED latency, so it must actually buy batch company
            deadline = time.perf_counter() + self.max_wait_s
            while rows < self.max_batch_rows and not self._stop.is_set():
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=min(remaining, 0.05))
                except queue.Empty:
                    continue
                if rows + nxt.rows > self.max_batch_rows:
                    # would overflow the batch budget: serve it next round
                    self._carry = nxt
                    break
                batch.append(nxt)
                rows += nxt.rows
            serving_counters.set_queue_depth(self._queue.qsize())
            self._flush(batch, rows)

    def _flush(self, batch: "list[_Queued]", rows: int) -> None:
        try:
            merged = (
                batch[0].dataset if len(batch) == 1
                else concat_game_datasets([r.dataset for r in batch])
            )
            scores = self.scorer.score(merged)
        except Exception as exc:
            # batch-level failure: classify for the record, then isolate —
            # one poisoned request fails attributed while the rest (and the
            # loop) keep serving, unless the CUDA context itself is broken
            classify_exception(exc)
            if _sticky(exc):
                self._fail_all(batch, exc)
                return
            self._isolate(batch)
            return
        serving_counters.record_batch()
        lo = 0
        for item in batch:
            item.future._resolve(scores[lo:lo + item.rows])
            lo += item.rows
            serving_counters.record_request_latency_ms(
                (time.perf_counter() - item.t_submit) * 1e3
            )

    def _isolate(self, batch: "list[_Queued]") -> None:
        """Per-request fallback after a batch failure: each request scores
        alone, so exactly the poisoned ones fail — typed and attributed."""
        for i, item in enumerate(batch):
            try:
                scores = self.scorer.score(item.dataset)
            except Exception as exc:
                # the request's own failure, classified and attributed to
                # its id; the loop survives it unless the context broke
                classify_exception(exc)
                if _sticky(exc):
                    self._fail_all(batch[i:], exc)
                    return
                err = RequestError(
                    f"request {item.request_id!r} failed: "
                    f"{type(exc).__name__}: {exc}"
                )
                err.__cause__ = exc
                item.future._fail(err)
                serving_counters.record_request_failure()
                continue
            item.future._resolve(scores)
            serving_counters.record_request_latency_ms(
                (time.perf_counter() - item.t_submit) * 1e3
            )

    def _fail_all(self, batch: "list[_Queued]", exc: BaseException) -> None:
        """A sticky CUDA error: stop the loop, and fail the batch's requests
        and every queued one with a :class:`ServeError` carrying it."""
        self._stop.set()
        pending = list(batch)
        if self._carry is not None:
            pending.append(self._carry)
            self._carry = None
        try:
            while True:
                pending.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        for item in pending:
            err = ServeError(
                f"request {item.request_id!r}: the CUDA context failed while serving "
                f"({type(exc).__name__}: {exc}); the server stopped"
            )
            err.__cause__ = exc
            item.future._fail(err)
            serving_counters.record_request_failure()


def _sticky(exc: BaseException) -> bool:
    """A CUDA error that leaves the context unusable (the port's classifier,
    ``resilience/errors.py``)."""
    return bool(CUDA_STICKY_PATTERNS.search(f"{type(exc).__name__}: {exc}"))
