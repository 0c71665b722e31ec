"""Coordinated multi-rank recovery: generation fencing, peer-abort
attribution and an all-rank rollback to the last barrier-committed
checkpoint.

Counterpart of ``photon_ml_tpu/resilience/coordinated.py``. Every rank runs
the same program, so one rank's preemption must become an event every rank
survives. :class:`CoordinatedRecovery` sits on the run's
``MetadataExchange`` (host-side key-value traffic only: it adds, skips or
reorders no device collective, so a healthy run with a coordinator attached
is bitwise the detached run):

1. **Generation fencing.** The coordinator moves the exchange into a
   restart generation (``MetadataExchange.set_generation``): keys carry the
   generation and the call sequence restarts at 0 when it grows, so the
   ranks of a restarted attempt agree again and a dead attempt's keys never
   satisfy a new attempt's wait.
2. **Peer-abort markers.** A rank whose own failure is recoverable writes a
   rank- and cause-attributed marker before restarting; peers blocked in a
   fenced wait fail at once with ``PeerAbort`` naming the culprit instead
   of waiting out the deadline. A healthy run writes no marker.
3. **Coordinated rollback.** Every rank's recovery path calls
   :meth:`CoordinatedRecovery.coordinated_restart`: the generation grows,
   the ranks meet on a restart exchange, rank 0 resolves the newest intact
   barrier-committed checkpoint (``TrainingCheckpointer
   .newest_loadable_step``) and publishes it, and every other rank checks
   that it resolves the same step. The restart budget is the generation,
   shared by construction: a flapping rank spends the job's budget.

What it catches: a rank that fails at an exchange point or a commit
barrier. A rank blocked inside a device collective (a gloo or NCCL
all-gather of the fused program) when its peer fails is not woken by a
marker; its collective ends at the process group's own timeout, and the
error that raises there is what its recovery path then sees. See
``ROADMAP.md`` for the measured cases.
"""

from __future__ import annotations

import dataclasses
import logging

from photon_ml_torch.resilience import recovery
from photon_ml_torch.resilience.errors import ExchangeTimeout, PeerAbort, is_preemption

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RestartDecision:
    """What one coordinated restart agreed on every rank.

    generation: the new restart generation (the job's restarts so far).
    step: the barrier-committed checkpoint step rank 0 published (0: none,
        restart from scratch).
    restarts_used: equal to ``generation``, for journals.
    exhausted: the generation passed the job's budget; every rank gives up.
    origin_rank: the rank whose failure started the restart (None when its
        marker was corrupt or absent).
    origin_cause: that failure, as the culprit described it.
    """

    generation: int
    step: int
    restarts_used: int
    exhausted: bool
    origin_rank: "int | None"
    origin_cause: str


class CoordinatedRecovery:
    """One rank's coordinator over the run's exchange.

    Build one per rank over the same exchange instance that the run's
    partitioned I/O and checkpoint commits use (every rank at the same
    point). Construction fences the exchange into generation 0, a change of
    key namespace only.

    checkpointer: the run's shared-directory checkpointer (rank 0 resolves
    the rollback step from it; the other ranks check it); None restarts
    from scratch. journal: an object with ``record(kind, **fields)`` for the
    ``abort_written``, ``peer_abort`` and ``coordinated_restart`` rows.
    """

    RESTART_TAG = "coordinated/restart"
    ROLLBACK_TAG = "coordinated/rollback"

    def __init__(self, exchange, *, max_restarts: int = 2, checkpointer=None, journal=None,
                 description: str = "training"):
        self.exchange = exchange
        self.max_restarts = int(max_restarts)
        self.checkpointer = checkpointer
        self.journal = journal
        self.description = description
        #: the last decision's checkpoint step, for ``resume_step=``
        self.resume_step: "int | None" = None
        exchange.set_generation(0)

    def rebind(self, checkpointer) -> None:
        """Point at another unit of work's checkpointer (the next grid
        configuration's directory) and forget the published step."""
        self.checkpointer = checkpointer
        self.resume_step = None

    @property
    def rank(self) -> int:
        return self.exchange.rank

    @property
    def generation(self) -> int:
        return int(self.exchange.generation or 0)

    def post_abort(self, exc: BaseException) -> None:
        """Attribute this rank's recoverable failure to its peers (best
        effort: never raises)."""
        info = {"rank": self.rank, "cause": repr(exc)[:500],
                "kind": "preemption" if is_preemption(exc) else type(exc).__name__,
                "generation": self.generation}
        try:
            self.exchange.post_abort(info)
        except (RuntimeError, OSError) as e:
            logger.warning("abort-marker write failed (best-effort): %s", e)
        if self.journal is not None:
            self.journal.record("abort_written", rank=self.rank, cause=info["cause"],
                                failure_kind=info["kind"], generation=info["generation"])

    def _origin(self, cause: BaseException) -> "tuple[int | None, str]":
        """(origin rank, origin cause) as this rank saw it: a PeerAbort names
        the culprit, else a marker on the board does, else a timeout's
        missing rank, else this rank itself."""
        if isinstance(cause, PeerAbort):
            return cause.origin_rank, cause.cause or repr(cause)
        try:
            marker = self.exchange.pending_abort()
        except (RuntimeError, OSError):
            marker = None
        if marker is not None:
            origin = marker.get("rank")
            return None if origin is None else int(origin), str(marker.get("cause", ""))
        if isinstance(cause, ExchangeTimeout):
            missing = getattr(cause, "missing_ranks", ())
            return (missing[0] if missing else None), repr(cause)
        return self.rank, repr(cause)

    def coordinated_restart(self, cause: BaseException) -> RestartDecision:
        """The all-rank restart protocol; every rank's recovery path calls
        it. Raises ``ExchangeTimeout`` when a rank never reaches the
        rendezvous (it is gone, not restarting)."""
        origin_rank, origin_cause = self._origin(cause)
        if isinstance(cause, PeerAbort):
            recovery.counts["peer_aborts"] += 1
            if self.journal is not None:
                self.journal.record("peer_abort", rank=self.rank, origin_rank=origin_rank,
                                    origin_cause=origin_cause, generation=self.generation,
                                    tag=getattr(cause, "tag", None))
        generation = self.generation + 1
        self.exchange.set_generation(generation)
        views = self.exchange.allgather(
            self.RESTART_TAG,
            {"rank": self.rank, "origin_rank": origin_rank, "origin_cause": origin_cause})
        # the job's attribution prefers a rank that blames itself
        for v in views:
            if v.get("origin_rank") is not None and v.get("origin_rank") == v.get("rank"):
                origin_rank = int(v["origin_rank"])
                origin_cause = str(v.get("origin_cause", origin_cause))
                break
        else:
            named = [v for v in views if v.get("origin_rank") is not None]
            if named:
                origin_rank = int(named[0]["origin_rank"])
                origin_cause = str(named[0].get("origin_cause", origin_cause))
        exhausted = generation > self.max_restarts
        step = 0
        if not exhausted:
            local = (self.checkpointer.newest_loadable_step()
                     if self.checkpointer is not None else None)
            published = self.exchange.allgather(
                self.ROLLBACK_TAG, {"step": local} if self.rank == 0 else None)[0]
            step = int(published.get("step") or 0)
            if self.rank != 0 and self.checkpointer is not None and (local or 0) != step:
                raise ValueError(
                    f"coordinated rollback: rank {self.rank} resolves checkpoint step "
                    f"{local or 0} but rank 0 published step {step} — the ranks disagree "
                    "on the shared checkpoint directory's contents; every rank must mount "
                    "the SAME barrier-committed checkpoint directory")
            self.resume_step = step
            recovery.counts["coordinated_restarts"] += 1
        if self.journal is not None:
            self.journal.record("coordinated_restart", rank=self.rank, generation=generation,
                                restarts_used=generation, max_restarts=self.max_restarts,
                                step=step, exhausted=exhausted, origin_rank=origin_rank,
                                origin_cause=origin_cause)
        logger.warning("coordinated restart: rank %d enters generation %d (origin rank %s: %s)%s",
                       self.rank, generation, origin_rank, origin_cause,
                       " — JOB restart budget exhausted" if exhausted
                       else f", rolling back to checkpoint step {step}")
        return RestartDecision(generation=generation, step=step, restarts_used=generation,
                               exhausted=exhausted, origin_rank=origin_rank,
                               origin_cause=origin_cause)
