"""Driver-level recovery: restore-and-resume instead of abort.

Counterpart of ``photon_ml_tpu/resilience/recovery.py``. A failure inside
one attempt that is

- a :class:`~photon_ml_torch.io.checkpoint.DivergenceError` with a
  checkpoint to fall back to, or
- a classified-transient error (``resilience/errors.classify_exception``)

restarts the attempt; the re-created trainer resumes from the newest
intact checkpoint. Restarts are capped by ``max_restarts``. CUDA's sticky
errors classify fatal and are never retried.

A run of several ranks attaches a ``resilience.CoordinatedRecovery``:
``ExchangeTimeout`` and ``PeerAbort`` (fatal on their own) become
recoverable through it, every restart is an all-rank rollback to the last
barrier-committed checkpoint, and the budget is the coordinator's shared
generation count. The ``run_failure`` row then names the originating rank
and cause on every rank.

:data:`counts` holds the process's tallies: ``retries`` (restarts and the
retry policies' retries), ``giveups``, ``preemptions``,
``checkpoint_restores`` (added at every restore site), ``epochs_resumed``
(streamed epochs or fused sweeps a resume did not redo), ``peer_aborts`` and
``coordinated_restarts``.
The run journal that reads them is ROADMAP.md item 19.
"""

from __future__ import annotations

import logging
from typing import Callable

from photon_ml_torch.resilience.errors import (
    ExchangeTimeout,
    PeerAbort,
    Transience,
    classify_exception,
    fatal_hint,
    is_preemption,
)

logger = logging.getLogger(__name__)

#: the process's recovery tallies (see the module docstring)
counts = {"retries": 0, "giveups": 0, "preemptions": 0, "checkpoint_restores": 0,
          "epochs_resumed": 0, "peer_aborts": 0, "coordinated_restarts": 0}


def reset_counts() -> None:
    for key in counts:
        counts[key] = 0


def run_with_recovery(
    fn: Callable[[int], object],
    *,
    max_restarts: int = 2,
    checkpointer=None,
    classify: Callable = classify_exception,
    journal=None,
    description: str = "training",
    coordinator=None,
):
    """Run ``fn(restart_index)`` with capped restore-and-resume restarts.

    fn: one full attempt; receives the 0-based restart index (a driver uses
        it to resume on restarts even under ``--no-resume``).
    checkpointer: optional ``io.checkpoint.TrainingCheckpointer`` (or
        ``SolverCheckpointer``). A DivergenceError is recoverable only when a
        checkpoint step exists; transient errors restart either way.
    journal: optional object with ``record(kind, **fields)`` for the
        ``resilience_restart`` and ``run_failure`` rows.
    coordinator: a ``resilience.CoordinatedRecovery`` (several ranks). Its
        ``max_restarts`` (the job's shared budget) replaces the argument;
        ``ExchangeTimeout`` and ``PeerAbort`` become recoverable; a restart
        first posts this rank's own failure as an abort marker, then meets
        every rank on the coordinated rollback.
    """
    from photon_ml_torch.io.checkpoint import DivergenceError

    if coordinator is not None:
        max_restarts = coordinator.max_restarts
    restart = 0
    while True:
        try:
            return fn(restart)
        except Exception as e:  # classified below
            transient = classify(e) is Transience.TRANSIENT
            has_checkpoint = checkpointer is not None and checkpointer.latest_step() is not None
            divergent = isinstance(e, DivergenceError)
            coordination = isinstance(e, (ExchangeTimeout, PeerAbort))
            coordination_only = coordinator is not None and coordination
            recoverable = transient or (divergent and has_checkpoint) or coordination_only
            origin_rank = getattr(e, "origin_rank", None)
            origin_cause = getattr(e, "cause", None) if isinstance(e, PeerAbort) else None
            decision = None
            if recoverable and coordinator is not None:
                # this rank's own failure is posted to its peers; a
                # coordination failure is someone else's
                if not coordination:
                    coordinator.post_abort(e)
                try:
                    decision = coordinator.coordinated_restart(e)
                except Exception as rendezvous_error:
                    # a rank is gone, not restarting: the job ends here
                    if journal is not None:
                        journal.record("run_failure", description=description,
                                       error=repr(rendezvous_error), original_error=repr(e),
                                       transient=False, divergent=divergent, preemption=False,
                                       restarts_used=restart, max_restarts=max_restarts,
                                       origin_rank=getattr(rendezvous_error, "origin_rank", None),
                                       origin_cause=None)
                    counts["giveups"] += 1
                    logger.error("%s: coordinated restart rendezvous failed (%r) after %r; "
                                 "giving up", description, rendezvous_error, e)
                    raise
                origin_rank, origin_cause = decision.origin_rank, decision.origin_cause
            exhausted = decision.exhausted if decision is not None else restart >= max_restarts
            if not recoverable or exhausted:
                if journal is not None:
                    journal.record("run_failure", description=description, error=repr(e),
                                   transient=transient, divergent=divergent,
                                   preemption=is_preemption(e),
                                   restarts_used=(decision.restarts_used if decision is not None
                                                  else restart),
                                   max_restarts=max_restarts, origin_rank=origin_rank,
                                   origin_cause=origin_cause)
                if recoverable:
                    counts["giveups"] += 1
                    logger.error("%s: restart budget (%d) exhausted; giving up on %r",
                                 description, max_restarts, e)
                elif divergent and not has_checkpoint:
                    logger.error("%s: diverged with no checkpoint to restore (enable "
                                 "--checkpoint-dir for mid-sweep recovery): %r", description, e)
                else:
                    hint = fatal_hint(e)
                    if hint is not None:
                        logger.error("%s: fatal failure %r. Hint: %s", description, e, hint)
                raise
            restart = decision.generation if decision is not None else restart + 1
            counts["retries"] += 1
            preempted = is_preemption(e)
            if preempted:
                counts["preemptions"] += 1
            logger.warning(
                "%s: %s failure (%r) — restart %d/%d%s", description,
                "transient" if transient else "coordination" if coordination_only
                else "divergence", e, restart, max_restarts,
                f", resuming from checkpoint step {checkpointer.latest_step()}"
                if has_checkpoint else ", retrying from scratch")
            if journal is not None:
                journal.record("resilience_restart", description=description, restart=restart,
                               max_restarts=max_restarts, transient=transient,
                               divergent=divergent, preemption=preempted,
                               resumed_from_step=(decision.step if decision is not None
                                                  else checkpointer.latest_step()
                                                  if has_checkpoint else None),
                               origin_rank=origin_rank, origin_cause=origin_cause,
                               error=repr(e))
