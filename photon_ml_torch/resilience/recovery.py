"""Driver-level recovery: restore-and-resume instead of abort.

Counterpart of ``photon_ml_tpu/resilience/recovery.py`` with
``coordinator=None``. A failure inside one attempt that is

- a :class:`~photon_ml_torch.io.checkpoint.DivergenceError` with a
  checkpoint to fall back to, or
- a classified-transient error (``resilience/errors.classify_exception``)

restarts the attempt; the re-created trainer resumes from the newest
intact checkpoint. Restarts are capped by ``max_restarts``. CUDA's sticky
errors classify fatal and are never retried.

:data:`counts` holds the process's tallies: ``retries`` (restarts and the
retry policies' retries), ``giveups``, ``preemptions``,
``checkpoint_restores`` (added at every restore site) and
``epochs_resumed`` (streamed epochs or fused sweeps a resume did not redo).
The run journal that reads them is ROADMAP.md item 19.
"""

from __future__ import annotations

import logging
from typing import Callable

from photon_ml_torch.resilience.errors import (
    Transience,
    classify_exception,
    fatal_hint,
    is_preemption,
)

logger = logging.getLogger(__name__)

#: the process's recovery tallies (see the module docstring)
counts = {"retries": 0, "giveups": 0, "preemptions": 0, "checkpoint_restores": 0,
          "epochs_resumed": 0}


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
    coordinator: multi-rank coordinated recovery, which is ROADMAP.md item 16
        step 2: anything but None raises ``NotImplementedError``.
    """
    from photon_ml_torch.io.checkpoint import DivergenceError

    if coordinator is not None:
        raise NotImplementedError(
            "coordinated multi-rank recovery (run_with_recovery(coordinator=...)) is not "
            "ported yet: ROADMAP.md item 16 (step 2)")
    restart = 0
    while True:
        try:
            return fn(restart)
        except Exception as e:  # classified below
            transient = classify(e) is Transience.TRANSIENT
            has_checkpoint = checkpointer is not None and checkpointer.latest_step() is not None
            divergent = isinstance(e, DivergenceError)
            recoverable = transient or (divergent and has_checkpoint)
            if not recoverable or restart >= max_restarts:
                if journal is not None:
                    journal.record("run_failure", description=description, error=repr(e),
                                   transient=transient, divergent=divergent,
                                   preemption=is_preemption(e), restarts_used=restart,
                                   max_restarts=max_restarts, origin_rank=None,
                                   origin_cause=None)
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
            restart += 1
            counts["retries"] += 1
            preempted = is_preemption(e)
            if preempted:
                counts["preemptions"] += 1
            logger.warning(
                "%s: %s failure (%r) — restart %d/%d%s", description,
                "transient" if transient else "divergence", e, restart, max_restarts,
                f", resuming from checkpoint step {checkpointer.latest_step()}"
                if has_checkpoint else ", retrying from scratch")
            if journal is not None:
                journal.record("resilience_restart", description=description, restart=restart,
                               max_restarts=max_restarts, transient=transient,
                               divergent=divergent, preemption=preempted,
                               resumed_from_step=(checkpointer.latest_step()
                                                  if has_checkpoint else None),
                               origin_rank=None, origin_cause=None, error=repr(e))
