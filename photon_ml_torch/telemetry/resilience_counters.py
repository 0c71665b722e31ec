"""Resilience telemetry: retry, give-up, quarantine and restore counters
(the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/resilience_counters.py``. The
reference gets fault tolerance from Spark lineage recompute and shows it
only as task-retry counts in the Spark UI. Here every recovery action the
resilience layer takes (``photon_ml_torch/resilience/``) lands on a named
counter in the process-wide metrics registry, which the run journal
snapshots on success and failure paths; ``resilience.recovery.counts`` is
a view of the same counters. Quarantined block spans also ride a bounded
ring (:func:`drain_quarantine_events`) that drivers journal as
``quarantined_block`` rows.
"""

from __future__ import annotations

import threading
from collections import deque

from photon_ml_torch.telemetry.registry import default_registry

#: transient failures retried by a RetryPolicy or a driver-level restart
RETRIES = "resilience/retries"
#: retry or restart budgets exhausted (the error then propagated)
GIVEUPS = "resilience/giveups"
#: corrupt Avro container blocks skipped under on_corrupt="quarantine"
QUARANTINED_BLOCKS = "resilience/quarantined_blocks"
#: restores from a checkpoint (coordinate descent, sweeps, streamed solves)
CHECKPOINT_RESTORES = "resilience/checkpoint_restores"
#: restarts whose failure was a device loss or preemption
PREEMPTIONS = "resilience/preemptions"
#: epochs or sweeps of completed work a checkpoint resume did not redo
EPOCHS_RESUMED = "resilience/epochs_resumed"
#: peer aborts observed (a peer's abort marker ended this rank's wait)
PEER_ABORTS = "resilience/peer_aborts"
#: all-rank coordinated restarts this rank took part in
COORDINATED_RESTARTS = "resilience/coordinated_restarts"

#: the counters by their short names (``resilience.recovery.counts`` keys)
COUNTERS = {
    "retries": RETRIES,
    "giveups": GIVEUPS,
    "preemptions": PREEMPTIONS,
    "checkpoint_restores": CHECKPOINT_RESTORES,
    "epochs_resumed": EPOCHS_RESUMED,
    "peer_aborts": PEER_ABORTS,
    "coordinated_restarts": COORDINATED_RESTARTS,
}

#: the bounded forensic ring's length (the counter stays exact)
QUARANTINE_EVENT_WINDOW = 256

_events_lock = threading.Lock()
_quarantine_events: deque[dict] = deque(maxlen=QUARANTINE_EVENT_WINDOW)


def record_retry(n: int = 1) -> None:
    default_registry().counter(RETRIES).inc(int(n))


def record_giveup(n: int = 1) -> None:
    default_registry().counter(GIVEUPS).inc(int(n))


def record_checkpoint_restore(n: int = 1) -> None:
    default_registry().counter(CHECKPOINT_RESTORES).inc(int(n))


def record_preemption(n: int = 1) -> None:
    default_registry().counter(PREEMPTIONS).inc(int(n))


def record_epochs_resumed(n: int) -> None:
    default_registry().counter(EPOCHS_RESUMED).inc(int(n))


def record_peer_abort(n: int = 1) -> None:
    default_registry().counter(PEER_ABORTS).inc(int(n))


def record_coordinated_restart(n: int = 1) -> None:
    default_registry().counter(COORDINATED_RESTARTS).inc(int(n))


def reset_resilience_metrics(registry=None) -> None:
    """Drop the per-run recovery counters (preemptions, epochs_resumed,
    peer_aborts, coordinated_restarts); drivers call it at run start. The
    retries, give-ups, quarantined blocks and restores count over the
    process's life, as in the JAX package."""
    reg = registry or default_registry()
    for name in (PREEMPTIONS, EPOCHS_RESUMED, PEER_ABORTS, COORDINATED_RESTARTS):
        reg.remove_prefix(name)


def record_quarantined_block(path: str, block_index: int, start: int, end: int,
                             reason: str) -> None:
    """One corrupt block skipped: count it and keep its span in the ring."""
    default_registry().counter(QUARANTINED_BLOCKS).inc(1)
    with _events_lock:
        _quarantine_events.append({"path": str(path), "block_index": int(block_index),
                                   "byte_start": int(start), "byte_end": int(end),
                                   "reason": str(reason)})


def drain_quarantine_events() -> list[dict]:
    """Pop every pending quarantine span (drivers journal them as
    ``quarantined_block`` rows)."""
    with _events_lock:
        out = list(_quarantine_events)
        _quarantine_events.clear()
    return out


def _value(name: str) -> int:
    return int(default_registry().counter(name).value)


def retries() -> int:
    return _value(RETRIES)


def giveups() -> int:
    return _value(GIVEUPS)


def quarantined_blocks() -> int:
    return _value(QUARANTINED_BLOCKS)


def checkpoint_restores() -> int:
    return _value(CHECKPOINT_RESTORES)


def preemptions() -> int:
    return _value(PREEMPTIONS)


def peer_aborts() -> int:
    return _value(PEER_ABORTS)


def coordinated_restarts() -> int:
    return _value(COORDINATED_RESTARTS)


def epochs_resumed() -> int:
    return _value(EPOCHS_RESUMED)
