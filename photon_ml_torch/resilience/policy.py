"""Bounded retry with exponential backoff and deterministic jitter.

Counterpart of ``photon_ml_tpu/resilience/policy.py``. Only errors that
:func:`~photon_ml_torch.resilience.errors.classify_exception` calls
transient are retried; the backoff is ``base * multiplier**attempt`` capped
at ``max_delay`` and stretched by a jitter fraction hashed from (policy
name, call key, attempt), so it repeats run to run and still differs across
call sites. Every retry and give-up adds to
:data:`photon_ml_torch.resilience.recovery.counts`.

Not for collectives: retrying one rank of a collective desynchronizes the
ranks' call sequence; those get deadlines instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time
from typing import Callable

from photon_ml_torch.resilience import recovery
from photon_ml_torch.resilience.errors import Transience, classify_exception, fatal_hint

logger = logging.getLogger(__name__)


def _jitter_fraction(name: str, key: str, attempt: int) -> float:
    """A [0, 1) fraction from a stable hash: deterministic jitter."""
    digest = hashlib.blake2b(f"{name}/{key}/{attempt}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little") / 2**32


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``policy.call(fn, ...)`` runs ``fn`` with classified bounded retry;
    ``sleep`` is injectable so tests pay no wall-clock time."""

    max_attempts: int = 3
    base_delay: float = 0.2
    max_delay: float = 30.0
    multiplier: float = 2.0
    #: extra delay of up to this fraction of the backoff, hash-derived
    jitter: float = 0.25
    name: str = "retry"
    classify: Callable[[BaseException], Transience] = classify_exception
    sleep: Callable[[float], None] = time.sleep

    def delay(self, attempt: int, key: str = "") -> float:
        """Backoff before attempt ``attempt + 1`` (attempt is 0-based)."""
        base = min(self.base_delay * self.multiplier**attempt, self.max_delay)
        return base * (1.0 + self.jitter * _jitter_fraction(self.name, key, attempt))

    def call(self, fn: Callable, *args, description: str = "", **kwargs):
        """Invoke ``fn(*args, **kwargs)``, retrying classified-transient
        failures up to ``max_attempts`` attempts in all."""
        key = description or getattr(fn, "__name__", "call")
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # the classifier decides
                if self.classify(e) is not Transience.TRANSIENT:
                    hint = fatal_hint(e)
                    if hint is not None:
                        logger.error("%s: %s failed with a known-fatal signature (%r) — not "
                                     "retrying. Hint: %s", self.name, key, e, hint)
                    raise
                attempt += 1
                if attempt >= self.max_attempts:
                    recovery.counts["giveups"] += 1
                    logger.error("%s: %s failed transiently %d/%d times; giving up "
                                 "(last error: %r)", self.name, key, attempt,
                                 self.max_attempts, e)
                    raise
                pause = self.delay(attempt - 1, key)
                recovery.counts["retries"] += 1
                logger.warning("%s: transient failure in %s (attempt %d/%d): %r — retrying "
                               "in %.2fs", self.name, key, attempt, self.max_attempts, e, pause)
                self.sleep(pause)


def default_io_policy() -> RetryPolicy:
    """Host I/O (Avro reads, checkpoint files): a few quick attempts."""
    return RetryPolicy(max_attempts=3, base_delay=0.2, max_delay=5.0, name="io-retry")


def default_dispatch_policy() -> RetryPolicy:
    """A remote dispatch boundary: more room than local I/O."""
    return RetryPolicy(max_attempts=4, base_delay=1.0, max_delay=60.0, name="dispatch-retry")


def default_kv_policy() -> RetryPolicy:
    """Point-to-point key-value operations of a process group's store."""
    return RetryPolicy(max_attempts=3, base_delay=0.5, max_delay=10.0, name="kv-retry")
