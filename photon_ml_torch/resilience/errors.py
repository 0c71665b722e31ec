"""Transient-vs-fatal error classification and the attributed failure types.

Counterpart of ``photon_ml_tpu/resilience/errors.py``. The reference's
failure model is Spark's (lineage recompute and task retries, not a
photon-ml source file); every host boundary here asks one classifier
whether an error is worth retrying.

Classification rules, in precedence order:

1. Explicit wrappers win: :class:`TransientError` is always transient;
   :class:`ExchangeTimeout` and :class:`PeerAbort` are always fatal (they
   are already attributed; waiting again would only double the hang).
2. CUDA's sticky errors are fatal (:data:`CUDA_STICKY_PATTERNS`): once one
   fires the CUDA context is dead, and a restart in the same process fails
   the same way. They are tested before the transient patterns, because
   "the launch timed out and was terminated" would otherwise match
   ``timed? ?out``.
3. Known-poison signatures are fatal even when they smell transient: HTTP
   413 / "payload too large", INVALID_ARGUMENT, "out of memory" (XLA's
   device OOM and ``torch.cuda.OutOfMemoryError``'s "CUDA out of memory"),
   and NCCL's usage errors (:data:`NCCL_FATAL_PATTERNS`).
4. Connection/timeout exception types and transient OS errnos are transient.
5. Message patterns of the distributed runtimes (UNAVAILABLE, "socket
   closed", "connection reset", ...) and NCCL's network failures
   (:data:`NCCL_TRANSIENT_PATTERNS`) are transient.
6. Everything else is fatal.
"""

from __future__ import annotations

import enum
import errno
import re

#: OS errnos worth retrying: interrupted or expired I/O and dropped network
#: paths, never logic errors
TRANSIENT_ERRNOS = frozenset(
    {
        errno.EAGAIN,
        errno.EINTR,
        errno.EIO,
        errno.EBUSY,
        errno.ETIMEDOUT,
        errno.ECONNRESET,
        errno.ECONNABORTED,
        errno.ECONNREFUSED,
        errno.ENETRESET,
        errno.ENETUNREACH,
        errno.EHOSTUNREACH,
        errno.EPIPE,
    }
)

#: CUDA's sticky errors (the CUDA runtime's cudaErrorIllegalAddress,
#: cudaErrorAssert, cudaErrorLaunchFailure, cudaErrorLaunchTimeout,
#: cudaErrorMisalignedAddress, cudaErrorIllegalInstruction,
#: cudaErrorHardwareStackError, cudaErrorECCUncorrectable, in the words
#: ``torch`` puts in its RuntimeError), and a missing or unusable driver
CUDA_STICKY_PATTERNS = re.compile(
    r"an illegal memory access was encountered"
    r"|device-side assert triggered"
    r"|unspecified launch failure"
    r"|the launch timed out and was terminated"
    r"|misaligned address"
    r"|an illegal instruction was encountered"
    r"|hardware stack error"
    r"|uncorrectable ECC error encountered"
    r"|no CUDA-capable device is detected"
    r"|CUDA driver version is insufficient",
    re.IGNORECASE,
)

#: NCCL's own usage errors (ncclInvalidUsage, ncclInvalidArgument):
#: deterministic, a retry sends the same call
NCCL_FATAL_PATTERNS = re.compile(
    r"ncclInvalidUsage|ncclInvalidArgument|NCCL error[^\n]*invalid usage",
    re.IGNORECASE,
)

#: NCCL's network and peer failures (ncclSystemError, ncclRemoteError, a
#: communicator aborted by its watchdog): a restarted attempt on a new
#: group can succeed
NCCL_TRANSIENT_PATTERNS = re.compile(
    r"ncclSystemError|ncclRemoteError|unhandled system error"
    r"|remote process exited or there was a network error"
    r"|NCCL communicator was aborted",
    re.IGNORECASE,
)

_FATAL_PATTERNS = re.compile(
    r"\b413\b|payload too large|request entity too large"
    r"|INVALID_ARGUMENT|out of memory",
    re.IGNORECASE,
)

#: gRPC/absl status words and socket-level phrases the distributed
#: runtimes put in their messages, and the device-loss / preemption shapes
_TRANSIENT_PATTERNS = re.compile(
    r"UNAVAILABLE|DEADLINE_EXCEEDED|RESOURCE_EXHAUSTED|ABORTED"
    r"|socket closed|connection reset|connection refused|broken pipe"
    r"|connection closed|temporarily unavailable|too many requests"
    r"|timed? ?out"
    r"|preempt(?:ed|ion)?|device (?:is )?lost|lost device"
    r"|device (?:failure|halted)|worker (?:has )?(?:restarted|terminated)",
    re.IGNORECASE,
)

#: the device-loss subset of the transient shapes (counted apart as
#: preemptions); a bare "socket closed" is deliberately not here
_PREEMPTION_PATTERNS = re.compile(
    r"preempt(?:ed|ion)?|device (?:is )?lost|lost device"
    r"|device (?:failure|halted)|worker (?:has )?(?:restarted|terminated)",
    re.IGNORECASE,
)

#: remediation hints keyed by fatal signature, logged once at give-up
FATAL_HINTS: tuple[tuple[re.Pattern, str], ...] = (
    (
        re.compile(r"\b413\b|payload too large|request entity too large",
                   re.IGNORECASE),
        "a request exceeded the transport's size limit — pass large "
        "batches as arguments, never as captured constants",
    ),
    (
        CUDA_STICKY_PATTERNS,
        "a sticky CUDA error leaves the process's CUDA context unusable, so "
        "no restart inside this process can succeed — restart the process "
        "(a checkpoint directory resumes it) and hold the failing kernel "
        "against its plain version on the CPU to find the fault",
    ),
    (
        re.compile(r"out of memory", re.IGNORECASE),
        "device OOM is deterministic — retrying re-allocates identically; "
        "shrink the batch, use bf16 feature blocks, or shard further",
    ),
)


class Transience(enum.Enum):
    """The classifier's verdict: retry-worthy or not."""

    TRANSIENT = "transient"
    FATAL = "fatal"


class TransientError(RuntimeError):
    """Explicitly transient failure: always retried within budget."""


class ExchangeTimeout(TimeoutError):
    """A metadata exchange's read or barrier missed its deadline, with the
    tag, the key that never appeared and the ranks expected to publish it.
    Classified FATAL: the deadline already waited."""

    def __init__(
        self,
        tag: str,
        *,
        missing_ranks: "tuple[int, ...] | list[int]" = (),
        key: str | None = None,
        rank: int | None = None,
        timeout: float | None = None,
        detail: str = "",
    ):
        self.tag = tag
        self.missing_ranks = tuple(int(r) for r in missing_ranks)
        self.key = key
        self.rank = rank
        self.timeout = timeout
        parts = [f"exchange {tag!r}"]
        if key is not None:
            parts.append(f"key {key!r} was never published")
        if self.missing_ranks:
            parts.append(
                "rank(s) %s did not participate"
                % ",".join(map(str, self.missing_ranks))
            )
        if rank is not None:
            parts.append(f"(observed on rank {rank})")
        if timeout is not None:
            parts.append(f"after {timeout:g}s")
        if detail:
            parts.append(f"[{detail}]")
        super().__init__(" ".join(parts))


class PeerAbort(RuntimeError):
    """Another rank aborted the attempt, attributed to the culprit.
    Classified FATAL: only a ``CoordinatedRecovery`` attached to
    ``run_with_recovery`` recovers it."""

    def __init__(
        self,
        tag: str,
        *,
        origin_rank: "int | None" = None,
        cause: str = "",
        generation: int | None = None,
        rank: int | None = None,
    ):
        self.tag = tag
        self.origin_rank = origin_rank
        self.cause = cause
        self.generation = generation
        self.rank = rank
        parts = [f"exchange {tag!r} aborted"]
        if origin_rank is not None:
            parts.append(f"by rank {origin_rank}")
        else:
            parts.append("by an unattributed peer (corrupt abort marker?)")
        if generation is not None:
            parts.append(f"in generation {generation}")
        if cause:
            parts.append(f"cause: {cause}")
        if rank is not None:
            parts.append(f"(observed on rank {rank})")
        super().__init__(" ".join(parts))


def classify_exception(exc: BaseException) -> Transience:
    """The one transient-vs-fatal rule (precedence in the module docstring)."""
    if isinstance(exc, TransientError):
        return Transience.TRANSIENT
    if isinstance(exc, (ExchangeTimeout, PeerAbort)):
        return Transience.FATAL
    message = f"{type(exc).__name__}: {exc}"
    if CUDA_STICKY_PATTERNS.search(message):
        return Transience.FATAL
    if _FATAL_PATTERNS.search(message) or NCCL_FATAL_PATTERNS.search(message):
        return Transience.FATAL
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return Transience.TRANSIENT
    if isinstance(exc, OSError) and exc.errno in TRANSIENT_ERRNOS:
        return Transience.TRANSIENT
    if _TRANSIENT_PATTERNS.search(message) or NCCL_TRANSIENT_PATTERNS.search(message):
        return Transience.TRANSIENT
    return Transience.FATAL


def is_transient(exc: BaseException) -> bool:
    return classify_exception(exc) is Transience.TRANSIENT


def is_preemption(exc: BaseException) -> bool:
    """True for transient failures shaped like a device loss or a pool
    preemption; always a subset of transient."""
    if classify_exception(exc) is not Transience.TRANSIENT:
        return False
    message = f"{type(exc).__name__}: {exc}"
    return bool(_PREEMPTION_PATTERNS.search(message))


def fatal_hint(exc: BaseException) -> str | None:
    """A remediation hint for known-fatal signatures, or None."""
    message = f"{type(exc).__name__}: {exc}"
    for pattern, hint in FATAL_HINTS:
        if pattern.search(message):
            return hint
    return None
