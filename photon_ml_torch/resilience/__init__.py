"""Fault tolerance: error classification, bounded retry, restore-and-resume.

Counterpart of ``photon_ml_tpu/resilience/`` for one process. Coordinated
multi-rank recovery (``resilience/coordinated.py``) is ROADMAP.md item 16
step 2.
"""

from photon_ml_torch.resilience.errors import (
    CUDA_STICKY_PATTERNS,
    FATAL_HINTS,
    NCCL_FATAL_PATTERNS,
    NCCL_TRANSIENT_PATTERNS,
    TRANSIENT_ERRNOS,
    ExchangeTimeout,
    PeerAbort,
    Transience,
    TransientError,
    classify_exception,
    fatal_hint,
    is_preemption,
    is_transient,
)
from photon_ml_torch.resilience.policy import (
    RetryPolicy,
    default_dispatch_policy,
    default_io_policy,
    default_kv_policy,
)
from photon_ml_torch.resilience.recovery import run_with_recovery

__all__ = [
    "CUDA_STICKY_PATTERNS",
    "FATAL_HINTS",
    "NCCL_FATAL_PATTERNS",
    "NCCL_TRANSIENT_PATTERNS",
    "TRANSIENT_ERRNOS",
    "ExchangeTimeout",
    "PeerAbort",
    "Transience",
    "TransientError",
    "classify_exception",
    "fatal_hint",
    "is_preemption",
    "is_transient",
    "RetryPolicy",
    "default_dispatch_policy",
    "default_io_policy",
    "default_kv_policy",
    "run_with_recovery",
]
