"""Fault tolerance: error classification, bounded retry, restore-and-resume.

Counterpart of ``photon_ml_tpu/resilience/``, coordinated multi-rank
recovery (``resilience/coordinated.py``) included.
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
from photon_ml_torch.resilience.coordinated import CoordinatedRecovery, RestartDecision

__all__ = [
    "CUDA_STICKY_PATTERNS",
    "FATAL_HINTS",
    "NCCL_FATAL_PATTERNS",
    "NCCL_TRANSIENT_PATTERNS",
    "TRANSIENT_ERRNOS",
    "CoordinatedRecovery",
    "ExchangeTimeout",
    "PeerAbort",
    "RestartDecision",
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
