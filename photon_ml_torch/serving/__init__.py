"""Online serving: the resident scorer (one captured CUDA graph per
micro-batch signature) and the micro-batching server. Counterpart of
``photon_ml_tpu/serving/``."""

from photon_ml_torch.serving.batching import (
    MicroBatchServer,
    RequestError,
    ServeError,
    ServeFuture,
    ServeTimeout,
)
from photon_ml_torch.serving.resident import (
    DEFAULT_MICROBATCH_SHAPES,
    ModelSwapError,
    ResidentScorer,
)

__all__ = [
    "DEFAULT_MICROBATCH_SHAPES",
    "MicroBatchServer",
    "ModelSwapError",
    "RequestError",
    "ResidentScorer",
    "ServeError",
    "ServeFuture",
    "ServeTimeout",
]
