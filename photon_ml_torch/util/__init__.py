"""Host utilities of the port: stage timing, the job log and lifecycle
events."""

from photon_ml_torch.util.events import (  # noqa: F401
    Event,
    EventEmitter,
    OptimizationLogEvent,
    SetupEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_torch.util.logging_util import PhotonLogger  # noqa: F401
from photon_ml_torch.util.timed import Timed, timed  # noqa: F401
