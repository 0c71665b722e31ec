"""Host utilities of the port: stage timing and the job log."""

from photon_ml_torch.util.logging_util import PhotonLogger  # noqa: F401
from photon_ml_torch.util.timed import Timed  # noqa: F401
