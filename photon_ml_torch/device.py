"""Device policy of the port.

Entry points default to the CUDA device and raise when there is none; only
an explicit ``"cpu"`` runs on the CPU. Nothing moves to the CPU on its own,
so a run that was meant for the card never silently measures the host.

Float32 matrix products stay in full float32: the TF32 switches are pinned
off when this module is imported, so a kernel and its plain PyTorch version
are compared at float32 precision (the JAX reference computes in float32 on
its matrix unit with f32 accumulation).
"""

from __future__ import annotations

import os

import torch
import torch.distributed

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA device, and raises ``RuntimeError`` when
    ``torch.cuda.is_available()`` is False. Under an initialized process
    group it is the rank's own card, ``cuda:{LOCAL_RANK}`` (the launcher's
    variable, 0 without one), so ranks of one host never share card 0.
    ``"cpu"`` (or any explicit device) is taken as given.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU explicitly"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        return torch.device("cuda")
    return torch.device(device)
