"""Process coordination and the ("data", "model") mesh of a multi-rank run.

Counterpart of ``photon_ml_tpu/parallel/multihost.py`` (``initialize``,
``make_hybrid_mesh``, the metadata exchanges). The JAX package runs one
controller that places global arrays and lets XLA insert the collectives;
the port runs one process per rank (``torchrun --nproc-per-node N``, or
ranks started by the caller) and every collective is an explicit
``torch.distributed`` call (``parallel/mesh.py``).

- :func:`initialize` joins (or creates) the process group. The rank,
  world size and local rank come from the arguments, else from the
  launcher's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/
  ``MASTER_PORT``. With neither it creates a one-rank group over an
  in-memory store, so a one-process ``--distributed`` run executes the same
  collectives as a multi-rank one. A failed initialization raises: there is
  no single-process fallback.
- NCCL is the backend for CUDA ranks; gloo serves ``device="cpu"`` or an
  explicit ``backend="gloo"`` (two ranks on one card, which NCCL refuses).
- :func:`make_hybrid_mesh` builds the mesh; ``model > 1`` (the model axis)
  is not ported: ROADMAP.md item 15.

The JAX package's ``default_put``/``global_put`` have no counterpart: the
port places no global arrays. Its ``put_fn`` hook is "(tensor, rows) -> this
rank's block" (``parallel/mesh.default_put``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os

import torch
import torch.distributed as dist

from photon_ml_torch.device import resolve_device

logger = logging.getLogger(__name__)

#: the ROADMAP item of what stays on the model axis and partitioned I/O
ITEM_15 = 15

#: default deadline of the group's collectives and its rendezvous
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE")


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """Where this process sits in the group."""

    rank: int
    world_size: int
    local_rank: int
    backend: str
    device: torch.device


def _backend_for(device: torch.device, backend: str | None) -> str:
    if backend is not None:
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("the NCCL backend needs CUDA ranks; pass backend='gloo' "
                             "with device='cpu'")
        return backend
    return "nccl" if device.type == "cuda" else "gloo"


def process_info() -> ProcessInfo:
    """This process's place in the initialized group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialized; call multihost.initialize()")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    device = _RANK_DEVICE.get("device", torch.device("cpu"))
    return ProcessInfo(rank=dist.get_rank(), world_size=dist.get_world_size(),
                       local_rank=local_rank, backend=str(dist.get_backend()), device=device)


#: the device initialize() gave this process's rank
_RANK_DEVICE: dict = {}


def initialize(
    init_method: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_rank: int | None = None,
    *,
    device=None,
    backend: str | None = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> ProcessInfo:
    """Join the process group (idempotent) and return this process's place.

    init_method: ``tcp://host:port`` or ``file://path``; None takes
    ``MASTER_ADDR``/``MASTER_PORT`` under a launcher (``env://``) and an
    in-memory store for a group of one. device: the rank's device (None is
    ``cuda:{local_rank}``; ``"cpu"`` runs a gloo group on the CPU; an
    explicit ``cuda:i`` pins it, as two ranks on one card need). Raises when
    a cluster environment or explicit arguments are present and the group
    cannot be created.
    """
    if dist.is_initialized():
        return process_info()
    env = os.environ
    launched = all(env.get(v) for v in _LAUNCHER_VARS)
    world = int(num_processes if num_processes is not None
                else env["WORLD_SIZE"] if launched else 1)
    rank = int(process_id if process_id is not None else env["RANK"] if launched else 0)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank if not launched else 0))
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    dev = (torch.device("cuda", local_rank) if device is None and torch.cuda.is_available()
           else resolve_device(device))
    backend = _backend_for(dev, backend)
    kwargs = dict(backend=backend, rank=rank, world_size=world, timeout=timeout)
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif launched:
        kwargs["init_method"] = "env://"
    elif world == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise ValueError(f"a group of {world} ranks needs init_method or a launcher's "
                         "MASTER_ADDR/MASTER_PORT")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # resolve_device reads LOCAL_RANK once the group exists: the launcher's
    # variable, or this process's explicit local rank (shutdown restores it)
    _RANK_DEVICE.update(device=dev, local_rank_env=env.get("LOCAL_RANK"))
    env["LOCAL_RANK"] = str(local_rank)
    try:
        dist.init_process_group(**kwargs)
    except BaseException:
        shutdown()
        raise
    info = process_info()
    logger.info("process group: rank %d/%d, local rank %d, %s on %s", info.rank,
                info.world_size, info.local_rank, info.backend, info.device)
    return info


def shutdown() -> None:
    """Destroy the process group, if one exists (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    if "local_rank_env" in _RANK_DEVICE:
        before = _RANK_DEVICE["local_rank_env"]
        if before is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = before
    _RANK_DEVICE.clear()


def make_hybrid_mesh(data: int | None = None, model: int = 1):
    """The ("data", "model") mesh over the group's ranks. The JAX package
    lays the model axis inside a slice; the port's mesh is data-parallel
    only, so ``model > 1`` raises naming ROADMAP.md item 15."""
    from photon_ml_torch.parallel.mesh import make_mesh

    return make_mesh(data=data, model=model)


class MetadataExchange:
    """Small host payloads shared by every rank (partitioned I/O's feature
    keys, vocabularies and row counts). Every rank makes the same sequence
    of calls."""

    rank: int = 0
    num_ranks: int = 1

    def allgather(self, tag: str, payload) -> list:
        """All ranks' ``payload``s, ordered by rank."""
        raise NotImplementedError

    def barrier(self, tag: str) -> None:
        """Block until every rank reaches this barrier."""
        raise NotImplementedError


class SingleProcessExchange(MetadataExchange):
    """The exchange of a one-rank run: no waiting."""

    def allgather(self, tag: str, payload) -> list:
        return [payload]

    def barrier(self, tag: str) -> None:
        return None


def default_exchange() -> MetadataExchange:
    """The exchange of the current run: the single-process one. A group of
    more than one rank needs the key-value exchange of partitioned I/O,
    which is not ported (ROADMAP.md item 15), and raises rather than hand
    each rank an exchange that sees only itself."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the multi-rank metadata exchange (DistributedKVExchange) is not ported yet: "
            f"ROADMAP.md item {ITEM_15}")
    return SingleProcessExchange()
