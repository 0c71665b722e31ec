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
- :func:`make_hybrid_mesh` builds the ("data", "model") mesh.
- The metadata exchanges carry small host payloads between ranks before any
  device work (partitioned I/O's feature keys, vocabularies, row counts and
  layout histograms): :class:`InProcessExchange` (virtual ranks on threads)
  and :class:`DistributedKVExchange` (the key-value store of the process
  group, which :func:`initialize` builds and keeps). A missed deadline raises
  ``resilience.ExchangeTimeout`` (a ``TimeoutError``, classified fatal)
  naming the key and the rank that should have published it.
  :class:`DataAxisExchange` narrows an exchange to the mesh's data axis (a
  partitioned read over a mesh with a model axis). Fencing, abort markers
  and retries are item 16's step 2.

The JAX package's ``default_put``/``global_put`` have no counterpart: the
port places no global arrays. Its ``put_fn`` hook is "(tensor, rows) -> this
rank's block" (``parallel/mesh.default_put``), and
:func:`assemble_partitioned` is "this rank's block on this rank's device".
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import logging
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_torch.device import resolve_device

logger = logging.getLogger(__name__)

#: default deadline of the group's collectives and its rendezvous
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

#: default deadline of one metadata exchange, in seconds (the JAX package's)
DEFAULT_EXCHANGE_TIMEOUT = 120.0

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

#: the key-value store initialize() built for the group (the metadata
#: exchange's transport)
_STORE: dict = {}


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
    in-memory store for a group of one. The store is built here and kept
    (:func:`group_store`): ``tcp://`` and ``env://`` give a ``TCPStore``,
    ``file://`` a ``FileStore``, a group of one a ``HashStore``; the group
    and the metadata exchange share it. device: the rank's device (None is
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
    if init_method is None and not launched and world > 1:
        raise ValueError(f"a group of {world} ranks needs init_method or a launcher's "
                         "MASTER_ADDR/MASTER_PORT")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # resolve_device reads LOCAL_RANK once the group exists: the launcher's
    # variable, or this process's explicit local rank (shutdown restores it)
    _RANK_DEVICE.update(device=dev, local_rank_env=env.get("LOCAL_RANK"))
    env["LOCAL_RANK"] = str(local_rank)
    try:
        store = _build_store(init_method if init_method is not None
                             else "env://" if launched else None, rank, world, timeout)
        _STORE["store"] = store
        dist.init_process_group(backend=backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
    except BaseException:
        shutdown()
        raise
    info = process_info()
    logger.info("process group: rank %d/%d, local rank %d, %s on %s", info.rank,
                info.world_size, info.local_rank, info.backend, info.device)
    return info


def _build_store(url: str | None, rank: int, world: int, timeout: datetime.timedelta):
    """The group's key-value store: a ``HashStore`` without a URL (a group of
    one), else the rendezvous store of ``tcp://`` / ``env://`` (a
    ``TCPStore``, rank 0 its server unless a launcher's agent hosts it) or
    ``file://`` (a ``FileStore``)."""
    if url is None:
        return dist.HashStore()
    if not url.startswith(("tcp://", "env://", "file://")):
        raise ValueError(f"init_method must be tcp://, env:// or file://, got {url!r}")
    store, _, _ = next(dist.rendezvous(url, rank, world, timeout=timeout))
    store.set_timeout(timeout)
    return store


def group_store():
    """The key-value store of the initialized group (:func:`initialize`)."""
    if "store" not in _STORE or not dist.is_initialized():
        raise RuntimeError("no process group is initialized; call multihost.initialize()")
    return _STORE["store"]


def shutdown() -> None:
    """Destroy the process group, if one exists (every rank calls it)."""
    _STORE.clear()
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
    lays the model axis inside a slice (ICI) and the data axis across
    slices; here the model index varies fastest over the ranks, so a
    launcher that numbers a host's ranks together (``torchrun``) keeps each
    model group inside a host."""
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


class DataAxisExchange(MetadataExchange):
    """``base`` seen along a mesh's data axis: ``rank``/``num_ranks`` are the
    data rank and the data axis, and :meth:`allgather` returns one payload
    per data rank (that of its model rank 0). Every process of the group
    still makes every call, so the ranks of one data row (which read the
    same block of a partitioned input) stay in step, and no row of the input
    is counted more than once."""

    def __init__(self, base: MetadataExchange, mesh):
        from photon_ml_torch.parallel.mesh import data_rank, data_size, model_size

        self.base = base
        self.rank = data_rank(mesh)
        self.num_ranks = data_size(mesh)
        self._stride = model_size(mesh)

    def allgather(self, tag: str, payload) -> list:
        return self.base.allgather(tag, payload)[::self._stride]

    def barrier(self, tag: str) -> None:
        self.base.barrier(tag)


class SingleProcessExchange(MetadataExchange):
    """The exchange of a one-rank run: no waiting."""

    def allgather(self, tag: str, payload) -> list:
        return [payload]

    def barrier(self, tag: str) -> None:
        return None


def _timeout_error(tag: str, key, missing, rank: int, timeout: float,
                   detail: str = "") -> TimeoutError:
    """A missed exchange deadline, naming the key and the ranks that never
    published: a ``resilience.ExchangeTimeout``, which the recovery layer
    classifies fatal (the deadline already waited)."""
    from photon_ml_torch.resilience.errors import ExchangeTimeout

    msg = f"exchange {tag!r}"
    if key is not None:
        msg += f": key {key!r} was never published"
    msg += "; rank(s) %s did not participate" % ",".join(map(str, missing))
    msg += f" (observed on rank {rank} after {timeout:g} s)"
    err = ExchangeTimeout(tag, missing_ranks=missing, key=key, rank=rank, timeout=timeout,
                          detail=detail)
    err.args = (msg + (f"; {detail}" if detail else ""),)
    return err


class InProcessExchange(MetadataExchange):
    """N virtual ranks inside one process (threads): the test transport,
    which runs partitioned readers and writers of several ranks in one
    process. A per-instance sequence keeps repeated exchanges under one tag
    apart (every rank makes the same calls, so the sequences agree)."""

    def __init__(self, store: dict, rank: int, num_ranks: int,
                 timeout: float = DEFAULT_EXCHANGE_TIMEOUT):
        self._store = store
        self.rank = rank
        self.num_ranks = num_ranks
        self.timeout = float(timeout)
        self._seq = 0

    @classmethod
    def create_group(cls, num_ranks: int, timeout: float = DEFAULT_EXCHANGE_TIMEOUT
                     ) -> "list[InProcessExchange]":
        store = {"cond": threading.Condition(), "gather": {}, "reads": {}}
        return [cls(store, r, num_ranks, timeout=timeout) for r in range(num_ranks)]

    def allgather(self, tag: str, payload) -> list:
        key = (self._seq, tag)
        self._seq += 1
        cond, slot = self._store["cond"], self._store["gather"]
        with cond:
            entry = slot.setdefault(key, {})
            entry[self.rank] = payload
            cond.notify_all()
            cond.wait_for(lambda: len(slot[key]) == self.num_ranks, timeout=self.timeout)
            if len(slot[key]) != self.num_ranks:
                missing = [r for r in range(self.num_ranks) if r not in slot[key]]
                raise _timeout_error(tag, None, missing, self.rank, self.timeout,
                                     f"{len(slot[key])}/{self.num_ranks} ranks published")
            out = [slot[key][r] for r in range(self.num_ranks)]
            # the slot goes once every rank has read it
            reads = self._store["reads"]
            reads[key] = reads.get(key, 0) + 1
            if reads[key] == self.num_ranks:
                del slot[key], reads[key]
            return out

    def barrier(self, tag: str) -> None:
        self.allgather(f"__barrier__/{tag}", None)


#: process-global sequence of key-value exchange keys: two exchange
#: instances in one process never reuse a key (every rank makes its
#: exchanges in the same order, so the counters agree across ranks)
_kv_seq = itertools.count().__next__


class DistributedKVExchange(MetadataExchange):
    """The multi-process exchange over the key-value store of the
    ``torch.distributed`` group (:func:`initialize` builds it): host-side
    only, so partitioned ingestion's metadata moves before any device
    collective. Payloads are JSON. Each rank publishes its payload under a
    key of its own and reads every rank's; the last reader deletes the keys.
    A key that does not appear within ``timeout`` seconds raises
    ``TimeoutError`` naming it and the rank that should have published it.

    ``store``/``rank``/``num_ranks`` are injectable (tests); by default the
    group's store and place."""

    def __init__(self, timeout: float = DEFAULT_EXCHANGE_TIMEOUT, *, store=None,
                 rank: int | None = None, num_ranks: int | None = None):
        self._store = dist.PrefixStore("photon/xchg", store if store is not None
                                       else group_store())
        self.timeout = float(timeout)
        self.rank = dist.get_rank() if rank is None else int(rank)
        self.num_ranks = dist.get_world_size() if num_ranks is None else int(num_ranks)

    def _get(self, key: str, tag: str, expected_rank: int) -> bytes:
        try:
            self._store.wait([key], datetime.timedelta(seconds=self.timeout))
        except RuntimeError as e:  # DistStoreError and the FileStore's RuntimeError
            if "timeout" not in str(e).lower() and "timed out" not in str(e).lower():
                raise
            raise _timeout_error(tag, key, [expected_rank], self.rank, self.timeout) from e
        return self._store.get(key)

    def allgather(self, tag: str, payload) -> list:
        seq = _kv_seq()
        keys = [f"{seq}/{tag}/{r}" for r in range(self.num_ranks)]
        self._store.set(keys[self.rank], json.dumps(payload))
        out = [json.loads(self._get(k, tag, r)) for r, k in enumerate(keys)]
        # the last rank to finish reading reclaims the payloads (feature-key
        # lists can be megabytes); reclamation failing fails nothing
        if self._store.add(f"{seq}/{tag}/reads", 1) == self.num_ranks:
            try:
                for k in keys + [f"{seq}/{tag}/reads"]:
                    self._store.delete_key(k)
            except RuntimeError as e:
                logger.warning("exchange %r: reclaiming its keys failed: %s", tag, e)
        return out

    def barrier(self, tag: str) -> None:
        self.allgather(f"__barrier__/{tag}", None)


def default_exchange(timeout: float = DEFAULT_EXCHANGE_TIMEOUT) -> MetadataExchange:
    """The exchange of the current run: the key-value exchange over the
    group's store when the group has more than one rank, the single-process
    one otherwise."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return DistributedKVExchange(timeout)
    return SingleProcessExchange()


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _placed(tree, device):
    if isinstance(tree, dict):
        return {k: _placed(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_placed(v, device) for v in tree)
    if tree is None:
        return None
    t = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(np.asarray(tree))
    return t.to(device).contiguous()


def assemble_partitioned(blocks, exchange: MetadataExchange, *, device=None,
                         tag: str = "assemble"):
    """This rank's block of partitioned arrays, on this rank's device.

    The JAX package assembles a global array from per-rank blocks; the
    port's ranks hold only their own rows, so ``blocks`` (a tensor, array,
    or a dict/list tree of them) is this rank's, and what remains of the
    assembly is its check: every rank's blocks must have the same shapes and
    dtypes, agreed by one small allgather through ``exchange``, or it raises
    ``ValueError`` naming the first block and the ranks that disagree."""
    leaves = list(_leaves(blocks))
    mine = [[path, list(np.shape(v)), str(v.dtype).replace("torch.", "")]
            for path, v in leaves]
    gathered = exchange.allgather(f"assemble_partitioned/{tag}", mine)
    for r, theirs in enumerate(gathered):
        if theirs != mine:
            diff = next(((a, b) for a, b in zip(mine, theirs) if a != b),
                        (mine[len(theirs):len(theirs) + 1], theirs[len(mine):len(mine) + 1]))
            raise ValueError(
                f"assemble_partitioned({tag!r}): rank {r}'s blocks differ from rank "
                f"{exchange.rank}'s ({diff[1]} against {diff[0]}); every rank's block must "
                "have one shape and dtype (read through io/partitioned_reader.read_partitioned)")
    return _placed(blocks, device)
