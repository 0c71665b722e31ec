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
  partitioned read over a mesh with a model axis).
- Generation fencing and abort markers (``resilience/coordinated.py``):
  ``set_generation(g)`` moves every later key into a generation-``g``
  namespace and restarts the per-instance call sequence at 0, so the ranks
  of a restarted attempt agree again and a dead attempt's keys never
  satisfy a new one's wait. ``post_abort`` publishes a rank-attributed
  marker (the first writer wins); a fenced wait that sees a peer's marker
  raises ``resilience.PeerAbort`` naming it. Markers are written only on
  the failure path and read only when a wait's slice expires, so a healthy
  fenced run makes the same store operations as an unfenced one.

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
import time

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
        _STORE.update(store=store, timeout=timeout)
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


def reinitialize(prefix: str) -> ProcessInfo:
    """Tear the process group down and join a new one of the same ranks,
    backend and timeout, rendezvousing under ``prefix`` in the same store
    (every rank calls it with the same prefix). A coordinated restart uses
    it after a rank failed inside a device collective: the peer blocked in
    that collective ends at the group's timeout, and the group's operation
    sequence is then out of step. Metadata exchanges keep working: they use
    the store, not the group."""
    info = process_info()
    store, timeout = group_store(), _STORE["timeout"]
    dist.destroy_process_group()
    dist.init_process_group(backend=info.backend, store=dist.PrefixStore(prefix, store),
                            rank=info.rank, world_size=info.world_size, timeout=timeout)
    return process_info()


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
    of calls.

    ``generation`` is the fence generation (None: the unfenced keyspace);
    ``fence_epoch`` tells apart successive fencing sessions over one
    transport (a driver ``run()`` called twice), and grows whenever a new
    fence starts (the first ``set_generation``, or a generation that does
    not increase)."""

    rank: int = 0
    num_ranks: int = 1
    generation: "int | None" = None
    fence_epoch: int = 0

    def allgather(self, tag: str, payload) -> list:
        """All ranks' ``payload``s, ordered by rank."""
        raise NotImplementedError

    def barrier(self, tag: str) -> None:
        """Block until every rank reaches this barrier."""
        raise NotImplementedError

    def set_generation(self, generation: int) -> None:
        """Adopt the generation-``generation`` namespace (every rank calls at
        the same point: the coordinator's restart rendezvous)."""
        generation = int(generation)
        if self.generation is None or generation <= self.generation:
            self.fence_epoch += 1
        self.generation = generation

    def fence_namespace(self) -> str:
        """A name of the current fencing session and generation that no
        other session or generation of this run shares (the same on every
        rank): a coordinated restart keys its new process group by it."""
        return f"e{self.fence_epoch}g{self.generation}"

    def post_abort(self, info: dict) -> None:
        """Publish an abort marker for the current generation (best effort;
        ``info`` has at least ``rank`` and ``cause``). No peers here."""

    def pending_abort(self) -> "dict | None":
        """A peer's abort marker for the current generation, or None; this
        rank's own marker is never returned."""
        return None

    def _shape_marker(self, marker) -> "dict | None":
        """A raw marker as :meth:`pending_abort` returns it: a corrupt
        (non-dict) payload still ends the wait, unattributed; this rank's
        own marker is invisible."""
        if marker is None:
            return None
        if not isinstance(marker, dict):
            return {"rank": None, "cause": f"unparseable marker {marker!r}"}
        if marker.get("rank") == self.rank:
            return None
        return marker

    def _raise_abort(self, tag: str, marker: dict):
        from photon_ml_torch.resilience.errors import PeerAbort

        origin = marker.get("rank")
        raise PeerAbort(tag, origin_rank=None if origin is None else int(origin),
                        cause=str(marker.get("cause", "")), generation=self.generation,
                        rank=self.rank)


class DataAxisExchange(MetadataExchange):
    """``base`` seen along a mesh's data axis: ``rank``/``num_ranks`` are the
    data rank and the data axis, and :meth:`allgather` returns one payload
    per data rank (that of its model rank 0). Every process of the group
    still makes every call, so the ranks of one data row (which read the
    same block of a partitioned input) stay in step, and no row of the input
    is counted more than once. Fencing is the base's; an abort marker
    carries the process rank in the base and the data rank here."""

    def __init__(self, base: MetadataExchange, mesh):
        from photon_ml_torch.parallel.mesh import data_rank, data_size, model_size

        self.base = base
        self.rank = data_rank(mesh)
        self.num_ranks = data_size(mesh)
        self._stride = model_size(mesh)

    @property
    def generation(self):
        return self.base.generation

    @property
    def fence_epoch(self):
        return self.base.fence_epoch

    def set_generation(self, generation: int) -> None:
        self.base.set_generation(generation)

    def fence_namespace(self) -> str:
        return self.base.fence_namespace()

    def post_abort(self, info: dict) -> None:
        self.base.post_abort({**info, "rank": self.base.rank} if isinstance(info, dict)
                             else info)

    def pending_abort(self) -> "dict | None":
        marker = self.base.pending_abort()
        if marker is not None and marker.get("rank") is not None:
            marker = {**marker, "rank": int(marker["rank"]) // self._stride}
        return marker

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
    apart (every rank makes the same calls, so the sequences agree);
    ``set_generation`` restarts it at 0."""

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
        store = {"cond": threading.Condition(), "gather": {}, "reads": {}, "aborts": {}}
        return [cls(store, r, num_ranks, timeout=timeout) for r in range(num_ranks)]

    def set_generation(self, generation: int) -> None:
        super().set_generation(generation)
        self._seq = 0

    def post_abort(self, info: dict) -> None:
        cond = self._store["cond"]
        with cond:
            # the first writer of a generation wins: it names the first failure
            self._store["aborts"].setdefault((self.fence_epoch, self.generation),
                                             dict(info) if isinstance(info, dict) else info)
            cond.notify_all()

    def pending_abort(self) -> "dict | None":
        return self._shape_marker(
            self._store["aborts"].get((self.fence_epoch, self.generation)))

    def allgather(self, tag: str, payload) -> list:
        key = (self.fence_epoch, self.generation, self._seq, tag)
        self._seq += 1
        cond, slot = self._store["cond"], self._store["gather"]
        with cond:
            entry = slot.setdefault(key, {})
            entry[self.rank] = payload
            cond.notify_all()
            cond.wait_for(lambda: len(slot[key]) == self.num_ranks
                          or self.pending_abort() is not None, timeout=self.timeout)
            if len(slot[key]) != self.num_ranks:
                marker = self.pending_abort()
                if marker is not None:
                    self._raise_abort(tag, marker)
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

    Unfenced keys take the process-global sequence (two instances in one
    process never collide). Fenced keys (``set_generation``) live under a
    namespace of the fencing session's nonce (this rank's count of fencing
    sessions, kept in the store) and the generation, and take a
    per-instance sequence that ``set_generation`` restarts at 0. A fenced wait polls in slices of
    :attr:`ABORT_POLL_MS` and reads the generation's abort marker only when
    a slice expires. The marker is written with ``compare_set`` against an
    absent key, so the first writer wins. One fenced exchange per process
    (the coordinator's).

    ``store``/``rank``/``num_ranks`` are injectable (tests); by default the
    group's store and place. :attr:`counts` tallies this instance's
    allgathers (barriers among them) and the JSON bytes it published and
    read."""

    #: slice of a fenced wait, between two reads of the abort marker
    ABORT_POLL_MS = 500

    def __init__(self, timeout: float = DEFAULT_EXCHANGE_TIMEOUT, *, store=None,
                 rank: int | None = None, num_ranks: int | None = None):
        base = store if store is not None else group_store()
        self._store = dist.PrefixStore("photon/xchg", base)
        self._aborts = dist.PrefixStore("photon/abort", base)
        self.timeout = float(timeout)
        self.rank = dist.get_rank() if rank is None else int(rank)
        self.num_ranks = dist.get_world_size() if num_ranks is None else int(num_ranks)
        self._gen_seq = 0
        self._fence_nonce = 0
        self.counts = {"allgathers": 0, "bytes_sent": 0, "bytes_received": 0}

    def set_generation(self, generation: int) -> None:
        new_fence = self.generation is None or int(generation) <= self.generation
        super().set_generation(generation)
        if new_fence:
            # the store outlives this session: a later session must not
            # reuse an earlier one's keys. The nonce counts this rank's
            # sessions in the store; every rank fences at the same points,
            # so the counts agree
            self._fence_nonce = int(self._store.add(f"fence_sessions/{self.rank}", 1))
        self._gen_seq = 0

    def _namespace(self) -> str:
        return f"e{self._fence_nonce}g{self.generation}"

    def fence_namespace(self) -> str:
        return self._namespace()

    def post_abort(self, info: dict) -> None:
        try:
            self._aborts.compare_set(self._namespace(), "", json.dumps(info))
        except (RuntimeError, TypeError, ValueError) as e:
            # best effort: the peers fall back to their deadlines
            logger.warning("abort-marker write failed: %s", e)

    def pending_abort(self) -> "dict | None":
        if self.generation is None:
            return None
        key = self._namespace()
        try:
            if not self._aborts.check([key]):
                return None
            raw = self._aborts.get(key)
        except RuntimeError:
            return None
        try:
            marker = json.loads(raw)
        except (TypeError, ValueError):
            marker = raw  # corrupt: shaped unattributed
        return self._shape_marker(marker)

    def _next_seq(self) -> int:
        if self.generation is None:
            return _kv_seq()
        seq, self._gen_seq = self._gen_seq, self._gen_seq + 1
        return seq

    def _get(self, key: str, tag: str, expected_rank: int) -> bytes:
        def timed_out(e) -> bool:
            return "timeout" in str(e).lower() or "timed out" in str(e).lower()

        if self.generation is None:
            try:
                self._store.wait([key], datetime.timedelta(seconds=self.timeout))
            except RuntimeError as e:  # DistStoreError and the FileStore's RuntimeError
                if not timed_out(e):
                    raise
                raise _timeout_error(tag, key, [expected_rank], self.rank, self.timeout) from e
            return self._store.get(key)
        # fenced: slice the deadline; only an expired slice reads the marker
        deadline = time.monotonic() + self.timeout
        while True:
            remaining = deadline - time.monotonic()
            try:
                self._store.wait([key], datetime.timedelta(
                    seconds=max(0.001, min(self.ABORT_POLL_MS / 1000.0, remaining))))
                return self._store.get(key)
            except RuntimeError as e:
                if not timed_out(e):
                    raise
                marker = self.pending_abort()
                if marker is not None:
                    self._raise_abort(tag, marker)
                if time.monotonic() >= deadline:
                    raise _timeout_error(tag, key, [expected_rank], self.rank,
                                         self.timeout) from e

    def allgather(self, tag: str, payload) -> list:
        seq = self._next_seq()
        prefix = f"{seq}/{tag}" if self.generation is None else \
            f"{self._namespace()}/{seq}/{tag}"
        keys = [f"{prefix}/{r}" for r in range(self.num_ranks)]
        mine = json.dumps(payload)
        self._store.set(keys[self.rank], mine)
        raw = [self._get(k, tag, r) for r, k in enumerate(keys)]
        out = [json.loads(v) for v in raw]
        self.counts["allgathers"] += 1
        self.counts["bytes_sent"] += len(mine)
        self.counts["bytes_received"] += sum(len(v) for v in raw)
        # the last rank to finish reading reclaims the payloads (feature-key
        # lists can be megabytes); reclamation failing fails nothing
        if self._store.add(f"{prefix}/reads", 1) == self.num_ranks:
            try:
                for k in keys + [f"{prefix}/reads"]:
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
