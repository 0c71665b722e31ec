"""Out-of-core streamed epochs: exact chunked GLM objectives.

Counterpart of ``photon_ml_tpu/algorithm/streaming.py``. The reference computes value, gradient and Hessian-vector products as an
``RDD.treeAggregate`` over partitions (photon-lib
DistributedGLMLossFunction.scala:91-135). A GLM objective is a sum over
samples, so one epoch over fixed-shape chunks accumulates the exact value,
gradient or Hv: each chunk's host arrays are copied to the device
(``io/stream_reader.DenseChunk.to_device``, one synchronous copy per array)
while the decode thread prepares the next chunk, and the chunk's data part
is added in ``w``'s dtype, in chunk order. A dense chunk is evaluated by
``ops/objective.GLMObjective`` (on the card, the fused kernel B1 and its
reduce), a sparse chunk by ``ops/sparse_objective.SparseGLMObjective`` (the
gather kernel G1 for the margins and, over the chunk's column-sorted plan,
for Xᵀr). The L2 term is added once per epoch.

Each sparse chunk is a new ``SparseLabeledPointBatch``, so its row plan and
its column-sorted transpose plan are built again for every chunk in every
epoch: a streamed source holds no data across epochs.

Several ranks: with an ``exchange`` of more than one rank, each rank
streams its own chunks and the epoch's value, gradient or Hv accumulators
are summed across ranks in rank order, in f64, through the metadata
exchange (:func:`cross_rank_sum`); every rank then holds the same global
sum, so the solver takes the same steps everywhere. The sample axis never
crosses the exchange, and the L2 term is added once, after the sum.
``mesh=`` takes the port's data-axis mesh (one process per rank,
``parallel/mesh.make_mesh``): its data group is the exchange's ranks, and
without an ``exchange`` the group's key-value exchange along the data axis
is used. The JAX package's single-process multi-device mesh, which places
each chunk over the devices of one process, has no counterpart here.
"""

from __future__ import annotations

import base64
import time
from functools import partial
from typing import Callable, Sequence

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.io.stream_reader import DEFAULT_CHUNK_TIMEOUT, ChunkPrefetcher, ChunkSource
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective
from photon_ml_torch.telemetry import tracing
from photon_ml_torch.telemetry.program_ledger import ledger_call

#: the parts of an epoch's wall time that :attr:`StreamingGLMObjective.totals` sums
EPOCH_PARTS = ("seconds", "decode", "wait", "copy", "accumulate", "exchange", "bytes",
               "chunks")


def _pack_f64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, dtype="<f8").tobytes()).decode("ascii")


def _unpack_f64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<f8")


def cross_rank_sum(exchange, arrays: Sequence[np.ndarray], tag: str = "stream_accumulator"
                   ) -> list[np.ndarray]:
    """Model-sized host arrays summed over the exchange's ranks in rank
    order, in f64: every rank computes the same sum."""
    shapes = [np.shape(a) for a in arrays]
    flat = np.concatenate([np.asarray(a, dtype=np.float64).ravel() for a in arrays])
    gathered = exchange.allgather(tag, {"acc": _pack_f64(flat)})
    total = np.zeros_like(flat)
    for g in gathered:  # rank order, the exchange's contract
        total = total + _unpack_f64(g["acc"])
    out, pos = [], 0
    for shape in shapes:
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out.append(total[pos:pos + size].reshape(shape))
        pos += size
    return out


def resolve_rank_exchange(mesh, exchange):
    """The exchange a streamed objective sums over: ``exchange``, or, for a
    port mesh without one, the group's key-value exchange along its data
    axis. A mesh must be the port's data-axis ``DeviceMesh`` whose data axis
    is the exchange's ranks."""
    if mesh is None:
        return exchange
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            "mesh= takes the port's data-axis mesh (parallel/mesh.make_mesh: one process per "
            "rank); a single-process multi-device mesh has no counterpart here — run one "
            f"process per rank (got {type(mesh).__name__})")
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.mesh import data_size, model_size

    if exchange is None:
        exchange = multihost.default_exchange()
        if model_size(mesh) > 1:
            exchange = multihost.DataAxisExchange(exchange, mesh)
    if exchange.num_ranks != data_size(mesh):
        raise ValueError(f"the exchange has {exchange.num_ranks} ranks but the mesh's data "
                         f"axis has {data_size(mesh)}; pass the exchange of the mesh's data "
                         "group")
    return exchange


@partial(ledger_call, label="streaming/accumulate_value_grad", static_argnames=("objective",))
def _accumulate_value_grad(acc_value, acc_grad, coefficients, batch, *, objective):
    """One chunk's (value, gradient) added to the epoch's accumulators."""
    value, grad = objective.value_and_gradient(coefficients, batch)
    return acc_value + value, acc_grad + grad


@partial(ledger_call, label="streaming/accumulate_hessian_vector",
         static_argnames=("objective",))
def _accumulate_hessian_vector(acc_hv, coefficients, vector, batch, *, objective):
    """One chunk's Hessian-vector product added to the epoch's accumulator."""
    return acc_hv + objective.hessian_vector(coefficients, vector, batch)


class StreamingGLMObjective:
    """A GLM objective whose every evaluation is one chunked epoch.

    It has the bound-objective interface (``value``, ``value_and_grad``,
    ``hessian_vector``) that ``optim/optimizer.solve`` drives, and
    ``.objective`` is the per-chunk dense or sparse objective (its loss is
    what ``solve`` inspects). ``l2_weight`` lives here: the chunks add the
    data part only.

    ``sync_timing``: synchronize the device after each chunk's copy and
    accumulation, so ``last_epoch`` splits the epoch exactly (the split
    costs the overlap of the copy with the previous chunk's kernels; off by
    default). ``last_epoch`` and ``totals`` hold the seconds of the epoch
    (``seconds``), of decoding (``decode``, in the decode thread), of the
    consumer's waits for a chunk (``wait``), of host-to-device copies
    (``copy``), of accumulation (``accumulate``) and of the cross-rank sum
    (``exchange``), the bytes copied and the chunks;
    ``last_epoch["overlap"]`` is the share of decode time hidden behind the
    consumer.

    exchange: a ``MetadataExchange`` of several ranks sums each epoch's
    accumulators across them (:func:`cross_rank_sum`); mesh: the port's
    data-axis mesh (:func:`resolve_rank_exchange`).
    """

    def __init__(self, source: ChunkSource, loss, *, l2_weight: float = 0.0,
                 normalization=None, mesh=None, exchange=None, prefetch: bool = True,
                 retry_policy=None, chunk_timeout: float = DEFAULT_CHUNK_TIMEOUT,
                 use_kernel: bool | None = None, device=None, sync_timing: bool = False):
        self.exchange = resolve_rank_exchange(mesh, exchange)
        self.mesh = mesh
        self.source = source
        self.l2_weight = float(l2_weight)
        cls = SparseGLMObjective if source.sparse else GLMObjective
        self.objective = cls(loss, 0.0, normalization=normalization, use_kernel=use_kernel)
        self.device = resolve_device(device)
        self.prefetch = bool(prefetch)
        self.retry_policy = retry_policy
        self.chunk_timeout = float(chunk_timeout)
        self.sync_timing = bool(sync_timing)
        #: epochs run so far (one per objective evaluation)
        self.epochs = 0
        self.last_epoch: dict = {}
        self.totals = dict.fromkeys(EPOCH_PARTS, 0.0)

    def _sync(self) -> None:
        if self.sync_timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _epoch(self, fold: Callable, carry):
        t_start = time.perf_counter()
        copy_s = acc_s = 0.0
        nbytes = chunks = 0
        # host wall-clock spans: without sync_timing the accumulate span
        # measures the host's copy and launches, not the device's work
        with tracing.span("stream/epoch", cat="stream", epoch=self.epochs,
                          chunks=self.source.num_chunks), \
                ChunkPrefetcher(self.source, prefetch=self.prefetch,
                                retry_policy=self.retry_policy,
                                chunk_timeout=self.chunk_timeout) as stream:
            for i, chunk in enumerate(stream):
                t0 = time.perf_counter()
                with tracing.span("stream/accumulate", cat="stream", chunk=i):
                    batch = chunk.to_device(self.device)
                    self._sync()
                    t1 = time.perf_counter()
                    carry = fold(carry, batch)
                    self._sync()
                copy_s += t1 - t0
                acc_s += time.perf_counter() - t1
                nbytes += chunk.nbytes
                chunks += 1
        self.epochs += 1
        self.last_epoch = dict(seconds=time.perf_counter() - t_start,
                               decode=stream.decode_seconds, wait=stream.wait_seconds,
                               copy=copy_s, accumulate=acc_s, exchange=0.0, bytes=nbytes,
                               chunks=chunks, overlap=stream.overlap_fraction)
        return carry

    def _close_epoch(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The epoch's accumulators summed across ranks (as they are with one
        rank), then the epoch's parts added to :attr:`totals`."""
        if self.exchange is not None and self.exchange.num_ranks > 1:
            t0 = time.perf_counter()
            summed = cross_rank_sum(self.exchange, [t.detach().cpu().numpy() for t in tensors])
            tensors = [torch.as_tensor(a, dtype=t.dtype).reshape(t.shape).to(t.device)
                       for a, t in zip(summed, tensors)]
            self.last_epoch["exchange"] = time.perf_counter() - t0
            self.last_epoch["seconds"] += self.last_epoch["exchange"]
        for key in EPOCH_PARTS:
            self.totals[key] += self.last_epoch[key]
        return list(tensors)

    # -- bound-objective interface --------------------------------------------

    def value_and_grad(self, w: torch.Tensor):
        def fold(carry, batch):
            return _accumulate_value_grad(carry[0], carry[1], w, batch,
                                          objective=self.objective)

        acc_f, acc_g = self._close_epoch(self._epoch(
            fold, (torch.zeros((), dtype=w.dtype, device=w.device), torch.zeros_like(w))))
        if self.l2_weight > 0.0:
            acc_f = acc_f + 0.5 * self.l2_weight * torch.dot(w, w)
            acc_g = acc_g + self.l2_weight * w
        return acc_f, acc_g

    def value(self, w: torch.Tensor) -> torch.Tensor:
        return self.value_and_grad(w)[0]

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        (acc,) = self._close_epoch([self._epoch(
            lambda carry, batch: _accumulate_hessian_vector(carry, w, v, batch,
                                                            objective=self.objective),
            torch.zeros_like(w))])
        if self.l2_weight > 0.0:
            acc = acc + self.l2_weight * v
        return acc


def streaming_summarize(source: ChunkSource, *, prefetch: bool = True, retry_policy=None,
                        chunk_timeout: float = DEFAULT_CHUNK_TIMEOUT) -> dict:
    """Weighted feature statistics from one streamed pass (the chunked
    ``data/batch.summarize`` for normalization over data that never sits in
    memory whole): f64 sums Σw, Σwx, Σwx², max|x| on the host; zero-weight
    padding adds nothing. Dense sources only."""
    if source.sparse:
        raise ValueError(
            "streaming_summarize covers dense sources; sparse shards keep "
            "their own summary path (data.sparse_batch.summarize_sparse)")
    wsum = 0.0
    count = 0
    sum_wx = np.zeros((source.dim,), np.float64)
    sum_wxx = np.zeros((source.dim,), np.float64)
    max_mag = np.zeros((source.dim,), np.float64)
    with ChunkPrefetcher(source, prefetch=prefetch, retry_policy=retry_policy,
                         chunk_timeout=chunk_timeout) as chunks:
        for chunk in chunks:
            x = np.asarray(chunk.features, dtype=np.float64)
            w = np.asarray(chunk.weights, dtype=np.float64)
            wsum += float(w.sum())
            count += int((w != 0).sum())
            sum_wx += w @ x
            sum_wxx += w @ (x * x)
            max_mag = np.maximum(max_mag, np.abs(x).max(axis=0))
    if wsum <= 0.0:
        raise ValueError("streaming_summarize saw no positive-weight samples")
    mean = sum_wx / wsum
    # Σw(x-m)² = Σwx² - 2mΣwx + m²Σw, over wsum-1 like the in-core summary
    var = (sum_wxx - 2.0 * mean * sum_wx + mean * mean * wsum) / max(wsum - 1.0, 1.0)
    return {"count": count, "weight_sum": wsum, "mean": mean,
            "variance": np.maximum(var, 0.0), "max_magnitude": max_mag}
