"""Out-of-core streamed epochs: exact chunked GLM objectives.

Counterpart of ``photon_ml_tpu/algorithm/streaming.py`` for one process.
The reference computes value, gradient and Hessian-vector products as an
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

Several ranks (``mesh=``, an ``exchange`` of more than one rank) are
ROADMAP.md item 16 step 2.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.io.stream_reader import DEFAULT_CHUNK_TIMEOUT, ChunkPrefetcher, ChunkSource
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.ops.sparse_objective import SparseGLMObjective

#: the parts of an epoch's wall time that :attr:`StreamingGLMObjective.totals` sums
EPOCH_PARTS = ("seconds", "decode", "wait", "copy", "accumulate", "bytes", "chunks")


def check_single_process(mesh, exchange) -> None:
    """The streamed solves of this package run in one process."""
    if mesh is not None or (exchange is not None and getattr(exchange, "num_ranks", 1) > 1):
        raise NotImplementedError(
            "streamed solves over several ranks (mesh=, exchange= with more than one rank) "
            "are not ported yet: ROADMAP.md item 16 (step 2)")


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
    (``copy``) and of accumulation (``accumulate``), the bytes copied and
    the chunks; ``last_epoch["overlap"]`` is the share of decode time hidden
    behind the consumer.
    """

    def __init__(self, source: ChunkSource, loss, *, l2_weight: float = 0.0,
                 normalization=None, mesh=None, exchange=None, prefetch: bool = True,
                 retry_policy=None, chunk_timeout: float = DEFAULT_CHUNK_TIMEOUT,
                 use_kernel: bool | None = None, device=None, sync_timing: bool = False):
        check_single_process(mesh, exchange)
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
        with ChunkPrefetcher(self.source, prefetch=self.prefetch, retry_policy=self.retry_policy,
                             chunk_timeout=self.chunk_timeout) as stream:
            for chunk in stream:
                t0 = time.perf_counter()
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
                               copy=copy_s, accumulate=acc_s, bytes=nbytes, chunks=chunks,
                               overlap=stream.overlap_fraction)
        for key in EPOCH_PARTS:
            self.totals[key] += self.last_epoch[key]
        return carry

    # -- bound-objective interface --------------------------------------------

    def value_and_grad(self, w: torch.Tensor):
        def fold(carry, batch):
            value, grad = self.objective.value_and_gradient(w, batch)
            return carry[0] + value, carry[1] + grad

        acc_f, acc_g = self._epoch(fold, (torch.zeros((), dtype=w.dtype, device=w.device),
                                          torch.zeros_like(w)))
        if self.l2_weight > 0.0:
            acc_f = acc_f + 0.5 * self.l2_weight * torch.dot(w, w)
            acc_g = acc_g + self.l2_weight * w
        return acc_f, acc_g

    def value(self, w: torch.Tensor) -> torch.Tensor:
        return self.value_and_grad(w)[0]

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        acc = self._epoch(lambda carry, batch: carry + self.objective.hessian_vector(w, v, batch),
                          torch.zeros_like(w))
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
