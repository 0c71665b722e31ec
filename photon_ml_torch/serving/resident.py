"""Resident scorer: one GAME model placed on the device once, one captured
CUDA graph per micro-batch signature.

Counterpart of ``photon_ml_tpu/serving/resident.py``; reference photon-api
transformers/GameTransformer.scala:156-203 scores a partition per batch job
and builds its scorer each time. Here the model's parameters are placed once
(``DistributedScorer.resident_params``: copies at fixed device addresses)
and every request pays only its host assembly and one graph replay.

Requests pad into a small fixed set of power-of-two row buckets (pad rows
carry weight 0, entity index -1 and zero features, so they score nothing
into the real rows), and every flat entry axis (a sparse fixed effect's
entries, a compact random effect's entries on a sparse shard) pads to a
power of two of at least ``MIN_NNZ_BUCKET`` entries with inert pads (value
0, the last row repeated, the scratch slot). The signature of a micro-batch
is its bucket, its coordinates' layouts and, per entry axis, the padded
length, the long rows and the chunk count of its gather plan: those fix
every launch parameter of the program (the kernel each gather takes follows
from the bucket and the padded length), so the signature set stays bounded
by the buckets, the layouts and the entry-axis lengths a request can reach.
A request larger than the largest bucket splits across micro-batches.

On the card each new signature is captured once into a ``torch.cuda.CUDAGraph``
over static input buffers (after one eager warm-up run on a side stream);
later micro-batches of that signature copy their inputs into those buffers
and replay it. Every plan is built on the host with numpy before the copy,
so nothing in the graph reads a value back. A failed capture raises: there
is no eager fallback on the card. On the CPU (the model's tensors there) the
same padded-bucket program runs eagerly with the kernels' plain versions.

The launch counters of the kernels (``ops/sparse_gather.launches`` and the
rest) count kernels that ran. A capture records launches without running
them, so what it adds is taken back, and each replay adds the launches its
graph holds. Those follow from the signature (:func:`_graph_launches`: the
kernel each entry axis takes and whether it has a chunk plan), not from the
counters' change across the capture, so launches another thread makes
meanwhile are not taken into the graph's count.

Each capture is a compile of the port (``telemetry/probes.record_compile``,
with its seconds and the bytes its graph's pool reserved), and each
micro-batch runs under the program label ``serve/score``
(``telemetry/program_ledger.ledger_call``): with a ledger installed, a
capture after the first journals the input leaves whose shapes changed.

A hot swap (:meth:`ResidentScorer.swap_model`) copies the new parameters
into the resident buffers, so every captured graph scores the new model and
no new capture is made. One lock covers both a micro-batch's "assemble,
copy inputs, replay, read scores" and a swap's "copy parameters", so a
micro-batch is scored wholly by the old model or wholly by the new one.

A request is read on the host (its host arrays: ``GameDataset.host_array``
and a sparse shard's coalesced triple), so its dataset may live on the CPU
while the model lives on the card: a micro-batch then costs one copy of its
inputs to the device.

``bf16=True`` casts the feature blocks and the parameters along the whole
path (not bitwise; the default path is held bitwise against
``DistributedScorer.score_dataset`` of the same padded rows).
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time

import numpy as np
import torch

from photon_ml_torch.data.game_data import (
    GameDataset,
    concat_game_datasets,
    slice_game_dataset,
)
from photon_ml_torch.models import game
from photon_ml_torch.models.game import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.parallel.scoring import MIN_NNZ_BUCKET, DistributedScorer
from photon_ml_torch.telemetry import probes, serving_counters, tracing
from photon_ml_torch.telemetry.program_ledger import current_ledger, ledger_call

__all__ = ["DEFAULT_MICROBATCH_SHAPES", "MIN_NNZ_BUCKET", "ModelSwapError", "ResidentScorer"]

#: default micro-batch shape buckets (rows); requests pad to the smallest
#: bucket that fits and split across the largest when they exceed it
DEFAULT_MICROBATCH_SHAPES = (64, 256, 1024)

def _graph_launches(layouts: dict, entry_sig: tuple, params: dict, bucket: int) -> dict:
    """The kernel launches one run of a signature's program makes, keyed by
    (module, counter): per entry axis the row or segment kernel (the one
    ``ops/sparse_gather`` picks for the axis's padded length) and the chunk
    kernel where it has a chunk plan; a compact effect's row or segment
    launch also counts in ``models/game.compact_launches``, and an empty
    compact table launches nothing."""
    out: dict = {}
    for cid, target, _, count in entry_sig:
        if layouts[cid] == "entries" and params[cid]["table_ext"].shape[0] == 0:
            continue
        keys = [(sparse_gather, sparse_gather.tail_kernel_counter(bucket, target))]
        if count:
            keys.append((sparse_gather, "chunk_launches"))
        if layouts[cid] == "entries":
            keys.append((game, "compact_launches"))
        for key in keys:
            out[key] = out.get(key, 0) + 1
    return out


def _add_counts(counts: dict, sign: int = 1) -> None:
    for (m, a), v in counts.items():
        setattr(m, a, getattr(m, a) + sign * v)


def _model_device(model: GameModel) -> torch.device:
    for m in model.models.values():
        if isinstance(m, FixedEffectModel):
            return m.glm.coefficients.means.device
        if isinstance(m, RandomEffectModel):
            return m.coefficients.device
        return m.row_factors.device
    raise ValueError("GameModel has no sub-models")


class ModelSwapError(ValueError):
    """A hot swap rejected by the layout fingerprint guard: the new model's
    parameter layout differs from the resident one's (the message names the
    differing fields). The resident model keeps serving; a layout change
    needs a fresh scorer (and a warm-up)."""


@dataclasses.dataclass
class _Graph:
    """One captured signature: the graph, its static inputs and output, and
    the launches each replay makes."""

    graph: "torch.cuda.CUDAGraph"
    inputs: dict
    out: torch.Tensor
    launches: dict


class ResidentScorer:
    """A GameModel resident on its device behind a bounded set of captured
    micro-batch score programs.

    shapes: the micro-batch buckets (positive powers of two, ascending,
    unique). mesh: accepted only as the port's one-process data-axis mesh
    (``parallel.mesh.make_mesh()`` in a group of one), whose data axis each
    shape must divide; it does not change the program, which runs on the
    model's device. Several ranks raise, since multi-rank batch scoring is
    ``DistributedScorer.score_partitioned``. bf16: whole-path bf16 features
    and parameters (not bitwise)."""

    def __init__(self, model: GameModel, *, shapes=DEFAULT_MICROBATCH_SHAPES, mesh=None,
                 bf16: bool = False):
        shapes = tuple(int(s) for s in shapes)
        if not shapes:
            raise ValueError("shapes must name at least one micro-batch size")
        for s in shapes:
            if s <= 0 or s & (s - 1):
                raise ValueError(
                    f"micro-batch shape {s} is not a positive power of two — "
                    "the bucket set bounds the compiled-signature count only "
                    "when shapes come from a fixed geometric ladder"
                )
        if sorted(set(shapes)) != list(shapes):
            raise ValueError(f"shapes must be ascending and unique: {shapes}")
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            raise ValueError(
                "ResidentScorer is the single-process serving path; "
                "multi-process batch scoring goes through "
                "DistributedScorer.score_partitioned"
            )
        if mesh is not None:
            from photon_ml_torch.parallel import mesh as mesh_ops

            mesh_ops.check_data_mesh(mesh)
            data_axis = mesh_ops.data_size(mesh)
            for s in shapes:
                if s % data_axis:
                    raise ValueError(
                        f"micro-batch shape {s} does not divide the mesh "
                        f"data axis {data_axis}"
                    )
        self._scorer = DistributedScorer(model)
        # the "serve/score" program label: with a ProgramLedger installed,
        # every capture (a compile of the port) journals its signature and,
        # after the first, the leaves that changed
        self._program = ledger_call(self._run, label="serve/score", static_argnums=(3, 4, 5))
        self.model = model
        self.shapes = shapes
        self.bf16 = bool(bf16)
        self.device = _model_device(model)
        #: CUDA graphs captured so far (the counterpart of a compile)
        self.captures = 0
        self._graphs: dict = {}
        self._signatures: set = set()
        self._lock = threading.Lock()

    @property
    def signatures(self) -> "frozenset":
        """(bucket, layouts, entry-axis) signatures scored so far."""
        return frozenset(self._signatures)

    def _bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.shapes, n)
        return self.shapes[min(i, len(self.shapes) - 1)]

    # -- zero-downtime model refresh ----------------------------------------

    def swap_model(self, new_model: GameModel) -> None:
        """Swap to a refreshed model of the same parameter layout while
        requests keep flowing: the new parameters are copied into the
        resident buffers, so no graph is captured anew. A layout-changing
        model raises :class:`ModelSwapError` naming the differing fields
        before anything changes, and the resident model keeps serving."""
        with self._lock:
            try:
                self._scorer.swap_model_params(new_model)
            except ValueError as e:
                serving_counters.record_swap_rejected()
                raise ModelSwapError(
                    f"model swap rejected: {e} — build a fresh ResidentScorer "
                    "(and warm it) for a layout-changing refresh"
                ) from e
            self.model = new_model
        serving_counters.record_model_swap()
        ledger = current_ledger()
        if ledger is not None:
            # a same-layout swap captures nothing, so the label's memory
            # forecast is priced again by hand from the resident bytes
            ledger.refeed_resident_forecast("serve/score")

    # -- scoring -------------------------------------------------------------

    def score(self, dataset: GameDataset) -> np.ndarray:
        """[n] host scores including offsets (``score_dataset``'s) of one
        request, through the bucketed resident program. A request larger
        than the largest bucket splits across micro-batches."""
        n = dataset.num_samples
        if n == 0:
            return np.zeros((0,), np.float32)
        max_shape = self.shapes[-1]
        if n > max_shape:
            serving_counters.record_bucket_split()
            return np.concatenate([
                self._score_bucketed(slice_game_dataset(dataset, lo, min(lo + max_shape, n)))
                for lo in range(0, n, max_shape)])
        return self._score_bucketed(dataset)

    def _score_bucketed(self, dataset: GameDataset) -> np.ndarray:
        n = dataset.num_samples
        bucket = self._bucket_for(n)
        with tracing.span("serve/score", cat="serve", rows=n, bucket=bucket), self._lock:
            inputs, layouts, entry_sig = self._scorer.resident_inputs(dataset, bucket,
                                                                      bf16=self.bf16)
            params = self._scorer.resident_params(layouts, bf16=self.bf16)
            self._signatures.add((bucket, tuple(sorted(layouts.items())), entry_sig))
            arrays = {k: a for k, (a, _) in inputs.items()}
            dtypes = tuple(sorted((k, dt) for k, (_, dt) in inputs.items()))
            out = self._program(arrays, layouts, params, bucket, entry_sig, dtypes)
            scores = out[:n].detach().cpu().numpy()
        serving_counters.set_compiled_signatures(len(self._signatures))
        serving_counters.record_scored(rows=n, padded_rows=bucket - n)
        if self.bf16 and scores.dtype != np.float32:
            scores = scores.astype(np.float32)
        return scores

    def _run(self, arrays, layouts, params, bucket, entry_sig, dtypes) -> torch.Tensor:
        """One micro-batch's program (the ``serve/score`` label): on the card
        the replay of its signature's graph, captured first if it is new;
        on the CPU the eager program. ``dtypes`` holds each input's torch
        dtype, (name, dtype) pairs: a static argument of the label."""
        inputs = {k: (arrays[k], dt) for k, dt in dtypes}
        if self.device.type == "cuda":
            sig = (bucket, tuple(sorted(layouts.items())), entry_sig)
            return self._replay(sig, inputs, layouts, params, bucket)
        tensors = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
                   for k, (a, dt) in inputs.items()}
        return self._scorer.score_resident(layouts, tensors, params, bucket,
                                           {cid: c for cid, _, _, c in entry_sig})

    def _replay(self, sig, inputs, layouts, params, bucket) -> torch.Tensor:
        entry = self._graphs.get(sig)
        if entry is None:
            entry = self._graphs[sig] = self._capture(inputs, layouts, params, bucket, sig[2])
        else:
            for k, (a, _) in inputs.items():
                entry.inputs[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
        entry.graph.replay()
        _add_counts(entry.launches)
        return entry.out

    def _capture(self, inputs, layouts, params, bucket, entry_sig) -> _Graph:
        """Static input buffers holding this micro-batch, one eager run on a
        side stream (it initializes the libraries the program calls), then
        the capture. The whole of it is one compile event of its host
        seconds, with the bytes the graph's memory pool reserved
        (``telemetry/probes.record_compile``)."""
        t0 = time.perf_counter()
        dev = self.device
        counts = {cid: count for cid, _, _, count in entry_sig}
        static = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
                  for k, (a, dt) in inputs.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._scorer.score_resident(layouts, static, params, bucket, counts)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        with torch.cuda.graph(graph):
            out = self._scorer.score_resident(layouts, static, params, bucket, counts)
        pool = torch.cuda.memory_reserved(dev) - reserved
        recorded = _graph_launches(layouts, entry_sig, params, bucket)
        _add_counts(recorded, -1)  # recorded into the graph, not launched
        self.captures += 1
        probes.record_compile(time.perf_counter() - t0, pool_bytes=max(pool, 0))
        return _Graph(graph=graph, inputs=static, out=out, launches=recorded)

    def warm(self, example: GameDataset) -> int:
        """Capture every bucket's signature up front from an example request
        (its rows recycled as needed), so the first live requests capture
        nothing; returns the number of signatures now resident."""
        n = example.num_samples
        if n == 0:
            raise ValueError("warm() needs a non-empty example dataset")
        for shape in self.shapes:
            take = min(n, shape)
            part = slice_game_dataset(example, 0, take) if take < n else example
            reps = -(-shape // take)
            if reps > 1:
                part = concat_game_datasets([part] * reps)
                part = slice_game_dataset(part, 0, shape)
            self._score_bucketed(part)
        return len(self._signatures)
