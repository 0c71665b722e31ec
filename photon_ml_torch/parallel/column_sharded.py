"""Column-sharded (model-parallel) GLM objectives for giant d.

Counterpart of ``photon_ml_tpu/parallel/column_sharded.py``; reference
photon-lib function/glm/ValueAndGradientAggregator.scala:133-154 (the
per-partition sparse axpy) under DistributedObjectiveFunction's
treeAggregate. The COO entries are partitioned BY COLUMN BLOCK over the
mesh's "model" axis, so each rank owns a contiguous coefficient range and
exactly the entries that touch it. Per evaluation:

    local partial margins   (G1 over the rank's own entries)
    -> all-reduce over "model"   (one [n] collective: the treeAggregate)
    -> pointwise loss on the rank's rows
    -> OWN-column gradient block (the segment kernel over the block's
       column-sorted entries), summed over "data" when rows are sharded too

Nothing of size d is replicated: coefficients, gradient, the solvers' work
vectors and history, and the per-column run bounds are all the rank's
``block = ceil(d / K)`` slice. The JAX package runs its solvers unchanged
over ``P("model")`` vectors and lets XLA turn each dot into a per-shard dot
plus a psum; here the objective hands the solvers :class:`ModelAxisOps`
(``vector_ops``), whose every inner product and norm is a local reduction
plus one all-reduce over "model" (``optim/common.py``).

Two objectives share that evaluation:

- :class:`ColumnShardedGLMObjective` over a :class:`ColumnShardedSparseBatch`
  (sparse entries; G1's row kernel or chunks for the margins, its segment
  kernel for the transpose: a CUDA tensor launches them or raises);
- :class:`FeatureShardedDenseGLMObjective` over a rank's ``[n/D, d/M]``
  dense block (``torch.matmul``: the JAX package computes this product
  outside any Pallas kernel, through GSPMD).

Both take a normalization context over the rank's own columns
(:func:`block_normalization`): the factors apply per own column, and the
standardization shift's margin term ``Σ shift_j·factor_j·w_j`` is a sum over
all columns, so it rides the margins' all-reduce.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch, device_tensor
from photon_ml_torch.data.sparse_batch import SparseShard, _hybrid_arrays, resolve_hybrid_policy
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.losses import PointwiseLoss
from photon_ml_torch.ops.normalization import NormalizationContext, no_normalization
from photon_ml_torch.ops.objective import BoundObjective, _matvec, _rmatvec, chain_rule
from photon_ml_torch.ops.sparse_gather import (
    gather_sum,
    gather_sum_reference,
    pointer_chunks,
    segment_plan,
)
from photon_ml_torch.optim.common import LOCAL, VectorOps
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.telemetry.layout import record_block_head

logger = logging.getLogger(__name__)


class ModelAxisOps(VectorOps):
    """The reductions of a vector sharded over the mesh's "model" axis: the
    rank's local reduction, then one all-reduce over the model group (every
    rank of the group receives the same bits)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def _total(self, local: torch.Tensor) -> torch.Tensor:
        return mesh_ops.all_reduce_sum(local.reshape(1), self.mesh, axis="model")[0]

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._total(torch.dot(a, b))

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(a, a))

    def abs_sum(self, a: torch.Tensor) -> torch.Tensor:
        return self._total(torch.sum(torch.abs(a)))


def vector_ops_for(mesh) -> VectorOps:
    """:class:`ModelAxisOps` over a mesh with a model axis, else the plain
    reductions (:data:`optim.common.LOCAL`)."""
    if mesh is None or mesh_ops.model_size(mesh) == 1:
        return LOCAL
    return ModelAxisOps(mesh)


def fe_columns_of(dim: int, mesh) -> tuple[int, int, int]:
    """``(start, block, dim)`` of this rank's columns of a ``dim``-wide fixed
    effect over the mesh's model axis (blocks of ``ceil(dim / M)``)."""
    block = -(-dim // mesh_ops.model_size(mesh)) if dim else 0
    return (mesh_ops.model_rank(mesh) * block, block, int(dim))


def column_slice(columns: tuple) -> slice:
    """The true (unpadded) global columns of a :func:`fe_columns_of` block."""
    start, block, dim = columns
    return slice(min(start, dim), min(start + block, dim))


def _block_of(t: torch.Tensor, columns: tuple, fill: float = 0.0) -> torch.Tensor:
    """The columns ``columns`` of ``t``'s last axis, padded with ``fill`` to
    the block's width."""
    piece = t[..., column_slice(columns)]
    pad = columns[1] - int(piece.shape[-1])
    if pad:
        piece = torch.nn.functional.pad(piece, (0, pad), value=fill)
    return piece.contiguous()


def split_fe(w: torch.Tensor, columns: tuple) -> torch.Tensor:
    """The ``[block]`` slice ``columns`` (:func:`fe_columns_of`) of a whole
    FE vector, zero-padded past its end."""
    if int(w.shape[0]) != columns[2]:
        raise ValueError(f"a whole FE vector has {columns[2]} coefficients, got "
                         f"{int(w.shape[0])}")
    return _block_of(w, columns)


def feature_block(x: torch.Tensor, columns: tuple) -> torch.Tensor:
    """The ``[n, block]`` columns ``columns`` of a dense ``[n, dim]`` block,
    zero-padded past ``dim`` (the JAX package's ``P(..., "model")`` of a
    feature axis padded to the model axis)."""
    return _block_of(x, columns)


def block_normalization(norm: NormalizationContext | None,
                        columns: tuple) -> NormalizationContext:
    """The context of the columns ``columns`` of ``norm`` (factor 1 and shift
    0 on the padding lanes, which hold no data)."""
    if norm is None or norm.is_identity:
        return no_normalization()
    return NormalizationContext(
        None if norm.factors is None else _block_of(norm.factors, columns, 1.0),
        None if norm.shifts is None else _block_of(norm.shifts, columns))


@dataclasses.dataclass
class ColumnShardedSparseBatch:
    """Flat-COO entries grouped into column blocks.

    Entry arrays are ``[B, m]``: B held blocks (all ``num_blocks`` as built,
    one after :func:`shard_column_batch`), each padded to the widest block's
    m entries. Column ids are LOCAL to the block (``col - k·block``). Two
    sorted layouts of the same entries: row-sorted (margins) and
    column-sorted with run bounds (gradient and Hv). Pad slots carry value
    0, local column 0 and the last row id; ``local_bounds`` count the true
    entries only.

    ``dim`` is the true coefficient count; ``block·num_blocks >= dim`` and
    coefficients beyond ``dim`` are padding lanes pinned at 0 by zero data
    and L2. ``block_index`` is the held block's index (None: every block).
    ``hot_vals [B, n, h]`` / ``hot_local_cols [B, h]``: the optional hybrid
    head, selected globally and split by the same contiguous-range rule
    (pad slots carry local column 0 over an all-zero column); the COO
    arrays then hold only the cold tail.
    """

    values: torch.Tensor
    local_cols: torch.Tensor
    row_ids: torch.Tensor
    vals_by_col: torch.Tensor
    rows_by_col: torch.Tensor
    local_bounds: torch.Tensor
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    dim: int
    block: int
    num_blocks: int
    block_index: int | None = None
    hot_vals: torch.Tensor | None = None
    hot_local_cols: torch.Tensor | None = None
    #: the held block's gather plans, built once (:meth:`plans`)
    _plans: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def has_hot_head(self) -> bool:
        return self.hot_vals is not None

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])

    @property
    def padded_dim(self) -> int:
        return self.num_blocks * self.block

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def replace(self, **changes) -> "ColumnShardedSparseBatch":
        """A copy with ``changes``; the gather plans survive a change of the
        per-sample vectors alone."""
        keep = set(changes) <= {"labels", "offsets", "weights"}
        return dataclasses.replace(self, _plans=self._plans if keep else None, **changes)

    def plans(self):
        """(row_ptr, row_chunks, col_chunks, col_nnz) of the held block: the
        margins' row pointers and long-row chunks, the transpose's
        long-column chunks (``ops/sparse_gather``) and its count of true
        entries (the column-sorted pads follow them), built once on the
        batch's device."""
        if self.block_index is None:
            raise ValueError("a batch of every block has no rank plan; shard it first "
                             "(shard_column_batch)")
        if self._plans is None:
            row_ptr, row_chunks = segment_plan(self.row_ids[0], self.num_samples)
            self._plans = (row_ptr, row_chunks, pointer_chunks(self.local_bounds[0]),
                           int(self.local_bounds[0, -1]))
        return self._plans


def _block_hot_head(hot_block: np.ndarray, hot_ids: np.ndarray, k: int,
                    block: int) -> tuple[np.ndarray, np.ndarray]:
    """Regroup a global ``[n, k_hot]`` hot head into per-block ``[K, n, h]``
    dense sub-blocks with LOCAL column ids, by the tail's contiguous-range
    rule. Pad slots carry local column 0 over an all-zero column."""
    n = hot_block.shape[0]
    kh = hot_ids.shape[0]
    blk = (hot_ids // block).astype(np.int64)
    local = (hot_ids - blk * block).astype(np.int64)
    counts = np.bincount(blk, minlength=k) if kh else np.zeros(k, np.int64)
    h = max(int(counts.max(initial=0)), 1)
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # hot_ids are sorted, so each block's ids are contiguous in the input
    slot = np.arange(kh) - starts[blk]
    out_v = np.zeros((k, n, h), dtype=hot_block.dtype)
    out_c = np.zeros((k, h), dtype=np.int32)
    if kh:
        out_v[blk, :, slot] = hot_block.T
        out_c[blk, slot] = local
    return out_v, out_c


def build_column_sharded_batch(shard: SparseShard, labels, num_blocks: int, *, offsets=None,
                               weights=None, hybrid=None, only_block: int | None = None,
                               device=None) -> ColumnShardedSparseBatch:
    """Group a SparseShard's entries into ``num_blocks`` contiguous column
    blocks of ``ceil(d / num_blocks)`` columns (the host-side analogue of
    the reference's feature-space partitioner; contiguous, so each block's
    run bounds stay a dense ``[block+1]`` slice).

    hybrid: None inherits the shard's ``hybrid_policy``; False forces it
    off; a HybridPolicy or True builds the dense hot head, selected
    GLOBALLY by the single-device builder's nnz ranking, then split per
    block with the cold tail. ``only_block`` keeps block ``k`` alone (a
    rank's, without building the others)."""
    rows, cols, vals = (np.asarray(a) for a in shard.coalesced())
    n, dim = shard.shape
    k = int(num_blocks)
    if k < 1:
        raise ValueError(f"num_blocks must be at least 1, got {num_blocks}")
    block = -(-dim // k)
    device = resolve_device(device)
    dtype = shard.dtype

    policy = shard.hybrid_policy if hybrid is None else resolve_hybrid_policy(hybrid)
    hot = {}
    if policy is not None:
        # pad=False: lane padding would land every duplicate pad id in the
        # last hot column's block; blocks re-pad to their own widest count
        hot_block, hot_ids, rows, cols, vals = _hybrid_arrays(rows, cols, vals, n, dim, policy,
                                                              pad=False)
        hv3, hc2 = _block_hot_head(hot_block, hot_ids, k, block)
        # every block pads to the widest block's hot count: hot ids clustered
        # into few blocks blow the [K, n, h] head up toward K times the
        # global head
        record_block_head(policy.label, width=hv3.shape[2], num_blocks=k,
                          k_hot_padded=hot_ids.shape[0])
        if hot_ids.shape[0] and hv3.shape[2] * k > 2 * hot_ids.shape[0]:
            logger.warning(
                "hybrid hot head is clustered across column blocks: per-block width %d x %d "
                "blocks vs %d global hot columns (%.1fx replicated zeros); a hashed/shuffled "
                "feature id assignment spreads the head", hv3.shape[2], k, hot_ids.shape[0],
                hv3.shape[2] * k / hot_ids.shape[0])
        if only_block is not None:
            hv3, hc2 = hv3[only_block:only_block + 1], hc2[only_block:only_block + 1]
        hot = dict(hot_vals=device_tensor(hv3, dtype, device),
                   hot_local_cols=device_tensor(hc2, torch.int32, device))

    blk = (cols // block).astype(np.int64) if block else np.zeros(len(cols), np.int64)
    local = cols.astype(np.int64) - blk * block
    counts = np.bincount(blk, minlength=k)
    held = range(k) if only_block is None else [int(only_block)]
    m = max(int(counts.max(initial=0)) if only_block is None else int(counts[only_block]), 1)
    if only_block is not None:
        keep = blk == only_block
        rows, local, vals, blk = rows[keep], local[keep], vals[keep], blk[keep] * 0
        counts = counts[only_block:only_block + 1]
    kb = len(held)

    def grouped(order):
        """[B, m] (vals, rows, local cols) laid out by block in ``order``;
        pads carry value 0, the last row id and local column 0."""
        b, r, c, v = blk[order], rows[order], local[order], vals[order]
        starts = np.zeros(kb + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(b)) - starts[b]
        out_v = np.zeros((kb, m), dtype=vals.dtype)
        # the LAST row id keeps each block's row ids sorted for the margins
        out_r = np.full((kb, m), max(n - 1, 0), dtype=np.int32)
        out_c = np.zeros((kb, m), dtype=np.int32)
        out_v[b, pos] = v
        out_r[b, pos] = r
        out_c[b, pos] = c
        return out_v, out_r, out_c

    # the coalesced entries are sorted by (row, col): a stable sort by block
    # keeps them row-sorted within each block, a stable sort by column sorts
    # each block by (local column, row)
    v_row, r_row, c_row = grouped(np.argsort(blk, kind="stable"))
    v_col, r_col, _ = grouped(np.argsort(blk * block + local, kind="stable"))
    # run bounds from the TRUE entries only (pad slots carry local column 0)
    col_counts = np.bincount(blk * block + local, minlength=kb * block).reshape(kb, block)
    bounds = np.zeros((kb, block + 1), dtype=np.int64)
    np.cumsum(col_counts, axis=1, out=bounds[:, 1:])
    host = vals.dtype
    labels = np.asarray(labels, dtype=host)
    offsets = np.zeros(n, host) if offsets is None else np.asarray(offsets, host)
    weights = np.ones(n, host) if weights is None else np.asarray(weights, host)
    solve = torch.float64 if dtype == torch.float64 else torch.float32
    return ColumnShardedSparseBatch(
        values=device_tensor(v_row, dtype, device),
        local_cols=device_tensor(c_row, torch.int32, device),
        row_ids=device_tensor(r_row, torch.int32, device),
        vals_by_col=device_tensor(v_col, dtype, device),
        rows_by_col=device_tensor(r_col, torch.int32, device),
        local_bounds=device_tensor(bounds, torch.int32, device),
        labels=device_tensor(labels, solve, device),
        offsets=device_tensor(offsets, solve, device),
        weights=device_tensor(weights, solve, device),
        dim=int(dim), block=int(block), num_blocks=k,
        block_index=None if only_block is None else int(only_block), **hot)


def shard_column_batch(batch: ColumnShardedSparseBatch, mesh, put_fn=None
                       ) -> ColumnShardedSparseBatch:
    """This rank's block of ``batch`` (block ``model_rank``), with the
    per-sample vectors whole, on the rank's device (``put_fn(tensor)``
    places each tensor; the rank's device by default). A batch built with
    ``only_block`` must hold the rank's block."""
    from photon_ml_torch.parallel.multihost import process_info

    _check_blocks(batch, mesh)
    k = mesh_ops.model_rank(mesh)
    if put_fn is None:
        device = process_info().device
        put_fn = lambda t: t.to(device).contiguous()  # noqa: E731
    pick = (lambda t: t) if batch.block_index is not None else (lambda t: t[k:k + 1])
    hot = {}
    if batch.has_hot_head:
        hot = dict(hot_vals=put_fn(pick(batch.hot_vals)),
                   hot_local_cols=put_fn(pick(batch.hot_local_cols)))
    return batch.replace(
        values=put_fn(pick(batch.values)), local_cols=put_fn(pick(batch.local_cols)),
        row_ids=put_fn(pick(batch.row_ids)), vals_by_col=put_fn(pick(batch.vals_by_col)),
        rows_by_col=put_fn(pick(batch.rows_by_col)),
        local_bounds=put_fn(pick(batch.local_bounds)), labels=put_fn(batch.labels),
        offsets=put_fn(batch.offsets), weights=put_fn(batch.weights), block_index=k, **hot)


def _check_blocks(batch: ColumnShardedSparseBatch, mesh) -> None:
    """A rank evaluates exactly ONE block, its model rank's: any other
    blocks-per-rank ratio would silently drop entries."""
    model = mesh_ops.model_size(mesh)
    if batch.num_blocks != model:
        raise ValueError(f"batch has {batch.num_blocks} column blocks but the mesh 'model' "
                         f"axis is {model}; build the batch with num_blocks={model}")
    if batch.block_index is not None and batch.block_index != mesh_ops.model_rank(mesh):
        raise ValueError(f"this rank holds column block {batch.block_index}, not its model "
                         f"rank's {mesh_ops.model_rank(mesh)}")


class _ModelAxisObjective:
    """The evaluation shared by the model-axis objectives: partial margins
    over the rank's columns, one all-reduce over "model" (with the shift
    term and ‖w‖² riding it), the loss on the rank's rows, the own-column
    transpose, one all-reduce over "data" when the data axis is wider than
    1, then the chain rule and L2. Subclasses give ``_product`` and
    ``_transpose``. ``normalization`` covers the rank's own ``block``
    columns (:func:`block_normalization`)."""

    def __init__(self, loss: PointwiseLoss, mesh, l2_weight: float = 0.0,
                 normalization: NormalizationContext | None = None,
                 use_kernel: bool | None = None):
        mesh_ops.check_data_mesh(mesh)
        self.loss = loss
        self.mesh = mesh
        self.l2_weight = float(l2_weight)
        self.normalization = normalization if normalization is not None else no_normalization()
        self.use_kernel = use_kernel
        self.vector_ops = vector_ops_for(mesh)

    def _product(self, eff: torch.Tensor, batch) -> torch.Tensor:
        raise NotImplementedError

    def _transpose(self, r: torch.Tensor, batch) -> torch.Tensor:
        raise NotImplementedError

    def _check(self, batch) -> None:
        """Subclasses refuse a batch that is not this rank's block."""

    def _model_sum(self, partials: list, extras: list) -> tuple[list, list]:
        """Each ``[n]`` partial product and each 0-dim extra summed over the
        model axis in ONE all-reduce (a single rank's pass unchanged)."""
        dtype = partials[0].dtype
        packed = torch.cat([p.to(dtype) for p in partials]
                           + [e.to(dtype).reshape(1) for e in extras])
        if mesh_ops.model_size(self.mesh) > 1:
            packed = mesh_ops.all_reduce_sum(packed, self.mesh, axis="model")
        n = partials[0].shape[0]
        return ([packed[i * n:(i + 1) * n] for i in range(len(partials))],
                list(packed[len(partials) * n:]))

    def _data_sum(self, t: torch.Tensor) -> torch.Tensor:
        if mesh_ops.data_size(self.mesh) > 1:
            return mesh_ops.all_reduce_sum(t, self.mesh)
        return t

    def _products(self, w: torch.Tensor, batch, vectors=()):
        """([X'(x) for x in (w, *vectors)], ‖w‖² over every column or None):
        X'(x) = X(f⊙x) − (f⊙x)·shifts over every column, without offsets,
        all in one all-reduce over the model axis."""
        norm = self.normalization
        effs = [norm.effective_coefficients(x) for x in (w, *vectors)]
        partials = [self._product(e, batch) for e in effs]
        extras = [torch.dot(e, norm.shifts) for e in effs] if norm.shifts is not None else []
        if self.l2_weight > 0.0:
            extras.append(torch.dot(w, w))
        sums, extras = self._model_sum(partials, extras)
        if norm.shifts is not None:
            sums = [s - e for s, e in zip(sums, extras[:len(effs)])]
            extras = extras[len(effs):]
        return sums, (extras[0] if self.l2_weight > 0.0 else None)

    def product(self, w: torch.Tensor, batch) -> torch.Tensor:
        """The rank's rows' pure margins X'(w) over every column (a
        collective over the model axis): the coordinate's score."""
        self._check(batch)
        norm = self.normalization
        eff = norm.effective_coefficients(w)
        extras = [torch.dot(eff, norm.shifts)] if norm.shifts is not None else []
        (total,), extras = self._model_sum([self._product(eff, batch)], extras)
        return total - extras[0] if extras else total

    def _margins(self, w: torch.Tensor, batch, vectors=()):
        """(margins of ``w`` with offsets, [X'(v) for v in ``vectors``],
        ‖w‖² over every column)."""
        sums, wsq = self._products(w, batch, vectors)
        return sums[0] + batch.offsets, sums[1:], wsq

    def value(self, w: torch.Tensor, batch) -> torch.Tensor:
        self._check(batch)
        margins, _, wsq = self._margins(w, batch)
        total = torch.sum(batch.weights * self.loss.loss(margins, batch.labels))
        total = self._data_sum(total.reshape(1))[0]
        if wsq is not None:
            total = total + 0.5 * self.l2_weight * wsq
        return total

    def value_and_gradient(self, w: torch.Tensor, batch):
        self._check(batch)
        margins, _, wsq = self._margins(w, batch)
        losses, dz = self.loss.loss_and_dz(margins, batch.labels)
        dzw = batch.weights * dz
        g = self._transpose(dzw, batch)
        packed = self._data_sum(torch.cat([torch.sum(batch.weights * losses).reshape(1),
                                           torch.sum(dzw).reshape(1), g.to(dzw.dtype)]))
        total, grad = packed[0], chain_rule(self.normalization, packed[2:], packed[1])
        total, grad = total.to(w.dtype), grad.to(w.dtype)
        if wsq is not None:
            total = total + 0.5 * self.l2_weight * wsq
            grad = grad + self.l2_weight * w
        return total, grad

    def gradient(self, w: torch.Tensor, batch) -> torch.Tensor:
        return self.value_and_gradient(w, batch)[1]

    def hessian_vector(self, w: torch.Tensor, v: torch.Tensor, batch) -> torch.Tensor:
        """H v = f ⊙ (Xᵀt − (Σt)·shifts) + λv with t = d²l·X'(v): the
        margins and X'(v) share one model all-reduce, the transpose is the
        rank's own columns (TRON's CG step at giant d)."""
        self._check(batch)
        margins, (jv,), _ = self._margins(w, batch, (v,))
        t = self.loss.d2z(margins, batch.labels) * batch.weights * jv
        packed = self._data_sum(torch.cat([torch.sum(t).reshape(1),
                                           self._transpose(t, batch).to(t.dtype)]))
        hv = chain_rule(self.normalization, packed[1:], packed[0]).to(v.dtype)
        if self.l2_weight > 0.0:
            hv = hv + self.l2_weight * v
        return hv

    def bind(self, batch) -> BoundObjective:
        return BoundObjective(self, batch)


class ColumnShardedGLMObjective(_ModelAxisObjective):
    """GLM objective over a rank's column block of a sparse batch
    (:func:`shard_column_batch`): coefficients and gradients are the rank's
    ``[block]`` slice; ``bind(batch)`` feeds ``optim.optimizer.solve`` like
    any other objective, and the solvers' reductions run over the model
    axis (``vector_ops``).

    ``use_kernel`` as in ``ops/sparse_objective.py``: None and True run G1
    (rows or chunks for the margins, the segment kernel for the transpose)
    on a CUDA batch, which launches or raises, and its plain version on a
    CPU one; False the plain version everywhere."""

    def _check(self, batch: ColumnShardedSparseBatch) -> None:
        _check_blocks(batch, self.mesh)
        if batch.block_index is None:
            raise ValueError("the batch holds every column block; give each rank its own "
                             "(shard_column_batch)")

    def _product(self, eff: torch.Tensor, batch: ColumnShardedSparseBatch) -> torch.Tensor:
        return _column_block_product(eff, batch, self.use_kernel)

    def _transpose(self, r: torch.Tensor, batch: ColumnShardedSparseBatch) -> torch.Tensor:
        _, _, col_chunks, nnz = batch.plans()
        tail = (batch.vals_by_col[0, :nnz], batch.rows_by_col[0, :nnz], None,
                batch.local_bounds[0])
        gather = gather_sum_reference if self.use_kernel is False else gather_sum
        g = gather(r.contiguous(), batch.block, tail=tail, chunks=col_chunks)
        if batch.has_hot_head:
            # the hot columns are distinct (pads add an all-zero column)
            g = g.to(r.dtype).index_add(0, batch.hot_local_cols[0].long(),
                                        r @ batch.hot_vals[0].to(r.dtype))
        return g


def block_scores(w: torch.Tensor, block, mesh) -> torch.Tensor:
    """The rank's rows' scores ``X·w`` over every column: the partial
    product of its column block (a dense ``[n, block]`` tensor or a
    :class:`ColumnShardedSparseBatch`) and its ``[block]`` slice of ``w``,
    all-reduced over the model axis (a scorer's, no normalization)."""
    if isinstance(block, ColumnShardedSparseBatch):
        partial = _column_block_product(w, block, None)
    else:
        partial = block.to(w.dtype) @ w
    if mesh_ops.model_size(mesh) > 1:
        partial = mesh_ops.all_reduce_sum(partial, mesh, axis="model")
    return partial


def _column_block_product(w: torch.Tensor, batch: ColumnShardedSparseBatch,
                          use_kernel: bool | None) -> torch.Tensor:
    """Σ vals·w[local col] per row of the held block (G1, or its plain
    version on a CPU tensor or with ``use_kernel=False``), plus the dense
    hot head's product."""
    row_ptr, row_chunks, _, _ = batch.plans()
    gather = gather_sum_reference if use_kernel is False else gather_sum
    tail = (batch.values[0], batch.local_cols[0], batch.row_ids[0], row_ptr)
    out = gather(w.contiguous(), batch.num_samples, tail=tail, chunks=row_chunks)
    if batch.has_hot_head:
        # the block's dense head: one [n, h] product with its own slice
        w_hot = w[batch.hot_local_cols[0].long()]
        out = out.to(w_hot.dtype) + batch.hot_vals[0].to(w_hot.dtype) @ w_hot
    return out


class FeatureShardedDenseGLMObjective(_ModelAxisObjective):
    """GLM objective over a rank's ``[n/D, d/M]`` dense feature block
    (``mesh.shard_batch(feature_sharded=True)``): partial margins and the
    gradient block are ``torch.matmul`` products."""

    def _product(self, eff: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        return _matvec(batch.features, eff)

    def _transpose(self, r: torch.Tensor, batch: LabeledPointBatch) -> torch.Tensor:
        return _rmatvec(batch.features, r)


def init_column_sharded_coefficients(batch: ColumnShardedSparseBatch, mesh,
                                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """The rank's zero ``[block]`` coefficients: the solver's w0, so every
    solver work vector starts as the rank's block too."""
    _check_blocks(batch, mesh)
    dtype = dtype or (torch.float64 if batch.dtype == torch.float64 else torch.float32)
    return torch.zeros((batch.block,), dtype=dtype, device=batch.device)
