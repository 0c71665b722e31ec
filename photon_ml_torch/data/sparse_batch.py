"""Sparse batched training data for giant feature spaces.

Counterpart of ``photon_ml_tpu/data/sparse_batch.py``; reference photon-client
data/avro/AvroDataReader.scala:165-200 (sparse name-term feature bags). Only
O(nnz) per-entry arrays and O(d) vectors live on the device: no [n, d].

The entries are one row-sorted flat COO triple (values, col_indices,
row_ids) with optional faster views of the same entries, as in the JAX
package: column-sorted (a scatter-free gradient through sorted-run prefix
sums), ELL (padded [n, L] rows, the default), and the hybrid dense-head /
sparse-tail split (:class:`HybridPolicy`). Padding entries carry value 0.

The host builders are numpy, element for element those of the JAX package;
only the finished arrays move to torch. Every margin goes through the
gather-sum of ``ops/sparse_gather.py``: its CUDA kernel on the card, its
plain version on the CPU. For that the batch also carries the flat tail's
``[n+1]`` row pointers (and, where a row is longer than one chunk, the
chunk plan of those rows alone), built once from the sorted ``row_ids``. Every transpose
``Xᵀr`` of the ELL block and the flat tail is the same gather-sum over a
column-sorted copy of their nonzero entries, built on the device at the
first transpose and kept with the batch, so each column sums in a fixed
order (``index_add_`` on the card adds with float atomics, and its sums,
with any solver path that reads them, would change from run to run).

A bf16 batch keeps its entry values (ELL, tail, hybrid head) in bf16;
labels, offsets, weights and the solver's coefficients stay float32. The
JAX package rounds values to bf16 before it sums duplicates and keeps bf16
labels; the port sums duplicates in f32 and rounds once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.data.batch import device_tensor, solve_dtype_of
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.sparse_gather import gather_sum, gather_sum_reference, segment_plan

#: indices ride int32 on the device; one coefficient axis can carry up to
#: 2^31-1 entries
MAX_INDEX = np.iinfo(np.int32).max

#: the flat tail's per-entry arrays, from which the row pointers are built
_ENTRY_FIELDS = frozenset({"values", "col_indices", "row_ids"})

#: ELL auto-width: the padded [n, L] may hold at most this multiple of the
#: true nnz (skewed rows spill to the COO tail instead of inflating L)
_ELL_WASTE_CAP = 1.6

_HOST_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
               torch.bfloat16: np.float32}


@dataclasses.dataclass(frozen=True)
class HybridPolicy:
    """Builder policy for the hybrid dense-head / sparse-tail view.

    The top ``hot_cols`` columns by nnz (or the smallest head covering
    ``coverage`` of the nonzeros, 0.5 when neither is set) move into a
    dense [n, k_hot] block padded to ``pad_multiple`` columns; the ELL/flat
    tail keeps the cold residual. ``hot_ids`` fixes the head to these
    sorted unique global ids instead of ranking locally. ``label`` names
    the layout (the JAX package files its gauges under it).
    """

    hot_cols: int | None = None
    coverage: float | None = None
    pad_multiple: int = 128
    max_hot_cols: int = 1 << 14
    label: str = "sparse"
    hot_ids: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.hot_cols is not None and self.hot_cols <= 0:
            raise ValueError(f"hot_cols must be positive, got {self.hot_cols}")
        if self.coverage is not None and not (0.0 < self.coverage <= 1.0):
            raise ValueError(f"coverage must be in (0, 1], got {self.coverage}")
        if self.hot_cols is not None and self.coverage is not None:
            raise ValueError(
                "hot_cols and coverage are mutually exclusive head-sizing rules; set one"
            )
        if self.pad_multiple <= 0:
            raise ValueError("pad_multiple must be positive")
        if self.hot_ids is not None:
            ids = np.asarray(self.hot_ids, dtype=np.int64)
            if len(ids) == 0:
                raise ValueError("hot_ids must name at least one column")
            if (np.diff(ids) <= 0).any() or ids[0] < 0:
                raise ValueError("hot_ids must be sorted, unique, non-negative column ids")

    @property
    def effective_coverage(self) -> float:
        """Coverage target when neither knob is set explicitly."""
        return 0.5 if self.coverage is None else self.coverage


def resolve_hybrid_policy(hybrid) -> HybridPolicy | None:
    """None/False off, True the default policy, a HybridPolicy as given."""
    if hybrid is None or hybrid is False:
        return None
    if hybrid is True:
        return HybridPolicy()
    if isinstance(hybrid, HybridPolicy):
        return hybrid
    raise TypeError(f"hybrid must be a HybridPolicy or bool, got {hybrid!r}")


def _check_index_ranges(rows, cols, n, dim) -> None:
    if dim > MAX_INDEX or n > MAX_INDEX:
        raise ValueError(
            f"dim={dim}/n={n} exceeds the int32 device-index range "
            f"({MAX_INDEX}); shard the axis before building the batch"
        )
    if rows.size:
        if rows.min(initial=0) < 0 or cols.min(initial=0) < 0:
            raise ValueError("negative row/col index")
        if rows.max(initial=0) >= n:
            raise ValueError("row index out of range")
        if cols.max(initial=0) >= dim:
            raise ValueError(f"column index >= dim={dim}")


def coalesce_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray):
    """Sum duplicate (row, col) entries; the output is row-major sorted.
    Needed before any non-linear use of the values (x² of a Hessian
    diagonal is (Σv)², not Σv²)."""
    if len(vals) == 0:
        return rows, cols, vals
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    first = np.empty(len(r), dtype=bool)
    first[0] = True
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    idx = np.flatnonzero(first)
    return r[idx], c[idx], np.add.reduceat(v, idx)


def _host_dtype(dtype) -> np.dtype:
    if dtype not in _HOST_DTYPE:
        raise ValueError(f"sparse values must be float32, float64 or bfloat16, not {dtype}")
    return np.dtype(_HOST_DTYPE[dtype])


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


@dataclasses.dataclass
class SparseShard:
    """Host-side sparse feature shard: COO triples and shape. The coalesced
    triple, the hybrid split and the device arrays are built once and
    cached, so the COO arrays are frozen."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    num_samples: int
    feature_dim: int
    hybrid_policy: HybridPolicy | None = None
    #: agreed ELL width: ``from_shard``'s ell="auto" uses it when set
    ell_width: int | None = None
    #: agreed flat-tail length: ``from_shard`` pads the ELL overflow to it
    flat_block_nnz: int | None = None
    _device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    _coalesced: tuple | None = dataclasses.field(default=None, repr=False, compare=False)
    _hybrid_cache: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        _check_index_ranges(np.asarray(self.rows), np.asarray(self.cols),
                            self.num_samples, self.feature_dim)
        for name in ("rows", "cols", "vals"):
            arr = getattr(self, name)
            if isinstance(arr, np.ndarray):
                arr.flags.writeable = False

    def coalesced(self) -> tuple:
        """(rows, cols, vals) with duplicates summed, computed once."""
        if self._coalesced is None:
            self._coalesced = coalesce_coo(np.asarray(self.rows), np.asarray(self.cols),
                                           np.asarray(self.vals))
        return self._coalesced

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_samples, self.feature_dim)

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(np.asarray(self.vals).dtype)

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def device(self, device=None) -> "SparseShardDevice":
        """The flat COO on ``device`` (CUDA unless ``device="cpu"``),
        built once per device."""
        device = resolve_device(device)
        if device not in self._device:
            rows, cols, vals = self.coalesced()
            values = device_tensor(vals, self.dtype, device)
            row_ids = device_tensor(rows, torch.int32, device)
            row_ptr, chunks = segment_plan(row_ids, int(self.num_samples))
            self._device[device] = SparseShardDevice(
                values=values, col_indices=device_tensor(cols, torch.int32, device),
                row_ids=row_ids,
                row_ptr=row_ptr, row_chunks=chunks, num_samples=int(self.num_samples),
                dim=int(self.feature_dim))
        return self._device[device]

    def hybrid_split(self, policy: HybridPolicy) -> tuple:
        """The hybrid head/tail arrays for ``policy``, cached per policy."""
        if self._hybrid_cache is None or self._hybrid_cache[0] != policy:
            rows, cols, vals = self.coalesced()
            layout: dict = {}
            arrays = _hybrid_arrays(np.asarray(rows), np.asarray(cols), np.asarray(vals),
                                    self.num_samples, self.feature_dim, policy, layout=layout)
            self._hybrid_cache = (policy, arrays, layout)
        return self._hybrid_cache[1]

    def summarize(self, weights: np.ndarray | None = None) -> dict:
        rows, cols, vals = self.coalesced()
        return summarize_sparse(rows, cols, vals, n=self.num_samples, dim=self.feature_dim,
                                weights=weights, assume_coalesced=True)


@dataclasses.dataclass(frozen=True)
class SparseShardDevice:
    """Device-resident flat COO of one feature shard (row-sorted)."""

    values: torch.Tensor
    col_indices: torch.Tensor
    row_ids: torch.Tensor
    row_ptr: torch.Tensor
    row_chunks: tuple | None
    num_samples: int
    dim: int

    def matvec(self, coefficients: torch.Tensor) -> torch.Tensor:
        """X @ w through the gather-sum."""
        tail = (self.values, self.col_indices, self.row_ids, self.row_ptr)
        return gather_sum(coefficients, self.num_samples, tail=tail, chunks=self.row_chunks)

    def arrays(self) -> dict:
        """The flat entries and their gather plan as ``models/game.score_layout``'s
        "sparse" layout reads them."""
        return {"vals": self.values, "cols": self.col_indices, "rows": self.row_ids,
                "row_ptr": self.row_ptr, "chunks": self.row_chunks}


@dataclasses.dataclass(frozen=True)
class SparseLabeledPointBatch:
    """A flat-COO block of labeled samples for a d too large to densify.

    values [nnz] (sorted by row), col_indices [nnz] int32, row_ids [nnz]
    int32, labels / offsets / weights [n], dim: the feature-space size.
    Padded entries carry value 0 and the last row id; padded samples carry
    weight 0.

    Optional views (see the JAX package): ``vals_by_col``/``rows_by_col``/
    ``cols_sorted``/``col_bounds`` (column-sorted), ``ell_vals``/``ell_cols``
    ([n, L]; the flat arrays then hold only the overflow tail),
    ``hot_vals``/``hot_col_ids`` (hybrid head; ELL/flat hold the cold tail).

    ``row_ptr`` ([n+1] int32) and ``row_chunks`` are the flat tail's row
    pointers and chunk plan for the gather kernel; left None, they are built
    from ``row_ids`` (``ops/sparse_gather.segment_plan``). ``layout`` holds
    the hybrid builder's head size and coverage.
    """

    values: torch.Tensor
    col_indices: torch.Tensor
    row_ids: torch.Tensor
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    dim: int
    vals_by_col: torch.Tensor | None = None
    rows_by_col: torch.Tensor | None = None
    cols_sorted: torch.Tensor | None = None
    col_bounds: torch.Tensor | None = None
    ell_vals: torch.Tensor | None = None
    ell_cols: torch.Tensor | None = None
    hot_vals: torch.Tensor | None = None
    hot_col_ids: torch.Tensor | None = None
    row_ptr: torch.Tensor | None = None
    row_chunks: tuple | None = None
    layout: dict | None = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.row_ptr is None:
            row_ptr, chunks = segment_plan(self.row_ids, self.num_samples)
            object.__setattr__(self, "row_ptr", row_ptr)
            object.__setattr__(self, "row_chunks", chunks)

    @property
    def has_column_sorted_view(self) -> bool:
        return self.cols_sorted is not None

    @property
    def has_ell_view(self) -> bool:
        return self.ell_vals is not None

    @property
    def has_hybrid_view(self) -> bool:
        return self.hot_vals is not None

    @property
    def num_samples(self) -> int:
        return self.labels.shape[0]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.labels.device

    @property
    def solve_dtype(self) -> torch.dtype:
        """Coefficient/optimizer-state dtype: bf16 values solve in f32."""
        return solve_dtype_of(self.values.dtype)

    def replace(self, **changes) -> "SparseLabeledPointBatch":
        """``dataclasses.replace``; a change to the flat tail's entries or to
        the number of samples rebuilds the row pointers and chunk plan unless
        ``row_ptr`` is given too."""
        resized = "labels" in changes and changes["labels"].shape[0] != self.num_samples
        if "row_ptr" not in changes and (resized or changes.keys() & _ENTRY_FIELDS):
            changes.update(row_ptr=None, row_chunks=None)
        out = dataclasses.replace(self, **changes)
        plan = self.__dict__.get("_transpose_plan")
        if plan is not None and changes.keys() <= {"labels", "offsets", "weights"} \
                and not resized:  # the same entries: keep their column-sorted plan
            object.__setattr__(out, "_transpose_plan", plan)
        return out

    def with_offsets(self, offsets: torch.Tensor) -> "SparseLabeledPointBatch":
        return self.replace(offsets=offsets)

    def add_scores_to_offsets(self, scores: torch.Tensor) -> "SparseLabeledPointBatch":
        """Residual update used by coordinate descent (DataSet.addScoresToOffsets)."""
        return self.replace(offsets=self.offsets + scores)

    def pad_nnz(self, target: int) -> "SparseLabeledPointBatch":
        """Pad the entry axis to ``target`` with inert entries: value 0 and
        the last row/col id of each sorted view (the column-sorted view pads
        in lockstep). The row pointers are rebuilt."""
        pad = target - self.nnz
        if pad < 0:
            raise ValueError(f"cannot pad {self.nnz} entries down to {target}")
        if pad == 0:
            return self

        def tail(a):
            return a[-1:] if self.nnz else torch.zeros((1,), dtype=a.dtype, device=a.device)

        zpad = torch.nn.functional.pad
        out = dict(
            values=zpad(self.values, (0, pad)),
            col_indices=zpad(self.col_indices, (0, pad)),
            row_ids=torch.cat([self.row_ids, tail(self.row_ids).expand(pad)]),
            row_ptr=None, row_chunks=None,
        )
        if self.has_column_sorted_view:
            out.update(
                vals_by_col=zpad(self.vals_by_col, (0, pad)),
                rows_by_col=zpad(self.rows_by_col, (0, pad)),
                cols_sorted=torch.cat([self.cols_sorted, tail(self.cols_sorted).expand(pad)]),
            )
        return self.replace(**out)

    @classmethod
    def _assemble(cls, rows, cols, vals, labels, offsets, weights, *, dim, dtype, device,
                  extra=None, layout=None) -> "SparseLabeledPointBatch":
        solve = solve_dtype_of(dtype)
        n = len(labels)
        arrays = {}
        for name, a in (extra or {}).items():
            is_index = name in ("ell_cols", "rows_by_col", "cols_sorted", "col_bounds",
                                "hot_col_ids")
            arrays[name] = device_tensor(a, torch.int32 if is_index else dtype, device)
        return cls(
            values=device_tensor(vals, dtype, device),
            col_indices=device_tensor(cols, torch.int32, device),
            row_ids=device_tensor(rows, torch.int32, device),
            labels=device_tensor(labels, solve, device),
            offsets=device_tensor(np.zeros(n) if offsets is None else offsets, solve, device),
            weights=device_tensor(np.ones(n) if weights is None else weights, solve, device),
            dim=int(dim), layout=layout, **arrays,
        )

    @classmethod
    def from_shard(cls, shard: SparseShard, labels, offsets, weights, *,
                   column_sorted_gradient: bool = False, ell: bool | int | str = "auto",
                   hybrid: HybridPolicy | bool | None = None,
                   device=None) -> "SparseLabeledPointBatch":
        """Bind a shard's entries to per-sample labels/offsets/weights.

        ell: "auto" (default) builds the ELL view with auto width (or the
        shard's ``ell_width``), an int fixes the width, False keeps flat
        COO; ``column_sorted_gradient`` builds the column-sorted view and
        no ELL. hybrid: None inherits ``shard.hybrid_policy``, False forces
        it off, a HybridPolicy/True enables it.
        """
        device = resolve_device(device)
        policy = shard.hybrid_policy if hybrid is None else resolve_hybrid_policy(hybrid)
        dtype = shard.dtype
        common = dict(dim=shard.feature_dim, dtype=dtype, device=device)
        width = shard.ell_width if ell == "auto" or ell is True else int(ell)
        if policy is not None:
            if column_sorted_gradient:
                raise ValueError(
                    "hybrid and column_sorted_gradient are mutually exclusive "
                    "layouts (the hybrid tail rides the ELL view)"
                )
            hot_vals, hot_ids, rows, cols, vals = shard.hybrid_split(policy)
            extra = dict(hot_vals=hot_vals, hot_col_ids=hot_ids)
            if ell:
                ev, ec, rows, cols, vals = _ell_arrays(rows, cols, vals, shard.num_samples,
                                                       width)
                rows, cols, vals = _pad_flat_tail(rows, cols, vals, shard.flat_block_nnz)
                extra.update(ell_vals=ev, ell_cols=ec)
            return cls._assemble(rows, cols, vals, labels, offsets, weights, extra=extra,
                                 layout=dict(shard._hybrid_cache[2]), **common)
        if ell and not column_sorted_gradient:
            rows, cols, vals = shard.coalesced()
            ev, ec, tr, tc, tv = _ell_arrays(np.asarray(rows), np.asarray(cols),
                                             np.asarray(vals), shard.num_samples, width)
            tr, tc, tv = _pad_flat_tail(tr, tc, tv, shard.flat_block_nnz)
            return cls._assemble(tr, tc, tv, labels, offsets, weights,
                                 extra=dict(ell_vals=ev, ell_cols=ec), **common)
        dev = shard.device(device)
        extra = {}
        if column_sorted_gradient:
            rows, cols, vals = shard.coalesced()
            extra = _column_sorted_arrays(rows, cols, vals, len(dev.values), dim=dev.dim)
            extra = {k: device_tensor(v, torch.int32 if k != "vals_by_col" else dtype, device)
                     for k, v in extra.items()}
        solve = solve_dtype_of(dtype)
        return cls(values=dev.values, col_indices=dev.col_indices, row_ids=dev.row_ids,
                   labels=device_tensor(labels, solve, device),
                   offsets=device_tensor(offsets, solve, device),
                   weights=device_tensor(weights, solve, device), dim=dev.dim, row_ptr=dev.row_ptr,
                   row_chunks=dev.row_chunks, **extra)

    @classmethod
    def from_coo(cls, rows, cols, vals, labels, *, dim: int, offsets=None, weights=None,
                 dtype: torch.dtype = torch.float32, pad_nnz_to: int | None = None,
                 column_sorted_gradient: bool = False, ell: bool | int | str = "auto",
                 hybrid: HybridPolicy | bool | None = None,
                 device=None) -> "SparseLabeledPointBatch":
        """Build from host COO triples on ``device`` (CUDA unless
        ``device="cpu"``). Duplicates coalesce at build time.

        dtype: the entry values' torch dtype (float32, float64 or
        bfloat16); labels, offsets and weights take its solve dtype.
        pad_nnz_to: round the flat entry count up. ell: "auto" (default)
        builds the ELL view with auto width, an int fixes it, False keeps
        flat COO; ``column_sorted_gradient`` builds the column-sorted view
        and no ELL. hybrid: the dense-head view (HybridPolicy/True).
        """
        device = resolve_device(device)
        return cls.from_host(coo_host_arrays(
            rows, cols, vals, labels, dim=dim, offsets=offsets, weights=weights, dtype=dtype,
            pad_nnz_to=pad_nnz_to, column_sorted_gradient=column_sorted_gradient, ell=ell,
            hybrid=hybrid), device=device)

    @classmethod
    def from_host(cls, host: dict, *, device) -> "SparseLabeledPointBatch":
        """The batch of :func:`coo_host_arrays`' host arrays on ``device``."""
        return cls._assemble(host["rows"], host["cols"], host["vals"], host["labels"],
                             host["offsets"], host["weights"], dim=host["dim"],
                             dtype=host["dtype"], device=device, extra=host["extra"],
                             layout=host["layout"])


def coo_host_arrays(rows, cols, vals, labels, *, dim: int, offsets=None, weights=None,
                    dtype: torch.dtype = torch.float32, pad_nnz_to: int | None = None,
                    column_sorted_gradient: bool = False, ell: bool | int | str = "auto",
                    hybrid: HybridPolicy | bool | None = None) -> dict:
    """The host (numpy) arrays of ``SparseLabeledPointBatch.from_coo``: the
    coalesced flat tail, the ELL/hybrid/column-sorted views and the
    per-sample columns, before any copy to a device (a streamed chunk's
    decode thread builds these and touches no device)."""
    policy = resolve_hybrid_policy(hybrid)
    if policy is not None and column_sorted_gradient:
        raise ValueError(
            "hybrid and column_sorted_gradient are mutually exclusive "
            "layouts (the hybrid tail rides the ELL view)"
        )
    host = _host_dtype(dtype)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=host)
    labels = np.asarray(labels, dtype=host)
    n = labels.shape[0]
    _check_index_ranges(rows, cols, n, dim)
    rows, cols, vals = coalesce_coo(rows, cols, vals)
    extra, layout = {}, None
    if policy is not None:
        layout = {}
        hot_vals, hot_ids, rows, cols, vals = _hybrid_arrays(rows, cols, vals, n, dim,
                                                             policy, layout=layout)
        extra.update(hot_vals=hot_vals, hot_col_ids=hot_ids)
    if ell and not column_sorted_gradient:
        ev, ec, rows, cols, vals = _ell_arrays(
            rows, cols, vals, n, None if ell == "auto" or ell is True else int(ell))
        extra.update(ell_vals=ev, ell_cols=ec)
    nnz = len(vals)
    target = max(pad_nnz_to or 0, nnz)
    if target > nnz:
        pad_row = int(rows[-1]) if nnz else 0
        rows = np.pad(rows, (0, target - nnz), constant_values=pad_row)
        cols = np.pad(cols, (0, target - nnz))
        vals = np.pad(vals, (0, target - nnz))
    if column_sorted_gradient:
        extra.update(_column_sorted_arrays(rows, cols, vals, len(vals), dim=dim))
    return dict(rows=rows, cols=cols, vals=vals, labels=labels, offsets=offsets,
                weights=weights, dim=int(dim), dtype=dtype, extra=extra, layout=layout)


def _ell_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int,
                width: int | None):
    """Split row-sorted COO triples into an ELL block and an overflow tail:
    (ell_vals [n, L], ell_cols [n, L] int32, tail_rows, tail_cols,
    tail_vals). Each row's first L entries land in the block (pad value 0,
    col 0); width=None picks the auto width."""
    counts = np.bincount(rows, minlength=n) if len(rows) else np.zeros(n, np.int64)
    if width is None:
        width = _ell_auto_width(counts, n, len(vals))
    width = max(1, int(width))
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(rows)) - starts[rows] if len(rows) else np.zeros(0, np.int64)
    in_ell = pos < width
    ell_vals = np.zeros((n, width), dtype=vals.dtype)
    ell_cols = np.zeros((n, width), dtype=np.int32)
    ell_vals[rows[in_ell], pos[in_ell]] = vals[in_ell]
    ell_cols[rows[in_ell], pos[in_ell]] = cols[in_ell]
    tail = ~in_ell
    return ell_vals, ell_cols, rows[tail], cols[tail], vals[tail]


def _ell_auto_width(counts: np.ndarray, n: int, nnz: int) -> int:
    """Smallest L covering the 98th-percentile row while keeping n·L under
    ``_ELL_WASTE_CAP``x nnz."""
    if nnz == 0:
        return 1
    q = int(np.quantile(counts, 0.98)) if n else 1
    width = max(1, q)
    while width > 1 and n * width > _ELL_WASTE_CAP * nnz:
        width -= 1
    return width


def _ell_auto_width_from_hist(freq: np.ndarray, n: int, nnz: int) -> int:
    """``_ell_auto_width`` from a row-count histogram (``freq[v]`` rows
    with exactly v entries), bit-exact with np.quantile's interpolation
    (numpy's ``_lerp``: a + (b-a)·t below t=0.5, b - (b-a)·(1-t) above)."""
    if nnz == 0:
        return 1
    if n:
        vi = 0.98 * (n - 1)
        prev = int(np.floor(vi))
        cum = np.cumsum(np.asarray(freq, dtype=np.int64))
        a = int(np.searchsorted(cum, prev + 1, side="left"))
        b = int(np.searchsorted(cum, int(np.ceil(vi)) + 1, side="left"))
        t = np.float64(vi) - np.float64(prev)
        d = np.float64(b - a)
        q = int(np.float64(b) - d * (np.float64(1.0) - t) if t >= 0.5
                else np.float64(a) + d * t)
    else:
        q = 1
    width = max(1, q)
    while width > 1 and n * width > _ELL_WASTE_CAP * nnz:
        width -= 1
    return width


def _pad_flat_tail(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, target: int | None):
    """Pad an ELL overflow triple to ``target`` entries: value 0, col 0, the
    last real row id."""
    if target is None:
        return rows, cols, vals
    pad = int(target) - len(vals)
    if pad < 0:
        raise ValueError(
            f"flat overflow tail has {len(vals)} entries but the agreed "
            f"flat_block_nnz is {target}"
        )
    if pad == 0:
        return rows, cols, vals
    last = rows[-1] if len(rows) else 0
    return (np.concatenate([rows, np.full(pad, last, rows.dtype)]),
            np.concatenate([cols, np.zeros(pad, cols.dtype)]),
            np.concatenate([vals, np.zeros(pad, vals.dtype)]))


def rank_hot_columns(uniq: np.ndarray, cnt: np.ndarray, nnz: int,
                     policy: HybridPolicy) -> np.ndarray:
    """Sorted hot-head ids from a per-column nnz histogram (``uniq`` sorted
    ids, ``cnt`` counts) under ``policy``; count ties break by ascending id."""
    if nnz == 0 or len(uniq) == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(-np.asarray(cnt), kind="stable")
    if policy.hot_cols is not None:
        k = int(policy.hot_cols)
    else:
        cum = np.cumsum(np.asarray(cnt)[order])
        k = int(np.searchsorted(cum, policy.effective_coverage * nnz)) + 1
    k = min(k, policy.max_hot_cols, len(uniq))
    return np.sort(np.asarray(uniq)[order[:k]].astype(np.int64))


def _select_hot_columns(cols: np.ndarray, nnz: int, policy: HybridPolicy):
    """(sorted global ids of the hot head before padding, covered nonzero
    count). Frequencies come from ``np.unique`` over the entries, never a
    dim-length bincount."""
    if policy.hot_ids is not None:
        hot = np.asarray(policy.hot_ids, dtype=np.int64)
        if nnz == 0:
            return hot, 0
        pos = np.searchsorted(hot, cols)
        return hot, int((hot[np.minimum(pos, len(hot) - 1)] == cols).sum())
    if nnz == 0:
        return np.zeros(0, dtype=np.int64), 0
    uniq, cnt = np.unique(cols, return_counts=True)
    hot = rank_hot_columns(uniq, cnt, nnz, policy)
    if len(hot):
        return hot, int(cnt[np.searchsorted(uniq, hot)].sum())
    return hot, 0


def _hybrid_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int, dim: int,
                   policy: HybridPolicy, *, pad: bool = True, layout: dict | None = None):
    """Split row-sorted coalesced COO into a dense hot head and a cold tail:
    (hot_block [n, k_pad], hot_ids [k_pad], tail_rows, tail_cols,
    tail_vals). Head slot j is the rank of the column within the sorted hot
    set; pad slots carry the last hot id over an all-zero column. The tail
    keeps row-major order. ``layout``, if given, receives the head's size
    and coverage (the values the JAX package records as gauges)."""
    nnz = len(vals)
    hot, covered = _select_hot_columns(cols, nnz, policy)
    k = len(hot)
    if k:
        pm = policy.pad_multiple if pad else 1
        k_pad = -(-k // pm) * pm
        posc = np.minimum(np.searchsorted(hot, cols), k - 1)
        is_hot = hot[posc] == cols
        hot_ids = np.concatenate([hot, np.full(k_pad - k, hot[-1], dtype=np.int64)])
    else:
        k_pad = 0
        posc = np.zeros(nnz, dtype=np.int64)
        is_hot = np.zeros(nnz, dtype=bool)
        hot_ids = np.zeros(0, dtype=np.int64)
    hot_block = np.zeros((n, k_pad), dtype=vals.dtype)
    if k:
        hot_block[rows[is_hot], posc[is_hot]] = vals[is_hot]
    tail = ~is_hot
    if layout is not None:
        layout.update(k_hot=k, k_hot_padded=k_pad, hot_nnz=covered,
                      hot_coverage=covered / nnz if nnz else 0.0, tail_nnz=int(tail.sum()))
    return hot_block, hot_ids, rows[tail], cols[tail], vals[tail]


def _column_sorted_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, pad_to: int,
                          dim: int | None = None) -> dict:
    """The column-sorted view (host numpy), padded with inert entries
    carrying the last column id; with ``dim``, also ``col_bounds`` ([dim+1]
    run boundaries)."""
    order = np.argsort(cols, kind="stable")
    vc, rc, cc = vals[order], rows[order], cols[order]
    out = {}
    if dim is not None:
        cb = np.zeros(dim + 1, dtype=np.int64)
        np.cumsum(np.bincount(cc, minlength=dim), out=cb[1:])
        out["col_bounds"] = cb.astype(np.int32)
    pad = pad_to - len(vc)
    if pad > 0:
        pad_col = int(cc[-1]) if len(cc) else 0
        vc = np.pad(vc, (0, pad))
        rc = np.pad(rc, (0, pad))
        cc = np.pad(cc, (0, pad), constant_values=pad_col)
    out.update(vals_by_col=vc, rows_by_col=rc.astype(np.int32), cols_sorted=cc.astype(np.int32))
    return out


def feature_product(batch: SparseLabeledPointBatch, coefficients: torch.Tensor, *,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """X @ w over every view of the batch, without offsets: the gather-sum
    of the ELL block and flat tail plus the hybrid head's product.
    ``use_kernel=False`` takes the gather's plain version on any device."""
    ell = (batch.ell_vals, batch.ell_cols) if batch.has_ell_view else None
    tail = None
    if batch.nnz:
        tail = (batch.values, batch.col_indices, batch.row_ids, batch.row_ptr)
    gather = gather_sum_reference if use_kernel is False else gather_sum
    out = gather(coefficients, batch.num_samples, ell=ell, tail=tail, chunks=batch.row_chunks)
    if batch.has_hybrid_view:
        w_hot = coefficients[batch.hot_col_ids.long()]
        out = out + batch.hot_vals.to(w_hot.dtype) @ w_hot
    return out


def sparse_margins(batch: SparseLabeledPointBatch, coefficients: torch.Tensor, *,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """margin_i = Σ_j x_ij w_j + offset_i without materializing X."""
    return feature_product(batch, coefficients, use_kernel=use_kernel) + batch.offsets


def transpose_plan(batch: SparseLabeledPointBatch):
    """The ELL block's and the flat tail's entries as one flat tail sorted
    by column, for the gather kernel with the columns as its segments:
    (vals, rows, col_ptr, chunks), 8 bytes an entry (f32) plus ``[d+1]``
    pointers and, where a column holds more than ``SEGMENT_CHUNK`` entries,
    the :class:`~photon_ml_torch.ops.sparse_gather.ChunkPlan` of those
    columns (8 bytes a long column); column j's entries are ``[col_ptr[j],
    col_ptr[j+1])`` (the sorted column ids are not kept:
    ``sparse_gather.segment_ids(col_ptr)`` rebuilds them). Stable, so a column's entries keep their order (ELL
    rows, then tail rows); entries of value 0, the ELL pad slots among them,
    add nothing and are left out. Built once per batch on its device (one
    sort, a few syncs) and cached on it."""
    plan = batch.__dict__.get("_transpose_plan")
    if plan is not None:
        return plan
    vals, cols, rows = [], [], []
    if batch.has_ell_view:
        n, width = batch.ell_vals.shape
        vals.append(batch.ell_vals.reshape(-1))
        cols.append(batch.ell_cols.reshape(-1))
        rows.append(torch.arange(n, dtype=torch.int32, device=batch.device)
                    .repeat_interleave(width))
    if batch.nnz:
        vals.append(batch.values)
        cols.append(batch.col_indices)
        rows.append(batch.row_ids)
    if vals:
        vals, cols, rows = torch.cat(vals), torch.cat(cols), torch.cat(rows)
        keep = vals != 0
        vals, cols, rows = vals[keep], cols[keep], rows[keep]
        cols, order = torch.sort(cols, stable=True)
        vals, rows = vals[order].contiguous(), rows[order].contiguous()
    else:
        vals = batch.values
        cols = rows = torch.zeros((0,), dtype=torch.int32, device=batch.device)
    col_ptr, chunks = segment_plan(cols, batch.dim)
    plan = (vals, rows, col_ptr, chunks)
    object.__setattr__(batch, "_transpose_plan", plan)
    return plan


def tail_column_sums(batch: SparseLabeledPointBatch, row_weights: torch.Tensor,
                     square_values: bool = False, *,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Σ_i row_weights_i · x_ij (or x_ij²) per column j over the ELL block
    and the flat tail: the gather-sum of ``ops/sparse_gather.py`` over their
    column-sorted plan (:func:`transpose_plan`), whose kernel sums each
    column in a fixed order, so the card's sums repeat bitwise
    (``index_add_`` there adds with float atomics). ``use_kernel=False``
    takes the plain ``index_add_`` on any device, as :func:`feature_product`
    takes the gather's plain version."""
    dtype = torch.promote_types(row_weights.dtype, batch.values.dtype)
    rw = row_weights.to(dtype)
    if use_kernel is not False:
        vals, rows, col_ptr, chunks = transpose_plan(batch)
        if square_values:
            vals = vals.to(dtype) * vals.to(dtype)
        return gather_sum(rw.contiguous(), batch.dim, tail=(vals, rows, None, col_ptr),
                          chunks=chunks)
    out = torch.zeros((batch.dim,), dtype=dtype, device=row_weights.device)

    def values(v):
        v = v.to(dtype)
        return v * v if square_values else v

    if batch.has_ell_view:
        out.index_add_(0, batch.ell_cols.reshape(-1),
                       (rw[:, None] * values(batch.ell_vals)).reshape(-1))
    if batch.nnz:
        out.index_add_(0, batch.col_indices, rw[batch.row_ids] * values(batch.values))
    return out


def sparse_column_sum(batch: SparseLabeledPointBatch, row_weights: torch.Tensor,
                      square_values: bool = False, *,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """Σ_i row_weights_i · x_ij (or x_ij²) per column j: the transpose
    behind every sparse gradient, Hessian-vector product and Hessian
    diagonal. :func:`tail_column_sums`, plus the hybrid head's k_hot
    columns, which are distinct, so their ``index_add_`` never adds two
    values into one slot."""
    out = tail_column_sums(batch, row_weights, square_values, use_kernel=use_kernel)
    if batch.has_hybrid_view:
        hot = batch.hot_vals.to(out.dtype)
        out.index_add_(0, batch.hot_col_ids,
                       row_weights.to(out.dtype) @ (hot * hot if square_values else hot))
    return out


def summarize_sparse(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, *, n: int, dim: int,
                     weights: np.ndarray | None = None, assume_coalesced: bool = False) -> dict:
    """Weighted per-column summary from COO triples (host float64), equal
    to ``data/batch.summarize`` on the dense equivalent, implicit zeros
    included. Sums over the entries run in entry order (``np.bincount``)."""
    rows = np.asarray(rows, dtype=np.intp)
    cols = np.asarray(cols, dtype=np.intp)
    vals = np.asarray(vals, dtype=np.float64)
    if not assume_coalesced:
        rows, cols, vals = coalesce_coo(rows, cols, vals)
    weights = np.ones((n,), dtype=np.float64) if weights is None \
        else np.asarray(weights, dtype=np.float64)
    wsum = weights.sum()

    def col_acc(contrib):
        return np.bincount(cols, weights=contrib, minlength=dim).astype(np.float64)

    s1 = col_acc(weights[rows] * vals)
    mean = s1 / wsum
    # Σ w (x - m)² = Σ_nnz w (x² - 2 m x) + m² Σ_all w
    s2 = col_acc(weights[rows] * vals * vals)
    var = (s2 - 2.0 * mean * s1 + mean * mean * wsum) / np.maximum(wsum - 1.0, 1.0)
    counts = np.bincount(cols, minlength=dim)
    has_implicit_zero = counts < n
    cmax = np.full((dim,), -np.inf)
    np.maximum.at(cmax, cols, vals)
    cmax = np.where(has_implicit_zero, np.maximum(cmax, 0.0), cmax)
    cmax = np.where(np.isneginf(cmax), 0.0, cmax)
    cmin = np.full((dim,), np.inf)
    np.minimum.at(cmin, cols, vals)
    cmin = np.where(has_implicit_zero, np.minimum(cmin, 0.0), cmin)
    cmin = np.where(np.isinf(cmin), 0.0, cmin)
    return {
        "count": n,
        "weight_sum": wsum,
        "mean": mean,
        "variance": var,
        "max": cmax,
        "min": cmin,
        "max_magnitude": np.maximum(np.abs(cmax), np.abs(cmin)),
        "norm_l1": col_acc(np.abs(vals)),
        "norm_l2": np.sqrt(col_acc(vals * vals)),
        "num_nonzeros": col_acc((vals != 0).astype(np.float64)),
    }
