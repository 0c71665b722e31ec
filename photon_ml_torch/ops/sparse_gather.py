"""Row-segmented gather-sum: the inner operation of every sparse margin.

    out[i] = Σ_{k in row i} vals[k] · w[idx[k]]

Counterpart of the TPU kernels ``pallas_gather_sum`` in
``experiments/sparse_gather_probe.py`` (G1) and
``experiments/sparse_gather_probe2.py`` (G2, the same function with ``w``
read as ``[d/128, 128]``), which sum one segment of ``nnz`` entries; here
the sum is segmented by row, so G1 and G2 are the case of one row holding
every entry. It is the gather-sum inside ``sparse_margins``
(``photon_ml_tpu/data/sparse_batch.py:905-953``): the ELL row-sum
``einsum("nl,nl->n", ell_vals, w[ell_cols])`` and the flat tail's
``segment_sum(values·w[col_indices], row_ids)``.

Two layouts, either or both in one call:

- ``ell = (vals [n, L], cols [n, L])``: a padded row block (pad slots carry
  value 0);
- ``tail = (vals [nnz], cols [nnz], row_ids [nnz], row_ptr [n+1])``: a
  row-sorted flat COO tail; the kernel reads ``row_ptr`` (row i's entries
  are ``[row_ptr[i], row_ptr[i+1])``), the plain version ``row_ids``, which
  may be None (it is then rebuilt from ``row_ptr``).
  ``chunks``, a :class:`ChunkPlan` from :func:`segment_plan`, cuts rows
  longer than ``SEGMENT_CHUNK`` entries into chunks, whose partial sums the
  chunk kernel writes and the row or segment kernel adds in a fixed order;
  it lists the long rows only (a kernel knows a row is long from its own
  pointers), so it costs nothing ``[n]``-sized.

The kernel gives an ELL row a group of 4, 8 or 16 lanes (:func:`ell_plan`),
which read its entries in vectors of up to 4, and a row's flat tail the
whole warp. With a tail and no ELL block whose rows average fewer than 32
entries (the transpose of a sparse batch, one row per column) a second
kernel, the segment kernel, gives a warp a run of 32 rows: it loads the
run's entries once, 64 at a time, and each lane adds its own row's terms in
entry order.

The kernel is hand-written CUDA for Hopper, ``csrc/sparse_gather.cu``; its
header states the bound and the design. It reads f32 or bf16 values, int32
columns and an f32 ``w``, accumulates in f32 and writes f32 ``[n]``; two
calls on the same inputs are bitwise equal. On a CPU tensor
:func:`gather_sum` runs the plain PyTorch version
(:func:`gather_sum_reference`, in the inputs' own dtype); on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from photon_ml_torch.build import check_cuda as _check
from photon_ml_torch.build import on_device as _on

#: launches of the row kernel: one per gather-sum with an ELL block or long
#: rows on the card (every sparse margin of an ELL or hybrid batch)
launches = 0
#: launches of the segment kernel: one per gather-sum of short rows with no
#: ELL block (every transpose Xᵀr over a batch's column-sorted plan)
segment_launches = 0
#: launches of the chunk kernel (one per gather-sum whose tail has rows
#: longer than SEGMENT_CHUNK and a chunk plan)
chunk_launches = 0

#: entries of one chunk of a long row; must equal kChunk in the CUDA source
SEGMENT_CHUNK = 2048
#: a tail without an ELL block whose rows average fewer entries than this
#: (a warp's width) takes one thread per row instead of one warp
SHORT_ROWS = 32
#: the segment kernel's rows a warp (kRunSegments) and entries it stages at
#: a time (kPiece); must equal the CUDA source's
RUN_SEGMENTS = 32
PIECE = 64

_LIB = None
_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from photon_ml_torch import build

        lib = build.load("sparse_gather")
        lib.sparse_gather_chunk.restype = ctypes.c_int
        lib.sparse_gather_segment_run.argtypes = []
        lib.sparse_gather_segment_run.restype = ctypes.c_int
        lib.sparse_gather_rows.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP, _VP, ctypes.c_int, _VP, _VP, _VP, _VP,
            _VP, _VP, ctypes.c_int, _VP, ctypes.c_longlong, _VP, _VP]
        lib.sparse_gather_rows.restype = ctypes.c_int
        lib.sparse_gather_chunks.argtypes = [
            ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP,
            ctypes.c_longlong, _VP, _VP]
        lib.sparse_gather_chunks.restype = ctypes.c_int
        lib.sparse_gather_segments.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP, ctypes.c_longlong,
            _VP, _VP]
        lib.sparse_gather_segments.restype = ctypes.c_int
        if lib.sparse_gather_chunk() != SEGMENT_CHUNK:
            raise RuntimeError("csrc/sparse_gather.cu kChunk differs from SEGMENT_CHUNK")
        if lib.sparse_gather_segment_run() != RUN_SEGMENTS * 1000 + PIECE:
            raise RuntimeError("csrc/sparse_gather.cu kRunSegments or kPiece differs from "
                               "RUN_SEGMENTS or PIECE")
        _LIB = lib
    return _LIB


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_gather kernel: {msg}")


def ell_plan(width: int, vals_ptr: int = 0, cols_ptr: int = 0,
             itemsize: int = 4) -> tuple[int, int]:
    """(lanes a row, entries a vector load) of the row kernel for an ELL
    block ``width`` entries wide whose values (``itemsize`` bytes each) and
    int32 columns start at ``vals_ptr`` and ``cols_ptr``: (32, 1) with no
    ELL block; else the widest vector of 4, 2 or 1 entries that divides the
    width and to which both starts are aligned (so that every row's start
    is), and 4, 8 or 16 lanes, the fewest that cover a row's vectors in one
    step (16 for more than 8 vectors; the fastest on an H100 at widths 1 to
    64, see csrc/sparse_gather.cu)."""
    if width == 0:
        return 32, 1
    vec = next(v for v in (4, 2, 1) if width % v == 0 and vals_ptr % (v * itemsize) == 0
               and cols_ptr % (v * 4) == 0)
    vectors = width // vec
    return (4 if vectors <= 4 else 8 if vectors <= 8 else 16), vec


class ChunkPlan(NamedTuple):
    """The chunks of a tail's long rows (more than ``SEGMENT_CHUNK``
    entries): ``rows`` [R] int32, the long rows in order; ``chunk_ptr``
    [R+1] int32, where each one's chunks start (chunk c of the plan covers
    ``SEGMENT_CHUNK`` entries from ``row_ptr[rows[r]] + (c - chunk_ptr[r]) ·
    SEGMENT_CHUNK`` for the last r with ``chunk_ptr[r] <= c``, the last
    chunk of a row to its end); ``count``, the number of chunks."""

    rows: torch.Tensor
    chunk_ptr: torch.Tensor
    count: int

    def nbytes(self) -> int:
        return 4 * (self.rows.numel() + self.chunk_ptr.numel())


def segment_plan(row_ids: torch.Tensor, n: int):
    """(row_ptr [n+1] int32, chunks) of a row-sorted flat tail, on its
    device. ``chunks`` is None when no row is longer than SEGMENT_CHUNK,
    else the :class:`ChunkPlan` of those rows. Built once per batch, with
    one device sync."""
    dev = row_ids.device
    bounds = torch.arange(n + 1, dtype=row_ids.dtype, device=dev)
    row_ptr = torch.searchsorted(row_ids, bounds).to(torch.int32)
    if row_ids.numel() == 0:
        return row_ptr, None
    return row_ptr, pointer_chunks(row_ptr)


def pointer_chunks(row_ptr: torch.Tensor) -> ChunkPlan | None:
    """The :class:`ChunkPlan` of the rows longer than SEGMENT_CHUNK of a
    tail given by its int32 ``[n+1]`` pointers (None when there is none),
    with one device sync."""
    dev = row_ptr.device
    if row_ptr.numel() < 2:
        return None
    lens = row_ptr[1:] - row_ptr[:-1]
    long = lens > SEGMENT_CHUNK
    rank = torch.cumsum(long, 0, dtype=torch.int32)  # long rows up to and including each row
    per_row = torch.where(long, (lens + SEGMENT_CHUNK - 1) // SEGMENT_CHUNK, 0)
    num_long, count = torch.stack([rank[-1].long(), per_row.sum()]).tolist()
    if num_long == 0:
        return None
    # the r-th long row is the first row whose rank reaches r + 1
    rows = torch.searchsorted(rank, torch.arange(1, num_long + 1, dtype=torch.int32, device=dev))
    chunk_ptr = torch.zeros(num_long + 1, dtype=torch.int32, device=dev)
    torch.cumsum(per_row[rows], 0, out=chunk_ptr[1:])
    return ChunkPlan(rows.to(torch.int32), chunk_ptr, int(count))


def host_segment_plan(row_ids: np.ndarray, n: int) -> tuple:
    """:func:`segment_plan` of a row-sorted tail's host row ids, in numpy and
    with no device work (a plan built this way can be copied into the
    static inputs of a captured CUDA graph): (row_ptr [n+1] int32, long rows
    [R] int32 or None, their chunk_ptr [R+1] int32 or None, chunk count),
    the values :func:`segment_plan` and :func:`pointer_chunks` give."""
    row_ptr = np.searchsorted(np.asarray(row_ids), np.arange(n + 1)).astype(np.int32)
    lens = np.diff(row_ptr.astype(np.int64))
    long = np.flatnonzero(lens > SEGMENT_CHUNK)
    if not long.size:
        return row_ptr, None, None, 0
    per_row = (lens[long] + SEGMENT_CHUNK - 1) // SEGMENT_CHUNK
    chunk_ptr = np.zeros(long.size + 1, np.int32)
    np.cumsum(per_row, out=chunk_ptr[1:])
    return row_ptr, long.astype(np.int32), chunk_ptr, int(chunk_ptr[-1])


def segment_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """The row of each entry of a row-sorted tail, from its ``row_ptr``."""
    n = row_ptr.numel() - 1
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=row_ptr.device),
                                   lens)


def gather_sum_reference(w: torch.Tensor, n: int, *, ell=None, tail=None, chunks=None):
    """Plain PyTorch version of :func:`gather_sum` on any device, in the
    promoted dtype of the values and ``w``: the ELL row-sum and an
    ``index_add_`` of the tail over its row ids (rebuilt from ``row_ptr``
    where they are None). ``chunks`` changes no result and is ignored."""
    del chunks
    dtype = w.dtype
    if ell is not None:
        dtype = torch.promote_types(ell[0].dtype, dtype)
    if tail is not None:
        dtype = torch.promote_types(tail[0].dtype, dtype)
    out = torch.zeros((n,), dtype=dtype, device=w.device)
    if ell is not None:
        vals, cols = ell
        out = (vals.to(dtype) * w.to(dtype)[cols.long()]).sum(-1)
    if tail is not None and tail[0].numel():
        vals, cols, row_ids, row_ptr = tail
        if row_ids is None:
            row_ids = segment_ids(row_ptr)
        contrib = vals.to(dtype) * w.to(dtype)[cols.long()]
        out = out.index_add(0, row_ids.long(), contrib)
    return out


def chunk_partials_reference(w: torch.Tensor, tail, chunks: ChunkPlan) -> torch.Tensor:
    """Plain PyTorch version of :func:`chunk_partials`: ``[chunks.count]``
    sums, chunk c the sum of vals·w[cols] over its entries, in the promoted
    dtype of the values and ``w`` (a masked ``[count, SEGMENT_CHUNK]``
    gather, with no host sync)."""
    vals, cols, _, row_ptr = tail
    dev = w.device
    c = torch.arange(chunks.count, device=dev)
    r = torch.searchsorted(chunks.chunk_ptr, c.to(chunks.chunk_ptr.dtype), right=True) - 1
    rows = chunks.rows.long()[r]
    begin = row_ptr[rows].long() + (c - chunks.chunk_ptr[r].long()) * SEGMENT_CHUNK
    end = torch.minimum(begin + SEGMENT_CHUNK, row_ptr[rows + 1].long())
    at = begin[:, None] + torch.arange(SEGMENT_CHUNK, device=dev)
    inside = at < end[:, None]
    at = torch.where(inside, at, 0)
    dtype = torch.promote_types(vals.dtype, w.dtype)
    terms = vals[at].to(dtype) * w.to(dtype)[cols[at].long()]
    return torch.where(inside, terms, 0).sum(dim=1)


def _check_entries(vals, cols, shape, dev, name):
    _require(vals.device == dev and cols.device == dev, f"{name} arrays must be on {dev}")
    _require(vals.dtype in (torch.float32, torch.bfloat16),
             f"{name} values must be float32 or bfloat16, not {vals.dtype} "
             "(a float64 batch has no kernel: use use_kernel=False)")
    _require(cols.dtype == torch.int32, f"{name} columns must be int32")
    _require(tuple(vals.shape) == shape and tuple(cols.shape) == shape,
             f"{name} values and columns must both have shape {shape}")
    _require(vals.is_contiguous() and cols.is_contiguous(), f"{name} arrays must be contiguous")


def _index_vector(t, size, dev, name):
    _require(t.device == dev and t.dtype == torch.int32 and t.is_contiguous()
             and tuple(t.shape) == (size,),
             f"{name} must be a contiguous int32 [{size}] tensor on {dev}")


def gather_sum(w: torch.Tensor, n: int, *, ell=None, tail=None, chunks=None) -> torch.Tensor:
    """out[i] = Σ vals·w[cols] over row i of the ELL block and of the flat
    tail. A CPU ``w`` runs :func:`gather_sum_reference`; a CUDA ``w``
    launches the kernel (f32 ``[n]`` out) or raises."""
    if w.device.type == "cpu":
        return gather_sum_reference(w, n, ell=ell, tail=tail, chunks=chunks)
    return _launch(w, n, ell, tail, chunks)


def _check_w(w):
    _require(w.is_cuda, "w must be a CUDA tensor")
    _require(w.dtype == torch.float32 and w.dim() == 1 and w.is_contiguous(),
             "w must be a contiguous 1-D float32 tensor")


def _check_tail(tail, n, dev):
    """Check a tail's arrays for the kernels; whether its values are bf16."""
    vals, cols, _, row_ptr = tail
    _require(vals.dim() == 1, "tail values must be 1-D")
    _check_entries(vals, cols, (vals.shape[0],), dev, "tail")
    _require(vals.shape[0] < 2**31, "tail holds 2^31 entries or more")
    _index_vector(row_ptr, n + 1, dev, "row_ptr")
    return vals.dtype == torch.bfloat16


def chunk_partials(w: torch.Tensor, tail, chunks: ChunkPlan) -> torch.Tensor:
    """Launch the chunk kernel: ``[chunks.count]`` f32 partials, one per
    chunk of the tail's long rows (the row kernel and the segment kernel
    add them; :func:`gather_sum` launches both). CUDA tensors only: a CPU
    tensor raises (:func:`chunk_partials_reference` is the plain version)."""
    global chunk_launches
    _check_w(w)
    dev = w.device
    vals, cols, _, row_ptr = tail
    is_bf16 = _check_tail(tail, row_ptr.shape[0] - 1, dev)
    long_rows, long_chunk_ptr, count = chunks
    num_long = long_rows.shape[0]
    _require(num_long >= 1 and count >= 1, "a chunk plan lists at least one long row")
    _index_vector(long_rows, num_long, dev, "the chunk plan's rows")
    _index_vector(long_chunk_ptr, num_long + 1, dev, "the chunk plan's chunk_ptr")
    vec = 4 if cols.data_ptr() % 16 == 0 and vals.data_ptr() % (4 * vals.element_size()) == 0 \
        else 1
    with _on(dev):
        partials = torch.empty((count,), dtype=torch.float32, device=dev)
        _check(_lib().sparse_gather_chunks(
            int(is_bf16), vec, vals.data_ptr(), cols.data_ptr(), row_ptr.data_ptr(),
            long_rows.data_ptr(), long_chunk_ptr.data_ptr(), num_long, w.data_ptr(), count,
            partials.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "sparse_gather_chunks")
        chunk_launches += 1
    return partials


def tail_kernel_counter(n: int, nnz: int) -> str:
    """The counter of the kernel that :func:`gather_sum` launches for a flat
    tail of ``nnz`` entries over ``n`` rows and no ELL block: the segment
    kernel's (fewer than ``SHORT_ROWS`` entries a row) or the row kernel's."""
    return "segment_launches" if nnz < SHORT_ROWS * n else "launches"


def _launch(w, n, ell, tail, chunks):
    global launches, segment_launches
    _check_w(w)
    dev = w.device
    _require(0 <= n < 2**31, f"n={n} out of range")
    is_bf16 = None
    ell_vals = ell_cols = tail_vals = tail_cols = row_ptr = None
    width = 0
    if ell is not None:
        ell_vals, ell_cols = ell
        _require(ell_vals.dim() == 2, "ELL values must be [n, L]")
        width = ell_vals.shape[1]
        _check_entries(ell_vals, ell_cols, (n, width), dev, "ELL")
        is_bf16 = ell_vals.dtype == torch.bfloat16
    if tail is not None and tail[0].numel():
        tail_vals, tail_cols, _, row_ptr = tail
        tail_bf16 = _check_tail(tail, n, dev)
        _require(is_bf16 is None or is_bf16 == tail_bf16,
                 "ELL and tail values must have one dtype")
        is_bf16 = tail_bf16
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        plan = (None, None, None, 0)
        if tail_vals is not None and chunks is not None:
            partials = chunk_partials(w, tail, chunks)
            plan = (partials.data_ptr(), chunks.rows.data_ptr(), chunks.chunk_ptr.data_ptr(),
                    chunks.rows.shape[0])
        if n and ell_vals is None and tail_vals is not None \
                and tail_kernel_counter(n, tail_vals.shape[0]) == "segment_launches":
            _check(lib.sparse_gather_segments(
                int(bool(is_bf16)), tail_vals.data_ptr(), tail_cols.data_ptr(),
                row_ptr.data_ptr(), *plan, w.data_ptr(), n, out.data_ptr(), stream),
                "sparse_gather_segments")
            segment_launches += 1
        elif n:
            lanes, vec = ell_plan(width, ptr(ell_vals) or 0, ptr(ell_cols) or 0,
                                  2 if is_bf16 else 4)
            _check(lib.sparse_gather_rows(
                int(bool(is_bf16)), lanes, vec, ptr(ell_vals), ptr(ell_cols), width,
                ptr(tail_vals), ptr(tail_cols), ptr(row_ptr), *plan, w.data_ptr(), n,
                out.data_ptr(), stream), "sparse_gather_rows")
            launches += 1
    return out
