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
  are ``[row_ptr[i], row_ptr[i+1])``), the plain version ``row_ids``.
  ``chunks = (chunk_row, chunk_ptr)``, from :func:`segment_plan`, cuts rows
  longer than ``SEGMENT_CHUNK`` entries into chunks whose partial sums a
  second pass adds in a fixed order; shorter rows have no chunks.

With a tail and no ELL block whose rows average fewer than 32 entries (the
transpose of a sparse batch, one row per column) the kernel gives each row
one thread instead of one warp.

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

import torch

from photon_ml_torch.build import check_cuda as _check
from photon_ml_torch.build import on_device as _on

#: launches of the row (or segment) kernel: one per gather-sum on the card
launches = 0
#: launches of the chunk kernel (only for rows longer than SEGMENT_CHUNK)
chunk_launches = 0

#: entries of one chunk of a long row; must equal kChunk in the CUDA source
SEGMENT_CHUNK = 2048
#: a tail without an ELL block whose rows average fewer entries than this
#: (a warp's width) takes one thread per row instead of one warp
SHORT_ROWS = 32

_LIB = None
_VP = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from photon_ml_torch import build

        lib = build.load("sparse_gather")
        lib.sparse_gather_chunk.restype = ctypes.c_int
        lib.sparse_gather_rows.argtypes = [
            ctypes.c_int, _VP, _VP, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP,
            ctypes.c_longlong, _VP, _VP]
        lib.sparse_gather_rows.restype = ctypes.c_int
        lib.sparse_gather_chunks.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, _VP, _VP]
        lib.sparse_gather_chunks.restype = ctypes.c_int
        lib.sparse_gather_segments.argtypes = [
            ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, _VP, _VP]
        lib.sparse_gather_segments.restype = ctypes.c_int
        if lib.sparse_gather_chunk() != SEGMENT_CHUNK:
            raise RuntimeError("csrc/sparse_gather.cu kChunk differs from SEGMENT_CHUNK")
        _LIB = lib
    return _LIB


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_gather kernel: {msg}")


def segment_plan(row_ids: torch.Tensor, n: int):
    """(row_ptr [n+1] int32, chunks) of a row-sorted flat tail, on its
    device. ``chunks`` is None when no row is longer than SEGMENT_CHUNK,
    else (chunk_row [C] int32, chunk_ptr [n+1] int32) over the rows longer
    than that (a shorter row has none): chunk c covers entries
    ``row_ptr[i] + (c - chunk_ptr[i])·SEGMENT_CHUNK`` onward of row
    ``i = chunk_row[c]``. Built once per batch (one device sync)."""
    dev = row_ids.device
    bounds = torch.arange(n + 1, dtype=row_ids.dtype, device=dev)
    row_ptr = torch.searchsorted(row_ids, bounds).to(torch.int32)
    if row_ids.numel() == 0:
        return row_ptr, None
    lens = (row_ptr[1:] - row_ptr[:-1]).long()
    if int(lens.max()) <= SEGMENT_CHUNK:
        return row_ptr, None
    per_row = torch.where(lens > SEGMENT_CHUNK, (lens + SEGMENT_CHUNK - 1) // SEGMENT_CHUNK, 0)
    chunk_ptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_row, 0, out=chunk_ptr[1:])
    chunk_row = torch.repeat_interleave(torch.arange(n, device=dev), per_row)
    return row_ptr, (chunk_row.to(torch.int32), chunk_ptr.to(torch.int32))


def gather_sum_reference(w: torch.Tensor, n: int, *, ell=None, tail=None, chunks=None):
    """Plain PyTorch version of :func:`gather_sum` on any device, in the
    promoted dtype of the values and ``w``: the ELL row-sum and an
    ``index_add_`` of the tail over its row ids. ``chunks`` changes no
    result and is ignored."""
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
        vals, cols, row_ids, _ = tail
        contrib = vals.to(dtype) * w.to(dtype)[cols.long()]
        out = out.index_add(0, row_ids.long(), contrib)
    return out


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


def _launch(w, n, ell, tail, chunks):
    global launches, chunk_launches
    _require(w.is_cuda, "w must be a CUDA tensor")
    dev = w.device
    _require(w.dtype == torch.float32 and w.dim() == 1 and w.is_contiguous(),
             "w must be a contiguous 1-D float32 tensor")
    _require(0 <= n < 2**31, f"n={n} out of range")
    is_bf16 = None
    ell_vals = ell_cols = tail_vals = tail_cols = row_ptr = chunk_ptr = None
    width = 0
    if ell is not None:
        ell_vals, ell_cols = ell
        _require(ell_vals.dim() == 2, "ELL values must be [n, L]")
        width = ell_vals.shape[1]
        _check_entries(ell_vals, ell_cols, (n, width), dev, "ELL")
        is_bf16 = ell_vals.dtype == torch.bfloat16
    if tail is not None and tail[0].numel():
        tail_vals, tail_cols, _, row_ptr = tail
        _require(tail_vals.dim() == 1, "tail values must be 1-D")
        _check_entries(tail_vals, tail_cols, (tail_vals.shape[0],), dev, "tail")
        _require(tail_vals.shape[0] < 2**31, "tail holds 2^31 entries or more")
        _index_vector(row_ptr, n + 1, dev, "row_ptr")
        tail_bf16 = tail_vals.dtype == torch.bfloat16
        _require(is_bf16 is None or is_bf16 == tail_bf16,
                 "ELL and tail values must have one dtype")
        is_bf16 = tail_bf16
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = torch.empty((n,), dtype=torch.float32, device=dev)
        partials = None
        if tail_vals is not None and chunks is not None:
            chunk_row, chunk_ptr = chunks
            _index_vector(chunk_row, chunk_row.shape[0], dev, "chunk_row")
            _index_vector(chunk_ptr, n + 1, dev, "chunk_ptr")
            partials = torch.empty((chunk_row.shape[0],), dtype=torch.float32, device=dev)
            _check(lib.sparse_gather_chunks(
                int(is_bf16), tail_vals.data_ptr(), tail_cols.data_ptr(), row_ptr.data_ptr(),
                chunk_row.data_ptr(), chunk_ptr.data_ptr(), w.data_ptr(),
                chunk_row.shape[0], partials.data_ptr(), stream), "sparse_gather_chunks")
            chunk_launches += 1
        else:
            chunk_ptr = None
        if n and ell_vals is None and tail_vals is not None \
                and tail_vals.shape[0] < SHORT_ROWS * n:
            _check(lib.sparse_gather_segments(
                int(bool(is_bf16)), tail_vals.data_ptr(), tail_cols.data_ptr(),
                row_ptr.data_ptr(), ptr(partials), ptr(chunk_ptr), w.data_ptr(), n,
                out.data_ptr(), stream), "sparse_gather_segments")
            launches += 1
        elif n:
            _check(lib.sparse_gather_rows(
                int(bool(is_bf16)), ptr(ell_vals), ptr(ell_cols), width, ptr(tail_vals),
                ptr(tail_cols), ptr(row_ptr), ptr(partials), ptr(chunk_ptr), w.data_ptr(), n,
                out.data_ptr(), stream), "sparse_gather_rows")
            launches += 1
    return out
