"""The CUDA kernel of ops/sparse_gather.py against its plain version, on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sparse_gather_cuda.py
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.data.sparse_batch import (
    HybridPolicy,
    SparseLabeledPointBatch,
    sparse_column_sum,
    sparse_margins,
)
from photon_ml_torch.ops import sparse_gather

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coo(n, d, seed, *, empty_every=5, long_rows=(), long_len=0):
    """Ragged rows (some empty), and a few rows of ``long_len`` entries."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, size=n)
    counts[::empty_every] = 0
    for r in long_rows:
        counts[r] = long_len
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, d, size=len(rows))
    vals = rng.normal(size=len(rows)).astype(np.float32)
    return rows, cols, vals


def _check(got, want, scale):
    """|k - p| <= 1e-5 * sum|vals * w| per row."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(((got.double() - want.double()).abs() <= 1e-5 * scale + 1e-30).all())


def _scale(w, n, ell=None, tail=None):
    absw = w.abs().double()
    e = None if ell is None else (ell[0].double().abs(), ell[1])
    t = None if tail is None else (tail[0].double().abs(),) + tuple(tail[1:])
    return sparse_gather.gather_sum_reference(absw, n, ell=e, tail=t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["ell", "ell_tail", "flat", "flat_long_rows"])
def test_kernel_matches_plain_version(cuda, layout, dtype):
    n, d = 3000, 100_000
    long_rows = (7, 1999) if layout == "flat_long_rows" else ()
    rows, cols, vals = _coo(n, d, seed=1, long_rows=long_rows, long_len=5000)
    ell = {"ell": 40, "ell_tail": 8}.get(layout, False)
    batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, np.zeros(n, np.float32), dim=d,
                                             dtype=dtype, ell=ell, device=cuda)
    assert (batch.row_chunks is not None) == bool(long_rows)
    w = torch.randn(d, device=cuda)
    e = (batch.ell_vals, batch.ell_cols) if batch.has_ell_view else None
    t = (batch.values, batch.col_indices, batch.row_ids, batch.row_ptr) if batch.nnz else None
    before = sparse_gather.launches
    k1 = sparse_gather.gather_sum(w, n, ell=e, tail=t, chunks=batch.row_chunks)
    k2 = sparse_gather.gather_sum(w, n, ell=e, tail=t, chunks=batch.row_chunks)
    plain = sparse_gather.gather_sum_reference(w.double(), n, ell=e, tail=t)
    torch.cuda.synchronize()
    assert sparse_gather.launches == before + 2
    assert torch.equal(k1, k2)  # bitwise repeatable
    _check(k1, plain, _scale(w, n, e, t))
    assert bool((k1[::5] == 0).all())  # empty rows


def test_one_segment_g1_shape(cuda):
    """G1's case: one row holding every entry, cut into chunks."""
    nnz, d = 1 << 20, 1 << 18
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, d, (nnz,), device=cuda, generator=g, dtype=torch.int32)
    vals = torch.randn(nnz, device=cuda, generator=g)
    w = torch.randn(d, device=cuda, generator=g)
    row_ids = torch.zeros(nnz, dtype=torch.int32, device=cuda)
    row_ptr, chunks = sparse_gather.segment_plan(row_ids, 1)
    assert chunks is not None and chunks[0].numel() == nnz // sparse_gather.SEGMENT_CHUNK
    tail = (vals, idx, row_ids, row_ptr)
    before = sparse_gather.chunk_launches
    k1 = sparse_gather.gather_sum(w, 1, tail=tail, chunks=chunks)
    k2 = sparse_gather.gather_sum(w, 1, tail=tail, chunks=chunks)
    torch.cuda.synchronize()
    assert sparse_gather.chunk_launches == before + 2 and torch.equal(k1, k2)
    exact = torch.dot(vals.double(), w.double()[idx.long()])
    _check(k1, exact.reshape(1), float((vals.double() * w.double()[idx.long()]).abs().sum()))


def test_hybrid_margins_match_plain(cuda):
    n, d = 2048, 50_000
    rows, cols, vals = _coo(n, d, seed=4)
    cols = np.where(np.arange(len(cols)) % 3 == 0, cols % 64, cols)  # a hot set
    batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, np.zeros(n, np.float32), dim=d,
                                             hybrid=HybridPolicy(hot_cols=32), device=cuda)
    w = torch.randn(d, device=cuda)
    got = sparse_margins(batch, w)
    want = sparse_margins(batch, w, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    n, w = 4, torch.zeros(10, device=cuda)
    ev = torch.zeros(n, 3, device=cuda)
    ec = torch.zeros(n, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        sparse_gather.gather_sum(w, n, ell=(ev.double(), ec))
    with pytest.raises(ValueError):
        sparse_gather.gather_sum(w, n, ell=(ev, ec.long()))
    with pytest.raises(ValueError):
        sparse_gather.gather_sum(w.double(), n, ell=(ev, ec))
    with pytest.raises(ValueError):
        sparse_gather.gather_sum(w, n + 1, ell=(ev, ec))
    with pytest.raises(ValueError):
        sparse_gather.gather_sum(w, n, ell=(ev.t().contiguous().t(), ec))


@pytest.mark.parametrize("layout", ["ell", "hybrid"])
def test_transpose_repeats_bitwise(cuda, layout):
    """The sparse transpose (the gradient's Xᵀr) on the card: the gather
    kernel over the column-sorted plan (about four entries a column, so a
    thread per column), twice bitwise equal, against the plain ``index_add_``
    in f64 within 1e-5·Σ|r·x| per column; a long column (more than a chunk
    of entries) included."""
    n, d = 4096, 20000
    rows, cols, vals = _coo(n, d, seed=6)
    cols[::3] = 7  # one column of ~27,000 entries: chunked
    kw = dict(hybrid=HybridPolicy(hot_cols=8)) if layout == "hybrid" else {}
    y = np.zeros(n)
    batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, device=cuda, **kw)
    r = torch.randn(n, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = sparse_gather.launches
    a = sparse_column_sum(batch, r)
    b = sparse_column_sum(batch, r)
    assert sparse_gather.launches == before + 2 and torch.equal(a, b)
    batch64 = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, dtype=torch.float64,
                                               device=cuda, **kw)
    want = sparse_column_sum(batch64, r.double(), use_kernel=False)
    abs64 = SparseLabeledPointBatch.from_coo(rows, cols, np.abs(vals), y, dim=d,
                                             dtype=torch.float64, device=cuda, **kw)
    scale = sparse_column_sum(abs64, r.double().abs(), use_kernel=False)
    assert bool(((a.double() - want).abs() <= 1e-5 * scale + 1e-30).all())
