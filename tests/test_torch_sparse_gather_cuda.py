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
@pytest.mark.parametrize("layout", ["ell", "ell_tail", "flat", "flat_long_rows",
                                    "ell_tail_long_rows"])
def test_kernel_matches_plain_version(cuda, layout, dtype):
    n, d = 3000, 100_000
    long_rows = (7, 1999) if layout.endswith("long_rows") else ()
    rows, cols, vals = _coo(n, d, seed=1, long_rows=long_rows, long_len=5000)
    ell = {"ell": 40, "ell_tail": 8, "ell_tail_long_rows": 8}.get(layout, False)
    batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, np.zeros(n, np.float32), dim=d,
                                             dtype=dtype, ell=ell, device=cuda)
    assert (batch.row_chunks is not None) == bool(long_rows)
    w = torch.randn(d, device=cuda)
    e = (batch.ell_vals, batch.ell_cols) if batch.has_ell_view else None
    t = (batch.values, batch.col_indices, batch.row_ids, batch.row_ptr) if batch.nnz else None
    before = sparse_gather.launches + sparse_gather.segment_launches
    k1 = sparse_gather.gather_sum(w, n, ell=e, tail=t, chunks=batch.row_chunks)
    k2 = sparse_gather.gather_sum(w, n, ell=e, tail=t, chunks=batch.row_chunks)
    plain = sparse_gather.gather_sum_reference(w.double(), n, ell=e, tail=t)
    torch.cuda.synchronize()
    # rows of an ELL block take the row kernel, short flat rows the segment kernel
    assert sparse_gather.launches + sparse_gather.segment_launches == before + 2
    assert torch.equal(k1, k2)  # bitwise repeatable
    _check(k1, plain, _scale(w, n, e, t))
    assert bool((k1[::5] == 0).all())  # empty rows


@pytest.mark.parametrize("width", [1, 3, 35, 36, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ell_widths(cuda, dtype, width):
    """ELL blocks of every lane-group and vector case (``ell_plan``), pad
    slots (value 0, column 0) included: twice bitwise equal, within
    1e-5·Σ|vals·w| of the plain version per row; and the same block from its
    second row on, whose start is 4·width bytes (f32) or 2·width bytes
    (bf16) past an aligned one, so narrower loads are taken."""
    n, d = 3001, 50_000
    g = torch.Generator(device=cuda).manual_seed(width)
    vals = torch.randn(n, width, device=cuda, generator=g).to(dtype)
    cols = torch.randint(0, d, (n, width), device=cuda, generator=g, dtype=torch.int32)
    pad = torch.rand(n, width, device=cuda, generator=g) < 0.1
    vals, cols = vals.masked_fill(pad, 0.0), cols.masked_fill(pad, 0)
    w = torch.randn(d, device=cuda, generator=g)
    for rows, ell in ((n, (vals, cols)), (n - 1, (vals[1:], cols[1:]))):
        before = sparse_gather.launches
        k1 = sparse_gather.gather_sum(w, rows, ell=ell)
        k2 = sparse_gather.gather_sum(w, rows, ell=ell)
        plain = sparse_gather.gather_sum_reference(w.double(), rows, ell=ell)
        torch.cuda.synchronize()
        assert sparse_gather.launches == before + 2
        assert torch.equal(k1, k2)  # bitwise repeatable
        _check(k1, plain, _scale(w, rows, ell))


def test_one_segment_g1_shape(cuda):
    """G1's case: one row holding every entry, cut into chunks."""
    nnz, d = 1 << 20, 1 << 18
    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, d, (nnz,), device=cuda, generator=g, dtype=torch.int32)
    vals = torch.randn(nnz, device=cuda, generator=g)
    w = torch.randn(d, device=cuda, generator=g)
    row_ids = torch.zeros(nnz, dtype=torch.int32, device=cuda)
    row_ptr, chunks = sparse_gather.segment_plan(row_ids, 1)
    assert chunks is not None and chunks.count == nnz // sparse_gather.SEGMENT_CHUNK
    assert chunks.rows.tolist() == [0] and chunks.chunk_ptr.tolist() == [0, chunks.count]
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
    kernel over the column-sorted plan (about four entries a column, so the
    segment kernel), twice bitwise equal, against the plain ``index_add_``
    in f64 within 1e-5·Σ|r·x| per column; a long column (more than a chunk
    of entries) included."""
    n, d = 4096, 20000
    rows, cols, vals = _coo(n, d, seed=6)
    cols[::3] = 7  # one column of ~27,000 entries: chunked
    kw = dict(hybrid=HybridPolicy(hot_cols=8)) if layout == "hybrid" else {}
    y = np.zeros(n)
    batch = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, device=cuda, **kw)
    r = torch.randn(n, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = sparse_gather.segment_launches
    a = sparse_column_sum(batch, r)
    b = sparse_column_sum(batch, r)
    assert sparse_gather.segment_launches == before + 2 and torch.equal(a, b)
    batch64 = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, dtype=torch.float64,
                                               device=cuda, **kw)
    want = sparse_column_sum(batch64, r.double(), use_kernel=False)
    abs64 = SparseLabeledPointBatch.from_coo(rows, cols, np.abs(vals), y, dim=d,
                                             dtype=torch.float64, device=cuda, **kw)
    scale = sparse_column_sum(abs64, r.double().abs(), use_kernel=False)
    assert bool(((a.double() - want).abs() <= 1e-5 * scale + 1e-30).all())


def _columns(lengths, n, seed):
    """A column-sorted tail with the given entries a column (rows drawn at
    random in [0, n)), as the transpose plan holds it, with its chunk plan."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    cols = np.repeat(np.arange(len(lengths)), lengths)
    rows = rng.integers(0, n, size=len(cols)).astype(np.int32)
    vals = rng.normal(size=len(cols)).astype(np.float32)
    return cols, rows, vals


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["empty_columns", "longer_than_a_piece", "at_and_over_a_chunk",
                                  "ragged_last_run"])
def test_segment_kernel_columns(cuda, case, dtype):
    """The segment kernel over column-sorted entries (the transpose's
    layout): empty columns (most of a run, and whole runs), a column longer
    than one staged piece of ``PIECE`` entries, columns of exactly
    ``SEGMENT_CHUNK`` entries (staged) and one more (chunk partials) beside
    short ones in the same run, and a last run that is not full; twice
    bitwise equal and within 1e-5·Σ|v·r| of the plain version in f64 per
    column."""
    n = 5000
    rng = np.random.default_rng(11)
    if case == "empty_columns":
        lengths = np.where(rng.uniform(size=4000) < 0.05, rng.integers(1, 4, size=4000), 0)
        lengths[64:160] = 0  # three whole runs empty
    elif case == "longer_than_a_piece":
        lengths = rng.integers(0, 5, size=3000)
        lengths[[5, 40, 41, 2999]] = [sparse_gather.PIECE + 1, 3 * sparse_gather.PIECE,
                                      sparse_gather.PIECE, 1000]
    elif case == "at_and_over_a_chunk":
        lengths = rng.integers(0, 5, size=3000)
        chunk = sparse_gather.SEGMENT_CHUNK
        lengths[[3, 4, 70, 100, 127]] = [chunk, chunk + 1, chunk + 1, chunk, 5 * chunk + 7]
    else:
        lengths = rng.integers(0, 6, size=32 * 40 + 13)
    cols, rows, vals = _columns(lengths, n, seed=12)
    d = len(lengths)
    t_cols = torch.tensor(cols, dtype=torch.int32, device=cuda)
    col_ptr, chunks = sparse_gather.segment_plan(t_cols, d)
    assert (chunks is not None) == (case == "at_and_over_a_chunk")
    if chunks is not None:  # exactly SEGMENT_CHUNK entries: no chunks
        assert chunks.rows.tolist() == [4, 70, 127]
        assert chunks.chunk_ptr.tolist() == [0, 2, 4, 10] and chunks.count == 10
    tail = (torch.tensor(vals, device=cuda).to(dtype), torch.tensor(rows, device=cuda),
            None, col_ptr)
    r = torch.randn(n, device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
    before = (sparse_gather.segment_launches, sparse_gather.launches)
    k1 = sparse_gather.gather_sum(r, d, tail=tail, chunks=chunks)
    k2 = sparse_gather.gather_sum(r, d, tail=tail, chunks=chunks)
    torch.cuda.synchronize()
    assert (sparse_gather.segment_launches, sparse_gather.launches) == \
        (before[0] + 2, before[1])
    assert torch.equal(k1, k2)  # bitwise repeatable
    wide = (tail[0].double(), tail[1], t_cols, col_ptr)
    plain = sparse_gather.gather_sum_reference(r.double(), d, tail=wide)
    _check(k1, plain, _scale(r, d, tail=wide))
    assert bool((k1[torch.from_numpy(lengths == 0).to(cuda)] == 0).all())  # empty columns


CHUNK_CASES = ["g1", "g2", "ragged", "planted_transpose", "alignments", "unaligned"]


def _long_rows_case(case, cuda, dtype):
    """(w, tail, chunks, n) of one chunk-kernel case: G1 and G2's one
    segment, the ragged rows of chip_smoke.py (rows of up to 20,000
    entries), a planted transpose (256 columns of about 8,800 entries among
    short ones, as the ELL batch's planted columns are), long rows starting
    at every alignment mod 4, and the same rows read from a view one entry
    into the arrays (no 16-byte alignment: the kernel's scalar loads)."""
    g = torch.Generator(device=cuda).manual_seed(CHUNK_CASES.index(case))
    rng = np.random.default_rng(CHUNK_CASES.index(case))
    k = sparse_gather.SEGMENT_CHUNK
    if case in ("g1", "g2"):
        nnz, d = {"g1": (1 << 24, 1 << 22), "g2": (1 << 22, 1 << 21)}[case]
        lengths = np.array([nnz])
    elif case == "ragged":
        lengths = rng.integers(0, 40, size=50_000)
        lengths[::7] = 0
        lengths[[3, 25_000, 49_998]] = [5000, 20000, 3000]
        d = 100_000
    elif case == "planted_transpose":
        lengths = rng.integers(0, 5, size=200_000)
        lengths[rng.choice(200_000, 256, replace=False)] = rng.integers(8000, 9600, size=256)
        d = 1 << 19  # the transpose gathers r, one per row of the batch
    else:
        lengths = np.concatenate([[s % 4, 0, k + 1 + 3 * s, 5] for s in range(16)])
        d = 10_000
    nnz = int(lengths.sum())
    skip = 1 if case == "unaligned" else 0
    vals = torch.randn(nnz + skip, device=cuda, generator=g).to(dtype)[skip:]
    cols = torch.randint(0, d, (nnz + skip,), device=cuda, generator=g, dtype=torch.int32)[skip:]
    row_ids = torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths).astype(np.int32))
    row_ptr, chunks = sparse_gather.segment_plan(row_ids.to(cuda), len(lengths))
    assert chunks is not None
    return torch.randn(d, device=cuda, generator=g), (vals, cols, None, row_ptr), chunks, \
        len(lengths)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_kernel_matches_plain_version(cuda, case, dtype):
    """The chunk kernel alone against its plain version in f64: every
    chunk's partial within 1e-5·Σ|v·w| of its chunk, twice bitwise equal,
    one launch a call; then the whole gather-sum over those rows (chunk
    kernel, then the row or segment kernel adding the partials) within
    1e-7·Σ|v·w| per row for G1 and G2's one segment and 1e-5 for the
    rest."""
    w, tail, chunks, n = _long_rows_case(case, cuda, dtype)
    before = sparse_gather.chunk_launches
    p1 = sparse_gather.chunk_partials(w, tail, chunks)
    p2 = sparse_gather.chunk_partials(w, tail, chunks)
    wide = (tail[0].double(), *tail[1:])
    plain = sparse_gather.chunk_partials_reference(w.double(), wide, chunks)
    scale = sparse_gather.chunk_partials_reference(w.double().abs(), (wide[0].abs(), *tail[1:]),
                                                   chunks)
    torch.cuda.synchronize()
    assert sparse_gather.chunk_launches == before + 2
    assert p1.dtype == torch.float32 and p1.shape == (chunks.count,) and torch.equal(p1, p2)
    assert bool(((p1.double() - plain).abs() <= 1e-5 * scale + 1e-30).all())
    k1 = sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)
    k2 = sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    rel = 1e-7 if case in ("g1", "g2") else 1e-5
    want = sparse_gather.gather_sum_reference(w.double(), n, tail=wide)
    assert bool(((k1.double() - want).abs() <= rel * _scale(w, n, tail=tail) + 1e-30).all())


@pytest.mark.parametrize("case", ["planted_transpose", "ragged", "g2"])
def test_chunked_gather_captures_into_a_graph(cuda, case):
    """The chunk kernel and its consumer (the segment kernel for the
    transpose's short columns, the row kernel for the rest) captured in a
    CUDA graph: each replay equals the eager call bitwise."""
    w, tail, chunks, n = _long_rows_case(case, cuda, torch.float32)
    eager = sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sparse_gather.gather_sum(w, n, tail=tail, chunks=chunks)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
