"""The gather-sum's plain version against the TPU kernels it replaces (G1,
G2, run in Pallas interpret mode) and against the JAX package's
``sparse_margins``, on the CPU; and the wrapper's device rules."""

import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pallas

from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_torch.data import sparse_batch as tsb
from photon_ml_torch.ops import sparse_gather
from tests.test_torch_sparse_batch import LAYOUTS, D, N, _policy, coo

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

REPO = Path(__file__).resolve().parents[1]


def _probe(name: str):
    """Load experiments/<name>.py with its ``pl.pallas_call`` in interpret
    mode, so the TPU kernel runs on the CPU; the file stays as it is."""
    spec = importlib.util.spec_from_file_location(f"_torch_parity_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    pl = types.SimpleNamespace(**vars(jax_pallas))
    pl.pallas_call = functools.partial(jax_pallas.pallas_call, interpret=True)
    module.pl = pl
    return module


def _one_segment(nnz, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return idx, vals, w


def _plain_one_segment(idx, vals, w, dtype):
    """The gather-sum's plain version over one row holding every entry (the
    G1/G2 case), in ``dtype``."""
    t = lambda a, dt=dtype: torch.from_numpy(a).to(dt)  # noqa: E731
    row_ids = torch.zeros(len(idx), dtype=torch.int32)
    row_ptr = torch.tensor([0, len(idx)], dtype=torch.int32)
    out = sparse_gather.gather_sum(t(w), 1, tail=(t(vals), t(idx, torch.int32), row_ids, row_ptr))
    return float(out[0])


@pytest.mark.parametrize("probe,reshape", [("sparse_gather_probe", False),
                                           ("sparse_gather_probe2", True)],
                         ids=["G1", "G2"])
def test_plain_version_matches_tpu_kernel(probe, reshape):
    # nnz a multiple of the block: the TPU kernel's grid skips nnz % block
    d, nnz, block = 1024, 4096, 512
    idx, vals, w = _one_segment(nnz, d, seed=1 + reshape)
    wk = w.reshape(-1, 128) if reshape else w.reshape(1, -1)
    got_tpu = float(_probe(probe).pallas_gather_sum(
        jnp.asarray(idx).reshape(1, -1), jnp.asarray(vals).reshape(1, -1), jnp.asarray(wk), block))
    exact = float(np.sum(vals.astype(np.float64) * w.astype(np.float64)[idx]))
    scale = float(np.sum(np.abs(vals.astype(np.float64) * w[idx])))
    for dtype in (torch.float32, torch.float64):
        got = _plain_one_segment(idx, vals, w, dtype)
        assert abs(got - got_tpu) <= 1e-5 * scale, (dtype, got, got_tpu)
        assert abs(got - exact) <= (1e-5 if dtype == torch.float32 else 1e-12) * scale
    assert abs(got_tpu - exact) <= 1e-5 * scale


MARGIN_LAYOUTS = ["flat", "ell_auto", "ell_3", "ell_3_padded", "hybrid", "hybrid_flat_tail",
                  "column_sorted"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", MARGIN_LAYOUTS)
def test_margins_match_jax(name, dtype):
    rows, cols, vals, labels, offsets, weights = coo()
    kw = LAYOUTS[name]
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    port = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, offsets=offsets,
                                                weights=weights, dtype=tdtype, device="cpu",
                                                **_policy(tsb, kw))
    ref = jsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, offsets=offsets,
                                               weights=weights, dtype=dtype, **_policy(jsb, kw))
    w = np.random.default_rng(7).normal(size=D).astype(dtype)
    got = tsb.sparse_margins(port, torch.from_numpy(w))
    want = np.asarray(jsb.sparse_margins(ref, jnp.asarray(w)))
    assert got.dtype == tdtype
    tol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the column sums of the Hessian diagonal, both kinds
    rw = np.random.default_rng(8).uniform(size=N).astype(dtype)
    for square in (False, True):
        got = tsb.sparse_column_sum(port, torch.from_numpy(rw), square_values=square)
        want = np.asarray(jsb.sparse_column_sum(ref, jnp.asarray(rw), square_values=square))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_plain_version_ignores_chunks_and_keeps_dtype(monkeypatch):
    rows, cols, vals, labels, *_ = coo()
    batch = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, ell=2,
                                                 dtype=torch.float64, device="cpu")
    w = torch.from_numpy(np.random.default_rng(9).normal(size=D))
    base = tsb.sparse_margins(batch, w)
    monkeypatch.setattr(sparse_gather, "SEGMENT_CHUNK", 4)
    chunked = batch.replace(row_ptr=None, row_chunks=None)
    assert chunked.row_chunks is not None
    torch.testing.assert_close(tsb.sparse_margins(chunked, w), base, rtol=0, atol=0)
    # bf16 values with an f32 w come out f32, read as the kernel reads them
    b16 = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, ell=2,
                                               dtype=torch.bfloat16, device="cpu")
    m16 = tsb.sparse_margins(b16, w.float())
    assert m16.dtype == torch.float32
    want = tsb.sparse_margins(b16.replace(ell_vals=b16.ell_vals.double(),
                                          values=b16.values.double()), w)
    torch.testing.assert_close(m16.double(), want, rtol=1e-6, atol=1e-6)


def test_wrapper_device_rules():
    rows, cols, vals, labels, *_ = coo()
    batch = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, ell=3,
                                                 dtype=torch.float32, device="cpu")
    w = torch.randn(D)
    before = (sparse_gather.launches, sparse_gather.chunk_launches)
    ell = (batch.ell_vals, batch.ell_cols)
    tail = (batch.values, batch.col_indices, batch.row_ids, batch.row_ptr)
    # a CPU tensor takes the plain version, launches nothing
    torch.testing.assert_close(sparse_gather.gather_sum(w, N, ell=ell, tail=tail),
                               sparse_gather.gather_sum_reference(w, N, ell=ell, tail=tail))
    # the launcher itself takes CUDA tensors only and raises on CPU ones
    with pytest.raises(ValueError, match="CUDA"):
        sparse_gather._launch(w, N, ell, tail, None)
    assert (sparse_gather.launches, sparse_gather.chunk_launches) == before
    assert sparse_gather.SEGMENT_CHUNK == 2048
    src = (REPO / "photon_ml_torch" / "csrc" / "sparse_gather.cu").read_text()
    assert f"kChunk = {sparse_gather.SEGMENT_CHUNK};" in src


@pytest.mark.parametrize("width,itemsize,vals_ptr,cols_ptr,plan", [
    (0, 4, 0, 0, (32, 1)),          # no ELL block: a warp a row for the tail
    (36, 4, 0, 0, (16, 4)),         # 144-byte rows: 16-byte loads, 9 vectors
    (36, 2, 0, 0, (16, 4)),         # bf16 72-byte rows: 8-byte value loads
    (36, 2, 72, 144, (16, 4)),      # from row 1 of that block: 8-aligned, not 16
    (18, 2, 36, 72, (16, 2)),       # bf16 rows 36 bytes apart: 4-byte loads
    (35, 4, 0, 0, (16, 1)),         # odd width: scalar loads
    (3, 4, 0, 0, (4, 1)),
    (1, 2, 0, 0, (4, 1)),
    (16, 4, 0, 0, (4, 4)),          # four vectors: four lanes
    (32, 4, 0, 0, (8, 4)),
    (8, 4, 4, 0, (8, 1)),           # values aligned to 4 bytes only
    (64, 4, 8, 0, (16, 2)),         # values aligned to 8 bytes only
])
def test_ell_plan(width, itemsize, vals_ptr, cols_ptr, plan):
    """The row kernel's lanes a row and entries a vector load, from the ELL
    width and where the arrays start."""
    assert sparse_gather.ell_plan(width, vals_ptr, cols_ptr, itemsize) == plan
    lanes, vec = plan
    assert width % vec == 0 and 32 % lanes == 0
    assert vals_ptr % (vec * itemsize) == 0 and cols_ptr % (vec * 4) == 0
    src = (REPO / "photon_ml_torch" / "csrc" / "sparse_gather.cu").read_text()
    assert f"PHOTON_ROWS({lanes}, {vec})" in src  # the kernel is built for that plan


def segment_runs(row_ptr, long_rows=None):
    """The segment kernel's walk (``gather_segments_kernel`` in
    csrc/sparse_gather.cu), on the host (numpy arrays in, lists out): for
    each run of ``RUN_SEGMENTS`` consecutive rows, the stretches of rows
    between the long rows of the chunk plan (which take the sum of their
    partials and are not staged), and for each stretch the pieces of at
    most ``PIECE`` entries it stages, in order. Returns ``[(run,
    [(first_row, end_row, [(begin, end), ...]), ...]), ...]``; the kernel
    adds each row's staged entries in that order. (A run whose rows hold at
    most one entry each is not staged: each lane adds its own entry, the
    same sum.)"""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = len(row_ptr) - 1
    chunked = np.zeros(n, dtype=bool)
    if long_rows is not None:
        chunked[np.asarray(long_rows)] = True
    out = []
    for run in range(-(-n // sparse_gather.RUN_SEGMENTS)):
        r0, r1 = run * sparse_gather.RUN_SEGMENTS, min(n, (run + 1) * sparse_gather.RUN_SEGMENTS)
        stretches, lo = [], r0
        while lo < r0 + sparse_gather.RUN_SEGMENTS:
            hi = lo
            while hi < r0 + sparse_gather.RUN_SEGMENTS and not (hi < r1 and chunked[hi]):
                hi += 1
            if hi > lo:
                sb, se = row_ptr[min(lo, n)], row_ptr[min(hi, n)]
                stretches.append((lo, min(hi, r1), [(p, min(p + sparse_gather.PIECE, se))
                                                    for p in range(sb, se, sparse_gather.PIECE)]))
            lo = hi + 1
        out.append((run, stretches))
    return out


def _fmaf(a, b, c):
    """fmaf in f32, emulated: the f64 product of two f32 values is exact."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _xor_butterfly(lanes):
    """A warp's xor-shuffle sum (offsets 16, 8, 4, 2, 1) of 32 f32 values:
    every lane ends with the same value; returns it."""
    v = np.asarray(lanes, dtype=np.float32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(np.float32)
    assert np.all(v == v[0])
    return v[0]


#: threads of the chunk kernel's block (kChunkThreads in the CUDA source)
CHUNK_THREADS = 64


def warp_find(a, size, key):
    """``warp_find`` of csrc/sparse_gather.cu: the last index i < size with
    a[i] <= key (a ascending, a[0] <= key), 32 probes a step. Returns (index,
    steps)."""
    lo, hi, steps = 0, size, 0
    while hi - lo > 1:
        step = (hi - lo + 31) >> 5
        hits = [lane for lane in range(32) if lo + lane * step < hi and a[lo + lane * step] <= key]
        lo += hits[-1] * step
        hi = min(hi, lo + step)
        steps += 1
    return lo, steps


def chunk_walk(begin, end, vec, chunk=None):
    """``chunk_dot`` of csrc/sparse_gather.cu for one chunk [begin, end): for
    each thread of the block, the entries it adds, in its order (a head
    entry before the first index that is a multiple of ``vec``, its vectors
    t, t + CHUNK_THREADS, ... of ``vec`` entries, a tail entry past the last
    whole vector)."""
    chunk = sparse_gather.SEGMENT_CHUNK if chunk is None else chunk
    per_thread = -(-chunk // (vec * CHUNK_THREADS))  # kChunkVecs (exact at the kernel's sizes)
    walk = [[] for _ in range(CHUNK_THREADS)]
    head = (vec - begin % vec) % vec
    a = min(begin + head, end)
    for t in range(min(head, end - begin)):
        walk[t].append(begin + t)
    nv = (end - a) // vec
    for t in range(CHUNK_THREADS):
        for b in range(per_thread):
            v = t + b * CHUNK_THREADS
            if v < nv:
                walk[t].extend(range(a + v * vec, a + (v + 1) * vec))
    for t in range(end - a - nv * vec):
        walk[t].append(a + nv * vec + t)
    return walk


def chunk_partial(terms_of, begin, end, vec, chunk=None):
    """The chunk kernel's f32 partial of [begin, end): each thread's fmaf
    chain over its walk, each warp's xor butterfly, the warps in order.
    ``terms_of(k)`` gives entry k's (value, gathered) pair."""
    sums = []
    for t, entries in enumerate(chunk_walk(begin, end, vec, chunk)):
        acc = np.float32(0)
        for k in entries:
            acc = _fmaf(*terms_of(k), acc)
        sums.append(acc)
    total = np.float32(0)
    for q in range(CHUNK_THREADS // 32):
        total = np.float32(total + _xor_butterfly(sums[32 * q:32 * q + 32]))
    return total


def long_row_sum(partials):
    """``row_partials`` of csrc/sparse_gather.cu: lane l adds partials l, l +
    32, ... from 0, then the warp's xor butterfly."""
    lanes = [np.float32(0)] * 32
    for c, p in enumerate(partials):
        lanes[c % 32] = np.float32(lanes[c % 32] + np.float32(p))
    return _xor_butterfly(lanes)


def _segment_kernel_sums(vals, rows, col_ptr, chunks, r, vec=4):
    """The segment kernel's sums, emulated on the host along
    :func:`segment_runs`: each staged row (column) adds its entries in entry
    order with fmaf from 0; a long row of the chunk plan adds its chunk
    kernel partials (:func:`chunk_partial`, chunks of ``SEGMENT_CHUNK``
    entries) as :func:`long_row_sum` does. Also returns each row's visited
    entries, in the order visited."""
    d = len(col_ptr) - 1
    out = np.zeros(d, dtype=np.float32)
    seen = [[] for _ in range(d)]
    long_rows = None if chunks is None else chunks.rows.numpy()
    terms_of = lambda k: (vals[k], r[rows[k]])  # noqa: E731
    for j in [] if long_rows is None else long_rows:
        parts = []
        for c0 in range(col_ptr[j], col_ptr[j + 1], sparse_gather.SEGMENT_CHUNK):
            c1 = min(c0 + sparse_gather.SEGMENT_CHUNK, col_ptr[j + 1])
            parts.append(chunk_partial(terms_of, c0, c1, vec))
            seen[j].extend(sorted(k for w in chunk_walk(c0, c1, vec) for k in w))
        out[j] = long_row_sum(parts)
    for _, stretches in segment_runs(col_ptr, long_rows):
        for first, end, pieces in stretches:
            for p0, p1 in pieces:
                for j in range(first, end):
                    for k in range(max(col_ptr[j], p0), min(col_ptr[j + 1], p1)):
                        out[j] = _fmaf(vals[k], r[rows[k]], out[j])
                        seen[j].append(k)
    return out, seen


@pytest.mark.parametrize("piece,chunk", [(64, 2048), (8, 16), (4, 6)],
                         ids=["kernel_sizes", "small_pieces", "chunked"])
@pytest.mark.parametrize("layout", ["ell", "flat", "hybrid"])
def test_segment_kernel_walk_covers_each_entry_once_in_order(monkeypatch, layout, piece, chunk):
    """The segment kernel's walk over a batch's column-sorted plan (runs of
    32 columns, stretches between chunked columns, pieces of PIECE entries;
    shrunk here so a small fixture has many pieces and chunked columns, whose
    chunks the chunk kernel's walk covers) visits every entry of the plan
    once, each column's entries in their order; the f32 sums it gives
    (entry order for a staged column, the chunk kernel's and the consumer's
    order for a chunked one) equal the gather's plain
    version and, on the same numpy fixture, the JAX package's
    ``sparse_column_sum``, within 1e-5·Σ|v·r| per column."""
    monkeypatch.setattr(sparse_gather, "PIECE", piece)
    monkeypatch.setattr(sparse_gather, "SEGMENT_CHUNK", chunk)
    rows, cols, vals, labels, offsets, weights = coo(seed=6, d=200)
    kw = LAYOUTS[layout if layout != "ell" else "ell_auto"]
    port = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=200,
                                                dtype=torch.float32, device="cpu",
                                                **_policy(tsb, kw))
    ref = jsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=200,
                                               dtype=np.float32, **_policy(jsb, kw))
    t_vals, t_rows, col_ptr, chunks = (a.numpy() if isinstance(a, torch.Tensor) else a
                                       for a in tsb.transpose_plan(port))
    if chunk < 2048 and layout != "hybrid":  # the head holds the long columns
        assert chunks is not None and chunks.count > 0
    r = np.random.default_rng(3).uniform(0.1, 1.0, size=N).astype(np.float32)
    got, seen = _segment_kernel_sums(t_vals, t_rows, col_ptr, chunks, r)
    for j in range(200):
        assert seen[j] == list(range(col_ptr[j], col_ptr[j + 1])), j
    assert sum(map(len, seen)) == len(t_vals)
    scale = np.zeros(200)
    np.add.at(scale, np.repeat(np.arange(200), np.diff(col_ptr)),
              np.abs(t_vals.astype(np.float64) * r[t_rows]))
    plain = sparse_gather.gather_sum_reference(
        torch.from_numpy(r).double(), 200,
        tail=(torch.from_numpy(t_vals).double(), torch.from_numpy(t_rows), None,
              torch.from_numpy(col_ptr))).numpy()
    assert np.all(np.abs(got - plain) <= 1e-5 * scale + 1e-30)
    # the JAX function: the tail's column sums (the hybrid head is not in the plan)
    jax_batch = ref.replace(hot_vals=None, hot_col_ids=None) if port.has_hybrid_view else ref
    want = np.asarray(jsb.sparse_column_sum(jax_batch, jnp.asarray(r)))
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6)


def test_segment_runs_split_at_chunked_columns():
    """Runs of RUN_SEGMENTS columns; a long column of the chunk plan ends a
    stretch and is in none; a last run that is not full ends at d; empty
    stretches stage nothing."""
    col_ptr = np.r_[0, np.cumsum([3, 0, 5000, 1, 0] + [2] * 30)]
    _, plan = sparse_gather.segment_plan(
        torch.from_numpy(np.repeat(np.arange(35), np.diff(col_ptr)).astype(np.int32)), 35)
    assert plan.rows.tolist() == [2] and plan.chunk_ptr.tolist() == [0, 3] and plan.count == 3
    runs = segment_runs(col_ptr, plan.rows.numpy())
    assert [r for r, _ in runs] == [0, 1]
    (first, end0, p0), (second, end1, p1) = runs[0][1]
    assert (first, end0) == (0, 2) and p0 == [(0, 3)]
    assert (second, end1) == (3, 32) and p1 == [(col_ptr[3], col_ptr[32])]
    assert runs[1][1] == [(32, 35, [(col_ptr[32], col_ptr[35])])]
    assert segment_runs(np.zeros(40, np.int64))[0][1][0][2] == []
    # a stretch longer than a piece: pieces of PIECE entries, the last short
    long = segment_runs(np.r_[0, 150, 151])[0][1]
    assert long == [(0, 2, [(0, 64), (64, 128), (128, 151)])]
    src = (REPO / "photon_ml_torch" / "csrc" / "sparse_gather.cu").read_text()
    assert f"kRunSegments = {sparse_gather.RUN_SEGMENTS};" in src
    assert f"kPiece = {sparse_gather.PIECE};" in src


def _rows_for_plan():
    """Row lengths around the chunk size (K - 1, K, K + 1, 3K + 5 and
    longer), empty rows among them, and short rows of 1-3 entries before
    each long one so that long rows start at every alignment mod 4."""
    k = sparse_gather.SEGMENT_CHUNK
    lengths = []
    for shift, long_len in zip(range(8), (k - 1, k, k + 1, 3 * k + 5, k + 1, 2 * k, 5 * k + 3,
                                          k + 2)):
        lengths += [shift % 4, 0, long_len, 0, 7]
    return np.asarray(lengths)


def test_chunk_plan_lists_long_rows_only():
    """segment_plan's chunk plan: exactly the rows of more than
    SEGMENT_CHUNK entries, in order, each with ceil(len / SEGMENT_CHUNK)
    chunks; nothing [n]-sized; None when no row is long; the source's sizes
    are the wrapper's."""
    k = sparse_gather.SEGMENT_CHUNK
    lengths = _rows_for_plan()
    row_ids = torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths).astype(np.int32))
    row_ptr, plan = sparse_gather.segment_plan(row_ids, len(lengths))
    assert row_ptr.tolist() == np.r_[0, np.cumsum(lengths)].tolist()
    want_rows = np.flatnonzero(lengths > k)
    assert plan.rows.dtype == torch.int32 and plan.chunk_ptr.dtype == torch.int32
    assert plan.rows.tolist() == want_rows.tolist()
    per = -(-lengths[want_rows] // k)
    assert plan.chunk_ptr.tolist() == np.r_[0, np.cumsum(per)].tolist() and plan.count == per.sum()
    assert plan.nbytes() == 4 * (2 * len(want_rows) + 1)
    assert {lengths[r] for r in want_rows} >= {k + 1, 3 * k + 5} and k not in lengths[want_rows]
    assert {int(row_ptr[r]) % 4 for r in want_rows} == {0, 1, 2, 3}
    short = torch.from_numpy(np.repeat(np.arange(4), [k, 0, k - 1, 3]).astype(np.int32))
    assert sparse_gather.segment_plan(short, 4)[1] is None
    assert sparse_gather.segment_plan(torch.zeros(0, dtype=torch.int32), 3)[1] is None
    src = (REPO / "photon_ml_torch" / "csrc" / "sparse_gather.cu").read_text()
    assert f"#define GATHER_CHUNK_THREADS {CHUNK_THREADS}\n" in src
    assert k % (4 * CHUNK_THREADS) == 0  # every thread loads whole vectors


@pytest.mark.parametrize("size", [1, 2, 31, 32, 33, 256, 1025, 40000])
def test_warp_find_is_the_last_entry_at_most_the_key(size):
    """The kernels' search of the plan (32 probes a step) against bisect,
    at every key of a random ascending array: two steps up to 1024 rows."""
    import bisect

    a = np.cumsum(np.random.default_rng(size).integers(1, 5, size=size)) - 1
    keys = np.unique(np.r_[a, a + 1, a[-1] + 10])
    for key in keys[:: max(1, len(keys) // 500)]:
        got, steps = warp_find(a, size, int(key))
        assert got == bisect.bisect_right(a, key) - 1
        assert steps <= (0 if size == 1 else 1 if size <= 32 else 2 if size <= 1024 else 4)


@pytest.mark.parametrize("vec", [4, 1], ids=["vectors", "scalar"])
def test_chunk_kernel_walk_covers_each_entry_once_in_order(vec):
    """The chunk kernel's walk over the plan of rows around the chunk size,
    starting at every alignment mod 4: chunk c finds its row with
    warp_find; the chunks of a long row cover its entries once and in
    order; inside a chunk each entry is one thread's, each thread's
    entries ascend, a thread takes at most one head and one tail entry and
    its vectors start at multiples of 4; and the f32 sums in the kernel's
    order (chunk partials, then the consumer's lanes) are within 1e-6 of
    the f64 row sums relative to Σ|v·w|."""
    k = sparse_gather.SEGMENT_CHUNK
    lengths = _rows_for_plan()
    row_ptr, plan = sparse_gather.segment_plan(
        torch.from_numpy(np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)),
        len(lengths))
    row_ptr, rows, chunk_ptr = (t.numpy().astype(np.int64) for t in (row_ptr, *plan[:2]))
    rng = np.random.default_rng(4)
    vals = rng.normal(size=row_ptr[-1]).astype(np.float32)
    wv = rng.normal(size=row_ptr[-1]).astype(np.float32)  # the gathered w of each entry
    covered = {int(r): [] for r in rows}
    partials = []
    for c in range(plan.count):
        r, _ = warp_find(chunk_ptr, len(rows), c)
        row = rows[r]
        begin = row_ptr[row] + (c - chunk_ptr[r]) * k
        end = min(begin + k, row_ptr[row + 1])
        walk = chunk_walk(begin, end, vec)
        for t, entries in enumerate(walk):
            assert entries == sorted(entries)
            if vec == 4:
                a = min(begin + (4 - begin % 4) % 4, end)
                body_end = a + (end - a) // 4 * 4
                body = [e for e in entries if a <= e < body_end]
                assert all(body[i:i + 4] == list(range(body[i], body[i] + 4)) and body[i] % 4 == 0
                           for i in range(0, len(body), 4))
                assert sum(e < a for e in entries) <= 1 and sum(e >= body_end for e in entries) <= 1
        flat = sorted(e for entries in walk for e in entries)
        assert flat == list(range(begin, end))
        covered[int(row)].extend(flat)
        partials.append(chunk_partial(lambda e: (vals[e], wv[e]), begin, end, vec))
    for r, row in enumerate(rows):
        assert covered[int(row)] == list(range(row_ptr[row], row_ptr[row + 1]))
        got = long_row_sum(partials[chunk_ptr[r]:chunk_ptr[r + 1]])
        lo, hi = row_ptr[row], row_ptr[row + 1]
        exact = np.dot(vals[lo:hi].astype(np.float64), wv[lo:hi])
        scale = np.abs(vals[lo:hi].astype(np.float64) * wv[lo:hi]).sum()
        assert abs(float(got) - exact) <= 1e-6 * scale


def test_chunk_partials_plain_version():
    """The chunk kernel's plain version: one sum per chunk of the plan, each
    over SEGMENT_CHUNK entries of its row from the row's start (the last
    chunk to the row's end), in the inputs' dtype; the chunks of a row add
    up to its sum. The launcher refuses CPU tensors (no fallback)."""
    k = sparse_gather.SEGMENT_CHUNK
    lengths = _rows_for_plan()
    n = len(lengths)
    row_ids = torch.from_numpy(np.repeat(np.arange(n), lengths).astype(np.int32))
    row_ptr, plan = sparse_gather.segment_plan(row_ids, n)
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=len(row_ids)))
    cols = torch.from_numpy(rng.integers(0, 300, size=len(row_ids)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=300))
    tail = (vals, cols, row_ids, row_ptr)
    got = sparse_gather.chunk_partials_reference(w, tail, plan)
    assert got.dtype == torch.float64 and got.shape == (plan.count,)
    ptr, prod = row_ptr.numpy(), (vals * w[cols.long()]).numpy()
    want = []
    for row in plan.rows.tolist():
        want += [prod[b:min(b + k, ptr[row + 1])].sum() for b in range(ptr[row], ptr[row + 1], k)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    rows_sum = sparse_gather.gather_sum_reference(w, n, tail=tail)[plan.rows.long()]
    per_row = [got[a:b].sum() for a, b in zip(plan.chunk_ptr[:-1], plan.chunk_ptr[1:])]
    np.testing.assert_allclose(per_row, rows_sum.numpy(), rtol=1e-12, atol=1e-9)
    before = sparse_gather.chunk_launches
    with pytest.raises(ValueError, match="CUDA"):
        sparse_gather.chunk_partials(w.float(), (vals.float(), cols, row_ids, row_ptr), plan)
    assert sparse_gather.chunk_launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_csr_is_the_chunk_kernels_function(dtype):
    """chip_smoke.py's library yardstick for the chunk kernel: a CSR matrix
    whose rows are the plan's chunks (the long rows' entries copied
    contiguous, bf16 values widened) times w gives every chunk's partial,
    equal to the plain version's in f64; its entries are the long rows'
    entries, in order, each once."""
    import chip_smoke

    lengths = _rows_for_plan()
    n = len(lengths)
    row_ids = torch.from_numpy(np.repeat(np.arange(n), lengths).astype(np.int32))
    row_ptr, plan = sparse_gather.segment_plan(row_ids, n)
    rng = np.random.default_rng(6)
    vals = torch.from_numpy(rng.normal(size=len(row_ids)).astype(np.float32)).to(dtype)
    cols = torch.from_numpy(rng.integers(0, 300, size=len(row_ids)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    tail = (vals, cols, row_ids, row_ptr)
    csr, entry = chip_smoke._chunk_csr(torch, tail, plan, w.shape[0])
    ptr = row_ptr.numpy()
    want_entry = np.concatenate([np.arange(ptr[r], ptr[r + 1]) for r in plan.rows.tolist()])
    assert entry.tolist() == want_entry.tolist()
    assert csr.shape == (plan.count, 300) and csr.values().dtype == torch.float32
    wide = torch.sparse_csr_tensor(csr.crow_indices(), csr.col_indices(), csr.values().double(),
                                   csr.shape)
    got = wide @ w.double()
    want = sparse_gather.chunk_partials_reference(w.double(), (vals.double(), *tail[1:]), plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    f32 = csr @ w
    scale = sparse_gather.chunk_partials_reference(w.double().abs(),
                                                   (vals.double().abs(), *tail[1:]), plan)
    assert bool(((f32.double() - want).abs() <= 1e-5 * scale + 1e-30).all())
