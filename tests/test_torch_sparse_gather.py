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


def segment_runs(row_ptr, chunk_ptr=None):
    """The segment kernel's walk (``gather_segments_kernel`` in
    csrc/sparse_gather.cu), on the host (numpy arrays in, lists out): for
    each run of ``RUN_SEGMENTS`` consecutive rows, the stretches of rows
    between rows with chunks (which add their partials and are not staged),
    and for each stretch the pieces of at most ``PIECE`` entries it stages,
    in order. Returns ``[(run, [(first_row, end_row, [(begin, end), ...]),
    ...]), ...]``; the kernel adds each row's staged entries in that order.
    (A run whose rows hold at most one entry each is not staged: each lane
    adds its own entry, the same sum.)"""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n = len(row_ptr) - 1
    chunked = np.zeros(n, dtype=bool)
    if chunk_ptr is not None:
        chunk_ptr = np.asarray(chunk_ptr, dtype=np.int64)
        chunked = chunk_ptr[1:] > chunk_ptr[:-1]
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


def _segment_kernel_sums(vals, rows, col_ptr, chunk_ptr, r):
    """The segment kernel's sums, emulated on the host along
    :func:`segment_runs`: each staged row (column) adds its
    entries in entry order with fmaf from 0; a row with chunks adds one f32
    sum per chunk of ``SEGMENT_CHUNK`` entries, in chunk order. Also
    returns each row's visited entries, in the order visited."""
    d = len(col_ptr) - 1
    out = np.zeros(d, dtype=np.float32)
    seen = [[] for _ in range(d)]
    chunked = np.zeros(d, bool) if chunk_ptr is None else chunk_ptr[1:] > chunk_ptr[:-1]
    for j in np.flatnonzero(chunked):
        acc = np.float32(0)
        for c0 in range(col_ptr[j], col_ptr[j + 1], sparse_gather.SEGMENT_CHUNK):
            c1 = min(c0 + sparse_gather.SEGMENT_CHUNK, col_ptr[j + 1])
            acc = np.float32(acc + np.float32(np.dot(vals[c0:c1].astype(np.float64),
                                                      r[rows[c0:c1]].astype(np.float64))))
            seen[j].extend(range(c0, c1))
        out[j] = acc
    for _, stretches in segment_runs(col_ptr, chunk_ptr):
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
    shrunk here so a small fixture has many pieces and chunked columns)
    visits every entry of the plan once, each column's entries in their
    order; the column-ordered f32 sums it gives equal the gather's plain
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
    chunk_ptr = None if chunks is None else chunks[1].numpy()
    if chunk < 2048 and layout != "hybrid":  # the head holds the long columns
        assert chunk_ptr is not None and (chunk_ptr[1:] > chunk_ptr[:-1]).any()
    r = np.random.default_rng(3).uniform(0.1, 1.0, size=N).astype(np.float32)
    got, seen = _segment_kernel_sums(t_vals, t_rows, col_ptr, chunk_ptr, r)
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
    """Runs of RUN_SEGMENTS columns; a chunked column ends a stretch and is
    in none; a last run that is not full ends at d; empty stretches stage
    nothing."""
    col_ptr = np.r_[0, np.cumsum([3, 0, 5000, 1, 0] + [2] * 30)]
    chunk_ptr = np.r_[0, np.cumsum([0, 0, 3, 0, 0] + [0] * 30)]
    runs = segment_runs(col_ptr, chunk_ptr)
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
