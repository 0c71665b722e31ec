"""The port's sparse batch builders against the JAX package's, element for
element, on one numpy COO fixture with duplicates, ragged rows and rows
with no entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.telemetry import default_registry
from photon_ml_torch import convert
from photon_ml_torch.data import sparse_batch as tsb
from photon_ml_torch.ops import sparse_gather

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

N, D = 48, 37
#: rows the fixture leaves empty
EMPTY_ROWS = (0, 5, 11, 12, 47)


def coo(seed=0, n=N, d=D, nnz=420, long_row=7, long_len=40):
    """(rows, cols, vals, labels, offsets, weights): power-law columns,
    duplicate (row, col) pairs, one long row, and the rows of EMPTY_ROWS
    (those that fit in n) with no entries."""
    rng = np.random.default_rng(seed)
    empty = [r for r in EMPTY_ROWS if r < n]
    allowed = np.setdiff1d(np.arange(n), empty)
    rows = rng.choice(allowed, size=nnz)
    cols = (rng.random(nnz) ** 3 * d).astype(np.int64)
    rows[:long_len] = long_row
    vals = rng.normal(size=nnz)
    k, src = nnz // 8, slice(nnz // 3, nnz // 3 + nnz // 8)
    rows[nnz - k:], cols[nnz - k:] = rows[src], cols[src]  # duplicate (row, col) pairs
    labels = (rng.random(n) < 0.5).astype(np.float64)
    offsets = rng.normal(scale=0.1, size=n)
    weights = rng.uniform(0.5, 2.0, size=n)
    weights[::9] = 0.0
    return rows, cols, vals, labels, offsets, weights


def _eq(port, ref, what=""):
    p = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    np.testing.assert_array_equal(p, r.astype(p.dtype) if r.dtype != p.dtype else r,
                                  err_msg=what)


def _coalesced(seed=0):
    rows, cols, vals, *_ = coo(seed)
    return jsb.coalesce_coo(rows, cols, vals)


def test_coalesce_matches():
    rows, cols, vals, *_ = coo()
    got, want = tsb.coalesce_coo(rows, cols, vals), jsb.coalesce_coo(rows, cols, vals)
    for g, w in zip(got, want):
        _eq(g, w)
    assert len(got[2]) < len(vals)  # the fixture has duplicates
    empty = np.zeros(0, np.int64)
    assert all(len(a) == 0 for a in tsb.coalesce_coo(empty, empty, np.zeros(0)))


@pytest.mark.parametrize("width", [None, 1, 3, 8, 60])
def test_ell_arrays_match(width):
    r, c, v = _coalesced()
    for g, w in zip(tsb._ell_arrays(r, c, v, N, width), jsb._ell_arrays(r, c, v, N, width)):
        _eq(g, w)


def test_ell_auto_width_rules_match():
    rng = np.random.default_rng(3)
    for n in (1, 7, 50, 333):
        counts = rng.poisson(rng.uniform(0.5, 12), size=n)
        nnz = int(counts.sum())
        assert tsb._ell_auto_width(counts, n, nnz) == jsb._ell_auto_width(counts, n, nnz)
        freq = np.bincount(counts)
        assert tsb._ell_auto_width_from_hist(freq, n, nnz) == \
            jsb._ell_auto_width_from_hist(freq, n, nnz) == tsb._ell_auto_width(counts, n, nnz)
    assert tsb._ell_auto_width(np.zeros(4, np.int64), 4, 0) == 1


@pytest.mark.parametrize("extra", [None, 0, 9])
def test_pad_flat_tail_matches(extra):
    r, c, v = _coalesced()
    _, _, tr, tc, tv = jsb._ell_arrays(r, c, v, N, 3)
    target = None if extra is None else len(tv) + extra
    for g, w in zip(tsb._pad_flat_tail(tr, tc, tv, target),
                    jsb._pad_flat_tail(tr, tc, tv, target)):
        _eq(g, w)
    with pytest.raises(ValueError, match="flat_block_nnz"):
        tsb._pad_flat_tail(tr, tc, tv, len(tv) - 1)


@pytest.mark.parametrize("pad", [0, 13])
def test_column_sorted_arrays_match(pad):
    r, c, v = _coalesced()
    got = tsb._column_sorted_arrays(r, c, v, len(v) + pad, dim=D)
    want = jsb._column_sorted_arrays(r, c, v, len(v) + pad, dim=D)
    assert sorted(got) == sorted(want)
    for k in want:
        _eq(got[k], want[k], k)
    assert "col_bounds" not in tsb._column_sorted_arrays(r, c, v, len(v))


POLICIES = {
    "budget": dict(hot_cols=4, pad_multiple=8),
    "coverage": dict(coverage=0.3, pad_multiple=4),
    "default": dict(),
    "hot_ids": dict(hot_ids=(0, 2, 9, 30), pad_multiple=2),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("pad", [True, False])
def test_hybrid_arrays_match(name, pad):
    r, c, v = _coalesced()
    label = f"torch_parity_{name}_{pad}"
    layout = {}
    got = tsb._hybrid_arrays(r, c, v, N, D, tsb.HybridPolicy(**POLICIES[name], label=label),
                             pad=pad, layout=layout)
    want = jsb._hybrid_arrays(r, c, v, N, D, jsb.HybridPolicy(**POLICIES[name], label=label),
                              pad=pad)
    for g, w in zip(got, want):
        _eq(g, w)
    reg = default_registry()
    for key in ("k_hot", "k_hot_padded", "hot_nnz", "hot_coverage", "tail_nnz"):
        assert layout[key] == reg.gauge(f"layout/{label}/{key}").value, key


def test_rank_hot_columns_ties_match():
    uniq = np.array([1, 3, 4, 8, 10, 11, 20])
    cnt = np.array([5, 7, 5, 7, 2, 5, 7])
    nnz = int(cnt.sum())
    for kw in (dict(hot_cols=1), dict(hot_cols=2), dict(hot_cols=4), dict(coverage=0.5),
               dict(coverage=1.0), dict(hot_cols=3, max_hot_cols=2)):
        _eq(tsb.rank_hot_columns(uniq, cnt, nnz, tsb.HybridPolicy(**kw)),
            jsb.rank_hot_columns(uniq, cnt, nnz, jsb.HybridPolicy(**kw)), str(kw))
    assert len(tsb.rank_hot_columns(uniq[:0], cnt[:0], 0, tsb.HybridPolicy())) == 0
    r, c, v = _coalesced()
    for kw in (dict(hot_cols=3), dict(hot_ids=(2, 5))):
        assert tsb._select_hot_columns(c, len(c), tsb.HybridPolicy(**kw))[1] == \
            jsb._select_hot_columns(c, len(c), jsb.HybridPolicy(**kw))[1]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("coalesced", [False, True])
def test_summarize_sparse_matches(weighted, coalesced):
    rows, cols, vals, _, _, weights = coo()
    if coalesced:
        rows, cols, vals = jsb.coalesce_coo(rows, cols, vals)
    kw = dict(n=N, dim=D, weights=weights if weighted else None, assume_coalesced=coalesced)
    got, want = tsb.summarize_sparse(rows, cols, vals, **kw), \
        jsb.summarize_sparse(rows, cols, vals, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


FIELDS = ("values", "col_indices", "row_ids", "labels", "offsets", "weights", "vals_by_col",
          "rows_by_col", "cols_sorted", "col_bounds", "ell_vals", "ell_cols", "hot_vals",
          "hot_col_ids")

LAYOUTS = {
    "flat": dict(ell=False),
    "flat_padded": dict(ell=False, pad_nnz_to=512),
    "ell_auto": dict(),
    "ell_3": dict(ell=3),
    "ell_3_padded": dict(ell=3, pad_nnz_to=300),
    "column_sorted": dict(column_sorted_gradient=True),
    "column_sorted_padded": dict(column_sorted_gradient=True, pad_nnz_to=512),
    "hybrid": dict(hybrid=dict(hot_cols=4, pad_multiple=8)),
    "hybrid_flat_tail": dict(ell=False, hybrid=dict(coverage=0.4, pad_multiple=4)),
}


def _policy(mod, kw):
    kw = dict(kw)
    if isinstance(kw.get("hybrid"), dict):
        kw["hybrid"] = mod.HybridPolicy(**kw["hybrid"])
    return kw


def assert_same_batch(port, ref):
    assert port.dim == ref.dim
    for name in FIELDS:
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is not None:
            _eq(p, r, name)
    row_ids = np.asarray(ref.row_ids)
    _eq(port.row_ptr, np.searchsorted(row_ids, np.arange(port.num_samples + 1)), "row_ptr")


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_from_coo_matches(name):
    rows, cols, vals, labels, offsets, weights = coo()
    kw = LAYOUTS[name]
    port = tsb.SparseLabeledPointBatch.from_coo(
        rows, cols, vals, labels, dim=D, offsets=offsets, weights=weights,
        dtype=torch.float64, device="cpu", **_policy(tsb, kw))
    ref = jsb.SparseLabeledPointBatch.from_coo(
        rows, cols, vals, labels, dim=D, offsets=offsets, weights=weights,
        dtype=np.float64, **_policy(jsb, kw))
    assert_same_batch(port, ref)
    assert port.has_ell_view == ref.has_ell_view
    assert port.has_hybrid_view == ref.has_hybrid_view
    assert port.has_column_sorted_view == ref.has_column_sorted_view
    assert port.nnz == ref.nnz and port.num_samples == ref.num_samples
    assert (port.layout is not None) == port.has_hybrid_view


def _shards(**kw):
    rows, cols, vals, *_ = coo()

    def shard(mod):
        extra = dict(kw)
        if "hybrid_policy" in extra:
            extra["hybrid_policy"] = mod.HybridPolicy(**extra["hybrid_policy"])
        return mod.SparseShard(rows=rows.copy(), cols=cols.copy(), vals=vals.copy(),
                               num_samples=N, feature_dim=D, **extra)

    return shard(tsb), shard(jsb)


SHARD_CASES = {
    "ell_auto": ({}, {}),
    "ell_width_block": (dict(ell_width=4, flat_block_nnz=400), {}),
    "flat": ({}, dict(ell=False)),
    "column_sorted": ({}, dict(column_sorted_gradient=True)),
    "hybrid_inherited": (dict(hybrid_policy=dict(hot_cols=5, pad_multiple=4)), {}),
    "hybrid_off": (dict(hybrid_policy=dict(hot_cols=5)), dict(hybrid=False)),
    "hybrid_ell_width": (dict(ell_width=2, flat_block_nnz=300), dict(hybrid=dict(hot_cols=3))),
}


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_from_shard_matches(name):
    shard_kw, build_kw = SHARD_CASES[name]
    ts, js = _shards(**shard_kw)
    _, _, _, labels, offsets, weights = coo()
    port = tsb.SparseLabeledPointBatch.from_shard(ts, labels, offsets, weights, device="cpu",
                                                  **_policy(tsb, build_kw))
    ref = jsb.SparseLabeledPointBatch.from_shard(js, jnp.asarray(labels), jnp.asarray(offsets),
                                                 jnp.asarray(weights), **_policy(jsb, build_kw))
    assert_same_batch(port, ref)
    if name == "ell_width_block":
        assert port.ell_vals.shape == (N, 4) and port.nnz == 400
    # the hybrid split is cached on the shard and reused
    if port.has_hybrid_view:
        again = tsb.SparseLabeledPointBatch.from_shard(ts, labels, offsets, weights,
                                                       device="cpu", **_policy(tsb, build_kw))
        assert torch.equal(again.hot_vals, port.hot_vals) and again.layout == port.layout


@pytest.mark.parametrize("name", ["flat", "column_sorted", "ell_3"])
def test_pad_nnz_matches(name):
    rows, cols, vals, labels, offsets, weights = coo()
    kw = LAYOUTS[name]
    port = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, offsets=offsets,
                                                weights=weights, dtype=torch.float64,
                                                device="cpu", **kw)
    ref = jsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, offsets=offsets,
                                               weights=weights, dtype=np.float64, **kw)
    target = port.nnz + 17
    assert_same_batch(port.pad_nnz(target), ref.pad_nnz(target))
    assert port.pad_nnz(port.nnz) is port
    with pytest.raises(ValueError):
        port.pad_nnz(port.nnz - 1)


def test_row_pointers_and_chunk_plan(monkeypatch):
    rows, cols, vals, labels, *_ = coo()
    batch = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, ell=False,
                                                 dtype=torch.float64, device="cpu")
    assert batch.row_chunks is None  # no row is longer than one chunk
    lens = np.diff(batch.row_ptr.numpy())
    assert all(lens[r] == 0 for r in EMPTY_ROWS)
    monkeypatch.setattr(sparse_gather, "SEGMENT_CHUNK", 8)
    row_ptr, plan = sparse_gather.segment_plan(batch.row_ids, N)
    _eq(row_ptr, batch.row_ptr)
    per_row = np.where(lens > 8, -(-lens // 8), 0)  # rows of 8 entries or fewer: none
    assert per_row.sum() > 0 and (per_row == 0).sum() > len(EMPTY_ROWS)
    # the plan lists the long rows alone, with where their chunks start
    long_rows = np.flatnonzero(per_row)
    _eq(plan.rows, long_rows)
    _eq(plan.chunk_ptr, np.concatenate([[0], np.cumsum(per_row[long_rows])]))
    assert plan.count == per_row.sum()
    assert plan.rows.dtype == plan.chunk_ptr.dtype == row_ptr.dtype == torch.int32


def test_shard_device_matvec_matches():
    rows, cols, vals, *_ = coo()
    ts, js = _shards()
    w = np.random.default_rng(4).normal(size=D)
    dev = ts.device("cpu")
    assert ts.device("cpu") is dev  # built once per device
    got = dev.matvec(torch.from_numpy(w))
    want = js.device().matvec(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), sparse_gather.gather_sum_reference(
        torch.from_numpy(w), N, tail=(dev.values, dev.col_indices, dev.row_ids, dev.row_ptr)),
        rtol=0, atol=0)
    assert ts.dtype == torch.float64 and ts.shape == (N, D) and ts.nnz == len(vals)
    for k in ("mean", "variance", "max"):
        np.testing.assert_array_equal(ts.summarize()[k], js.summarize()[k])


def test_batch_lifecycle():
    rows, cols, vals, labels, offsets, weights = coo()
    b = convert.sparse_batch_from_numpy(rows, cols, vals, labels, dim=D, offsets=offsets,
                                        weights=weights, device="cpu")
    assert b.dtype == torch.float64 and b.solve_dtype == torch.float64
    scores = torch.ones(N, dtype=torch.float64)
    b2 = b.add_scores_to_offsets(scores)
    _eq(b2.offsets, offsets + 1.0)
    assert b2.row_ptr is b.row_ptr  # the row pointers carry over, not rebuilt
    assert b.with_offsets(b2.offsets).offsets is b2.offsets
    b16 = convert.sparse_batch_from_numpy(rows, cols, vals, labels, dim=D,
                                          dtype=torch.bfloat16, device="cpu")
    assert b16.ell_vals.dtype == torch.bfloat16 and b16.labels.dtype == torch.float32
    assert b16.solve_dtype == torch.float32


def test_replace_rebuilds_row_pointers(monkeypatch):
    rows, cols, vals, labels, *_ = coo()
    b = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D, ell=False,
                                             dtype=torch.float64, device="cpu")
    # every entry moves to the last row: the row pointers and chunk plan follow
    monkeypatch.setattr(sparse_gather, "SEGMENT_CHUNK", 8)
    moved = b.replace(row_ids=torch.full_like(b.row_ids, N - 1))
    _eq(moved.row_ptr, np.r_[np.zeros(N, np.int64), b.nnz])
    plan = moved.row_chunks
    _eq(plan.rows, [N - 1])
    _eq(plan.chunk_ptr, [0, -(-b.nnz // 8)])
    assert plan.count == -(-b.nnz // 8)
    # fewer entries: rebuilt from the new arrays, not carried over
    half = b.nnz // 2
    cut = b.replace(values=b.values[:half], col_indices=b.col_indices[:half],
                    row_ids=b.row_ids[:half])
    _eq(cut.row_ptr, np.searchsorted(b.row_ids[:half].numpy(), np.arange(N + 1)))
    # given explicitly, or untouched by the change, the row pointers carry over
    assert b.replace(row_ids=b.row_ids.clone(), row_ptr=b.row_ptr).row_ptr is b.row_ptr
    assert b.replace(weights=b.weights * 2).row_ptr is b.row_ptr


def test_rejections():
    rows, cols, vals, labels, *_ = coo()
    build = tsb.SparseLabeledPointBatch.from_coo
    with pytest.raises(ValueError, match="column index"):
        build(rows, cols, vals, labels, dim=3, device="cpu")
    with pytest.raises(ValueError, match="negative"):
        build(rows - 100, cols, vals, labels, dim=D, device="cpu")
    with pytest.raises(ValueError, match="row index"):
        build(rows, cols, vals, labels[:5], dim=D, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        build(rows, cols, vals, labels, dim=2**31, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        build(rows, cols, vals, labels, dim=D, hybrid=True, column_sorted_gradient=True,
              device="cpu")
    with pytest.raises(ValueError, match="float32, float64 or bfloat16"):
        build(rows, cols, vals, labels, dim=D, dtype=torch.int32, device="cpu")
    for bad in (dict(hot_cols=0), dict(coverage=1.5), dict(hot_cols=2, coverage=0.5),
                dict(pad_multiple=0), dict(hot_ids=()), dict(hot_ids=(3, 1))):
        with pytest.raises(ValueError):
            tsb.HybridPolicy(**bad)
    assert tsb.resolve_hybrid_policy(None) is None and tsb.resolve_hybrid_policy(False) is None
    assert tsb.resolve_hybrid_policy(True) == tsb.HybridPolicy()
    with pytest.raises(TypeError):
        tsb.resolve_hybrid_policy("yes")
    ts, _ = _shards()
    with pytest.raises(ValueError, match="mutually exclusive"):
        tsb.SparseLabeledPointBatch.from_shard(ts, labels, labels, labels, hybrid=True,
                                               column_sorted_gradient=True, device="cpu")
    assert not ts.rows.flags.writeable


@pytest.mark.parametrize("layout", ["ell", "flat", "hybrid"])
@pytest.mark.parametrize("square", [False, True])
def test_column_sum_through_the_transpose_plan(layout, square):
    """The transpose through the gather over the column-sorted plan (pad
    slots and zero entries left out) equals the plain ``index_add_`` of
    every entry, and ``replace`` keeps the plan only while the entries stay."""
    rows, cols, vals, labels, offsets, weights = coo(seed=4)
    kw = dict(ell=False) if layout == "flat" else {}
    if layout == "hybrid":
        kw = dict(hybrid=tsb.HybridPolicy(hot_cols=4))
    batch = tsb.SparseLabeledPointBatch.from_coo(rows, cols, vals, labels, dim=D,
                                                 offsets=offsets, weights=weights,
                                                 dtype=torch.float64, device="cpu", **kw)
    assert batch.has_ell_view == (layout != "flat")
    r = torch.from_numpy(np.random.default_rng(5).normal(size=N))
    got = tsb.sparse_column_sum(batch, r, square)
    want = tsb.sparse_column_sum(batch, r, square, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    plan = batch.__dict__["_transpose_plan"]
    # (vals, rows, col_ptr, chunks): no per-entry column ids are kept
    assert len(plan) == 4 and plan[2].shape == (D + 1,) and plan[0].shape == plan[1].shape
    assert int((plan[0] == 0).sum()) == 0 and bool((plan[2][1:] >= plan[2][:-1]).all())
    assert batch.with_offsets(batch.offsets + 1).__dict__["_transpose_plan"] is plan
    assert "_transpose_plan" not in batch.replace(values=batch.values * 2).__dict__
