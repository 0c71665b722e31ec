"""The port's chunk sources and prefetcher (``photon_ml_torch/io/
stream_reader.py``) against the JAX package's: ``plan_chunks`` and every
chunk's arrays, array for array, for dense in-memory, sparse ELL, sparse
hybrid and Avro sources; prefetch on and off bitwise; the decode thread's
chunks are numpy only; bounded waits."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.sparse_batch import HybridPolicy as JHybrid
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import photon_schemas as jschemas
from photon_ml_tpu.io import stream_reader as jsr
from photon_ml_tpu.io.data_reader import FeatureShardConfiguration as JShardCfg
from photon_ml_torch.data.sparse_batch import HybridPolicy as THybrid
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.io.data_reader import FeatureShardConfiguration as TShardCfg
from tests.torch_driver_parity import make_logistic_records

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

DENSE_FIELDS = ("features", "labels", "offsets", "weights")
SPARSE_FIELDS = ("values", "col_indices", "row_ids", "labels", "offsets", "weights", "ell_vals",
                 "ell_cols", "hot_vals", "hot_col_ids")


def _dense(seed=0, n=103, d=7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)), rng.integers(0, 2, n).astype(float),
            0.1 * rng.normal(size=n), rng.uniform(0.5, 1.5, n))


def _coo(seed=1, n=90, d=40, per_row=5):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    # a few hot columns every row shares, then scattered ones; some duplicates
    cols = np.where(rng.random(n * per_row) < 0.4, rng.integers(0, 3, n * per_row),
                    rng.integers(0, d, n * per_row))
    vals = rng.normal(size=n * per_row)
    return rows, cols, vals, rng.integers(0, 2, n).astype(float), d


def _write_avro(base, n=130, d=9, block_records=17):
    os.makedirs(base, exist_ok=True)
    paths = []
    for part, (lo, seed) in enumerate(((0, 11), (n // 2, 12))):
        path = os.path.join(base, f"part-{part:05d}.avro")
        javro.write_container(path, jschemas.TRAINING_EXAMPLE_AVRO,
                              make_logistic_records(n // 2, d, seed), block_records=block_records)
        paths.append(path)
    return paths


def _chunks(source, prefetch=True):
    with (jsr if isinstance(source, jsr.ChunkSource) else tsr).ChunkPrefetcher(
            source, prefetch=prefetch) as it:
        return list(it)


def test_dense_chunks_match():
    x, y, o, w = _dense()
    j = jsr.ArrayChunkSource(x, y, offsets=o, weights=w, chunk_rows=25)
    t = tsr.ArrayChunkSource(x, y, offsets=o, weights=w, chunk_rows=25)
    assert [(s.index, s.num_records) for s in j.specs] == \
        [(s.index, s.num_records) for s in t.specs]
    assert (t.num_chunks, t.total_records, t.chunk_rows, t.dim) == \
        (j.num_chunks, j.total_records, j.chunk_rows, j.dim)
    for jc, tc in zip(_chunks(j), _chunks(t)):
        for f in DENSE_FIELDS:
            np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
            assert isinstance(getattr(tc, f), np.ndarray)


@pytest.mark.parametrize("hybrid", [None, "policy"], ids=["ell", "hybrid"])
def test_sparse_chunks_match(hybrid):
    rows, cols, vals, y, d = _coo()
    jp = None if hybrid is None else JHybrid(hot_cols=3, pad_multiple=4)
    tp = None if hybrid is None else THybrid(hot_cols=3, pad_multiple=4)
    j = jsr.SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=32, hybrid=jp)
    t = tsr.SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=32, hybrid=tp)
    assert t.ell_width == j.ell_width and t.flat_nnz == j.flat_nnz
    if hybrid is not None:
        assert tuple(t.hybrid_policy.hot_ids) == tuple(j.hybrid_policy.hot_ids)
    for jc, tc in zip(_chunks(j), _chunks(t)):
        batch = tc.to_device("cpu")
        for f in SPARSE_FIELDS:
            jv, tv = getattr(jc, f), getattr(batch, f)
            assert (jv is None) == (tv is None), f
            if jv is not None:
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=f)
        assert batch.dim == jc.dim
        host = [a for a in (tc.host["rows"], tc.host["vals"], *tc.host["extra"].values())]
        assert all(isinstance(a, np.ndarray) for a in host)


def test_avro_plan_and_chunks_match(tmp_path):
    files = _write_avro(tmp_path / "in")
    jspecs, jidx = jsr.plan_chunks(files, 40)
    tspecs, tidx = tsr.plan_chunks(files, 40)
    assert [(s.index, s.num_records, s.runs) for s in tspecs] == \
        [(s.index, s.num_records, s.runs) for s in jspecs]
    assert [list(map(tuple, ix)) for ix in tidx] == [list(map(tuple, ix)) for ix in jidx]
    subset = [(0, 1), (0, 2), (1, 0), (1, 3)]
    assert [s.runs for s in tsr.plan_chunks(files, 40, block_subset=subset)[0]] == \
        [s.runs for s in jsr.plan_chunks(files, 40, block_subset=subset)[0]]
    cfg = {"features": JShardCfg(feature_bags=("features",))}
    tcfg = {"features": TShardCfg(feature_bags=("features",))}
    jmaps = jsr.build_streaming_index_maps(files, cfg)
    tmaps = tsr.build_streaming_index_maps(files, tcfg)
    keys = [jmaps["features"].get_feature_name(i) for i in range(jmaps["features"].size)]
    assert [tmaps["features"].get_feature_name(i) for i in range(tmaps["features"].size)] == keys
    j = jsr.AvroChunkSource(files, jsr.DenseRecordAssembler(jmaps["features"], cfg["features"]),
                            chunk_records=40)
    t = tsr.AvroChunkSource(files, tsr.DenseRecordAssembler(tmaps["features"],
                                                            tcfg["features"]),
                            chunk_records=40)
    assert (t.chunk_rows, t.dim, t.total_records) == (j.chunk_rows, j.dim, j.total_records)
    for jc, tc in zip(_chunks(j), _chunks(t)):
        for f in DENSE_FIELDS:
            np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)), err_msg=f)
    assert t.bytes_decoded > 0


def test_plan_refuses_bad_budgets(tmp_path):
    files = _write_avro(tmp_path / "in", n=20)
    with pytest.raises(ValueError, match="positive"):
        tsr.plan_chunks(files, 0)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_prefetch_on_and_off_agree_bitwise(kind):
    if kind == "dense":
        x, y, o, w = _dense(3)
        src = tsr.ArrayChunkSource(x, y, offsets=o, weights=w, chunk_rows=16)
    else:
        rows, cols, vals, y, d = _coo(4)
        src = tsr.SparseArrayChunkSource(rows, cols, vals, y, dim=d, chunk_rows=16)
    on, off = _chunks(src, True), _chunks(src, False)
    assert len(on) == len(off) == src.num_chunks
    for a, b in zip(on, off):
        da, db = a.to_device("cpu"), b.to_device("cpu")
        for f in ("features", "labels", "values", "ell_vals", "weights"):
            va, vb = getattr(da, f, None), getattr(db, f, None)
            if va is not None:
                assert torch.equal(va, vb)


def test_decode_runs_ahead_in_its_own_thread():
    """With prefetch the source loads in the producer thread, one chunk
    ahead of the consumer; inline, in the caller's thread."""
    x, y, o, w = _dense(5, n=64)
    threads = []
    src = tsr.ArrayChunkSource(x, y, chunk_rows=16,
                               decode_hook=lambda: threads.append(threading.current_thread()))
    _chunks(src, True)
    assert threads and all(t is not threading.main_thread() for t in threads)
    threads.clear()
    _chunks(src, False)
    assert all(t is threading.main_thread() for t in threads)


def test_wedged_decode_times_out_attributed():
    x, y, _, _ = _dense(6, n=32)
    src = tsr.ArrayChunkSource(x, y, chunk_rows=16, decode_hook=lambda: time.sleep(1.5))
    t0 = time.perf_counter()
    with pytest.raises(tsr.StreamDecodeError, match="wedged"):
        with tsr.ChunkPrefetcher(src, chunk_timeout=0.3) as it:
            list(it)
    assert time.perf_counter() - t0 < tsr.JOIN_TIMEOUT + 5


def test_abandoned_epoch_stops_the_producer():
    x, y, _, _ = _dense(7, n=160)
    src = tsr.ArrayChunkSource(x, y, chunk_rows=16)
    pf = tsr.ChunkPrefetcher(src)
    with pf as it:
        next(iter(it))
    assert pf._thread is None and pf.decode_seconds >= 0.0
    assert 0.0 <= pf.overlap_fraction <= 1.0
