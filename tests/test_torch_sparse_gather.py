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
