"""Streamed GLM solves on the card, against the same solves on the CPU in
float64 and in core on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streaming_cuda.py

A dense streamed λ path launches B1 and its reduce once a chunk an
evaluation and ends within 1e-3·max|w| of the CPU's f64 path; prefetch on
and off, and two runs, are bitwise equal; a sparse streamed solve runs G1 on
every chunk and ends within 1e-3·max|w| of the CPU's; a solver checkpoint
written on the card resumes on the card bitwise.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.estimators import train_glm_streaming
from photon_ml_torch.io.checkpoint import SolverCheckpointer
from photon_ml_torch.io.stream_reader import ArrayChunkSource, SparseArrayChunkSource
from photon_ml_torch.ops import fused_glm, sparse_gather
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.resilience import TransientError
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda

LAMS = (1.0, 10.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dense(dtype, seed=0, n=8192, d=64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-x @ rng.normal(size=d) / 4))).astype(float)
    return ArrayChunkSource(x.astype(dtype), y.astype(dtype), chunk_rows=1024)


def _train(source, device, iterations=15, **kw):
    return train_glm_streaming(
        source, TaskType.LOGISTIC_REGRESSION, device=device, regularization_weights=LAMS,
        optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=iterations), **kw)


def _close(card, cpu):
    for lam in LAMS:
        a = card[lam].coefficients.means.double().cpu()
        b = cpu[lam].coefficients.means
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), lam


def test_dense_stream_launches_b1_per_chunk_and_matches_the_cpu(cuda):
    src = _dense(np.float32)
    epochs = []
    fused_glm.launches = fused_glm.reduce_launches = 0
    card = _train(src, cuda, on_solve=lambda lam, r, obj: epochs.append(obj.epochs))
    assert fused_glm.launches == fused_glm.reduce_launches == src.num_chunks * sum(epochs)
    _close(card, _train(_dense(np.float64), "cpu"))
    again = _train(src, cuda)
    off = _train(src, cuda, prefetch=False)
    for lam in LAMS:
        assert card[lam].coefficients.means.equal(again[lam].coefficients.means)
        assert card[lam].coefficients.means.equal(off[lam].coefficients.means)


def test_sparse_stream_runs_g1_and_matches_the_cpu(cuda):
    """A planted model over a 2,000-column support of d=50,000, solved for a
    budget of 5 iterations (short of the f32 objective's resolution, where
    the card and the CPU would stop apart)."""
    rng = np.random.default_rng(1)
    n, d, per_row = 8192, 50_000, 12
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, 2000, size=n * per_row)
    vals = rng.normal(size=n * per_row)
    z = np.zeros(n)
    np.add.at(z, rows, vals * rng.normal(size=2000)[cols] / 4)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(float)

    def source(dtype):
        return SparseArrayChunkSource(rows, cols, vals.astype(dtype), y, dim=d, chunk_rows=2048,
                                      dtype=dtype)

    sparse_gather.launches = sparse_gather.segment_launches = 0
    card = _train(source(np.float32), cuda, iterations=5)
    assert sparse_gather.launches + sparse_gather.segment_launches > 0
    _close(card, _train(source(np.float64), "cpu", iterations=5))


def test_solver_checkpoint_resumes_on_the_card_bitwise(cuda, tmp_path):
    src = _dense(np.float32)
    whole = _train(src, cuda)
    ck = SolverCheckpointer(tmp_path)
    real, saves = ck.save_progress, {"n": 0}

    def stop(**kw):
        path = real(**kw)
        if kw["solver_state"] is not None:
            saves["n"] += 1
            if saves["n"] == 3:  # mid-solve in the first λ
                raise TransientError("stopped")
        return path

    ck.save_progress = stop
    with pytest.raises(TransientError):
        _train(src, cuda, checkpointer=ck)
    ck.save_progress = real
    resumed = _train(src, cuda, checkpointer=ck)
    for lam in LAMS:
        assert whole[lam].coefficients.means.equal(resumed[lam].coefficients.means)
