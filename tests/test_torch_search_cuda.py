"""Search and scheduling on the card, against the same calls on the CPU in
float64.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_search_cuda.py

The sparse λ grid launches G1's row kernel and its segment kernel once a
lane and evaluation, and lands within 1e-3·max|w| of the CPU's f64 grid; a
lane-scheduled GAME fit repeats bitwise on the card in f32 and lands within
1e-8·max|w| of the CPU's in f64.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.algorithm import lane_search
from photon_ml_torch.data.game_data import build_game_dataset
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.estimators import (
    FixedEffectCoordinateConfig,
    GameEstimator,
    RandomEffectCoordinateConfig,
    train_glm_grid,
)
from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig, OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _coo(n=4000, d=3000, per_row=12, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, d, size=n * per_row)
    vals = rng.normal(size=n * per_row)
    w = rng.normal(size=d) * 0.3
    z = np.bincount(rows, weights=vals * w[cols], minlength=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float)
    return rows, cols, vals, y, d


def _max_rel(a, b):
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_sparse_grid_launches_g1_once_a_lane_and_evaluation(cuda):
    rows, cols, vals, y, d = _coo()
    lams = (0.1, 1.0, 10.0)
    opt = OptimizerConfig(OptimizerType.LBFGS, max_iterations=15)
    gpu = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, dtype=torch.float32,
                                           device=cuda)
    cpu = SparseLabeledPointBatch.from_coo(rows, cols, vals, y, dim=d, dtype=torch.float64,
                                           device="cpu")
    before = (sparse_gather.launches, sparse_gather.segment_launches,
              lane_search.lane_evaluations)
    got = train_glm_grid(gpu, TaskType.LOGISTIC_REGRESSION, optimizer=opt,
                         regularization_weights=lams)
    evals = lane_search.lane_evaluations - before[2]
    assert sparse_gather.launches - before[0] == len(lams) * evals
    assert sparse_gather.segment_launches - before[1] == len(lams) * evals
    ref = train_glm_grid(cpu, TaskType.LOGISTIC_REGRESSION, optimizer=opt,
                         regularization_weights=lams)
    for lam in lams:
        assert _max_rel(got[lam].coefficients.means, ref[lam].coefficients.means) < 1e-3


def _game(device, dtype, **kw):
    rng = np.random.default_rng(3)
    n, users = 6000, 120
    u = rng.integers(0, users, size=n)
    xg = rng.normal(size=(n, 16))
    xg[:, -1] = 1
    xr = rng.normal(size=(n, 4))
    z = xg @ rng.normal(size=16) / 4 + (xr * rng.normal(size=(users, 4))[u]).sum(1)
    y = (rng.random(n) < 1 / (1 + np.exp(-z))).astype(float)
    ds = build_game_dataset(labels=y, feature_shards={"global": xg, "per_entity": xr},
                            entity_keys={"user": np.array([f"u{i}" for i in u])},
                            dtype=dtype, device=device)
    sched = OptimizerConfig(OptimizerType.LBFGS, max_iterations=10, rel_function_tolerance=1e-6,
                            scheduler=LaneSchedulerConfig(probe_iterations=2))
    est = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, num_iterations=3,
        coordinate_configs={
            "fixed": FixedEffectCoordinateConfig("global", CoordinateOptimizationConfig(
                OptimizerConfig(OptimizerType.LBFGS, max_iterations=30), l2_weight=1.0)),
            "per_user": RandomEffectCoordinateConfig("user", "per_entity",
                                                     CoordinateOptimizationConfig(
                                                         sched, l2_weight=1.0))}, **kw)
    return est.fit(ds).model


def _tables(model):
    return (model.get("fixed").glm.coefficients.means, model.get("per_user").coefficients)


def test_scheduled_fit_matches_the_cpu(cuda):
    """The f32 fit (the packed kernel on the fixed effect) repeats bitwise;
    the same fit in f64 on the card (the closed form on the fixed effect:
    the kernel takes f32 and bf16) lands within 1e-8·max|w| of the CPU's."""
    a, b = _game(cuda, np.float32), _game(cuda, np.float32)
    for ta, tb in zip(_tables(a), _tables(b)):
        assert torch.equal(ta, tb)
    card = _game(cuda, np.float64, use_kernel=False)
    ref = _game("cpu", np.float64, use_kernel=False)
    for tc, tr in zip(_tables(card), _tables(ref)):
        assert _max_rel(tc, tr) < 1e-8
