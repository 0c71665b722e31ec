"""Compact random effects on a sparse shard on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sparse_random_effects_cuda.py

Compact scoring runs the gather kernel over the flattened ``[E, K+1]`` table
and is held against its plain version in f64 (per row 1e-5 of Σ|v·t|), twice
bitwise equal; a GAME fit with a compact per-user effect, run twice, is
bitwise equal and within 1e-3 max|w| of the same fit on the CPU in f64; and a
table of 2^31 slots or more raises instead of taking the plain version.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.estimators import (
    FixedEffectCoordinateConfig,
    GameEstimator,
    RandomEffectCoordinateConfig,
)
from photon_ml_torch.models import game
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _arrays(seed: int = 0, n: int = 6000, d: int = 50_000, users: int = 80, per_row: int = 12):
    """Linear data over a wide sparse shard: power-law columns (the hottest
    rows longer than a chunk), per-user effects on each user's columns."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = ((rng.random(n * per_row) ** 8 * d).astype(np.int64) * 2654435761) % d
    vals = rng.normal(size=n * per_row) / np.sqrt(per_row)
    u = rng.integers(0, users, size=n)
    w = rng.normal(size=d)
    y = np.bincount(rows, weights=vals * w[cols], minlength=n) + 0.1 * rng.normal(size=n)
    return rows, cols, vals, y, np.char.add("u", u.astype(str)), d


def _dataset(arrays, device, dtype):
    rows, cols, vals, y, users, d = arrays
    shard = SparseShard(rows=rows, cols=cols, vals=vals.astype(dtype), num_samples=len(y),
                        feature_dim=d)
    return build_game_dataset(labels=y, feature_shards={"global": shard},
                              entity_keys={"user": users}, dtype=dtype, device=device)


def _estimator(lanes: str = "LBFGS", sweeps: int = 2) -> GameEstimator:
    def opt(kind):
        return CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(OptimizerType[kind], max_iterations=10), l2_weight=1.0)

    return GameEstimator(task=TaskType.LINEAR_REGRESSION, coordinate_configs={
        "fixed": FixedEffectCoordinateConfig("global", opt("LBFGS")),
        "per_user": RandomEffectCoordinateConfig("user", "global", opt(lanes))},
        num_iterations=sweeps)


def test_compact_scoring_runs_the_gather_kernel(cuda):
    ds = _dataset(_arrays(), cuda, np.float32)
    red = build_random_effect_dataset(ds, "user", "global")
    e, k = red.active_cols.shape
    table = torch.randn((e, k), generator=torch.Generator().manual_seed(1)).to(cuda)
    entries = game.compact_entries(ds.feature_shards["global"], ds.host_array("entity_idx/user"),
                                   red.active_cols, cuda)
    before = game.compact_launches
    k1, k2 = entries.score(table), entries.score(table)
    assert game.compact_launches == before + 2
    assert torch.equal(k1, k2) and k1.dtype == torch.float32
    args = (entries.ent, entries.pos, entries.rows)
    plain = game.score_random_effect_compact_reference(table.double(), *args,
                                                       entries.vals.double(), ds.num_samples)
    scale = game.score_random_effect_compact_reference(table.double().abs(), *args,
                                                       entries.vals.double().abs(),
                                                       ds.num_samples)
    assert bool(((k1.double() - plain).abs() <= 1e-5 * scale + 1e-30).all())


def test_compact_fit_repeats_bitwise_and_matches_the_cpu(cuda):
    arrays = _arrays(seed=2)
    runs = [_estimator("NEWTON").fit(_dataset(arrays, cuda, np.float32)).model for _ in range(2)]
    for cid in ("fixed", "per_user"):
        a, b = runs[0].get(cid), runs[1].get(cid)
        ta = a.glm.coefficients.means if cid == "fixed" else a.coefficients
        tb = b.glm.coefficients.means if cid == "fixed" else b.coefficients
        assert torch.equal(ta, tb), cid
    cpu = _estimator("NEWTON").fit(_dataset(arrays, "cpu", np.float64)).model
    got = runs[0].get("per_user").coefficients.double().cpu()
    want = cpu.get("per_user").coefficients
    assert np.array_equal(runs[0].get("per_user").active_cols, cpu.get("per_user").active_cols)
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_flat_slots_past_int32_raise(cuda):
    ent = torch.zeros(4, dtype=torch.int32, device=cuda)
    pos = torch.zeros(4, dtype=torch.int32, device=cuda)
    rows = torch.arange(4, dtype=torch.int32, device=cuda)
    vals = torch.ones(4, device=cuda)
    table = torch.empty((1 << 16, 1 << 15), device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="int32"):
        game.score_random_effect_compact(table, ent, pos, rows, vals, 4)
