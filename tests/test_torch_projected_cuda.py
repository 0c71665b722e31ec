"""Projected random effects and the OWL-QN and TRON lanes on the card, against
the same update on the CPU in float64.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_projected_cuda.py

Each case trains one per-user coordinate for two updates (the second
warm-started from the first, with residual offsets) in f32 on the card and
in f64 on the CPU: tables within 1e-3 max|w|, variances within 1e-3 of
their largest, NaN in the same places; and the card's run, repeated, is
bitwise equal.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.algorithm.coordinates import (
    CoordinateOptimizationConfig,
    RandomEffectCoordinate,
)
from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _arrays(seed: int = 0, n: int = 3000, d: int = 24, users: int = 60):
    """Per-user logistic data over a wide shard: column 0 a constant-1
    intercept, each user 3-6 of the other columns, N(0, 1) values there."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, size=n)
    support = np.zeros((users, d), dtype=bool)
    support[:, 0] = True
    for i in range(users):
        support[i, 1 + rng.choice(d - 1, size=rng.integers(3, 7), replace=False)] = True
    x = rng.normal(size=(n, d)) * support[u]
    x[:, 0] = 1.0
    w = rng.normal(size=(users, d)) * support
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-np.einsum("nd,nd->n", x, w[u])))) * 1.0
    return x, y, np.char.add("u", u.astype(str)), 0.3 * rng.normal(size=n)


CASES = {
    "index-map-newton": dict(projector="INDEX_MAP", lanes="NEWTON", norm="STANDARDIZATION"),
    "random-lbfgs": dict(projector="RANDOM", lanes="LBFGS", norm="SCALE_WITH_STANDARD_DEVIATION",
                         projected_dim=8),
    "owlqn-lanes": dict(projector="INDEX_MAP", lanes="OWLQN", norm="NONE", l1=0.05),
    "tron-lanes": dict(projector="IDENTITY", lanes="TRON", norm="NONE"),
}


def _train(device, dtype, case):
    x, y, users, extra = _arrays()
    ds = build_game_dataset(labels=y, feature_shards={"wide": x}, entity_keys={"user": users},
                            dtype=dtype, device=device)
    norm = None
    if case["norm"] != "NONE":
        xd = torch.as_tensor(x, dtype=ds.labels.dtype, device=ds.device)
        norm = build_normalization(NormalizationType[case["norm"]], mean=xd.mean(0),
                                   variance=xd.var(0), max_magnitude=xd.abs().amax(0),
                                   intercept_index=0)
    projector = ProjectorType[case["projector"]]
    re = build_random_effect_dataset(
        ds, "user", "wide", projector_type=projector, projected_dim=case.get("projected_dim"),
        normalization=norm if projector != ProjectorType.IDENTITY else None)
    opt = OptimizerConfig(OptimizerType[case["lanes"]], max_iterations=10,
                          tolerance=1e-5 if case["lanes"] == "TRON" else 1e-7)
    coord = RandomEffectCoordinate(
        "per_user", ds, re, TaskType.LOGISTIC_REGRESSION,
        CoordinateOptimizationConfig(optimizer=opt, l2_weight=1.0, l1_weight=case.get("l1", 0.0),
                                     compute_variance=case["lanes"] != "OWLQN"),
        normalization=norm, intercept_index=0)
    model = coord.initial_model()
    offsets = torch.as_tensor(extra, dtype=ds.labels.dtype, device=ds.device)
    for sweep in range(2):
        model, _ = coord.update_model(model, offsets * (sweep + 1))
    var = None if model.variances is None else model.variances.double().cpu()
    return model.coefficients.double().cpu(), var


@pytest.mark.parametrize("name", list(CASES))
def test_card_update_matches_the_cpu_in_f64(cuda, name):
    case = CASES[name]
    table, var = _train(cuda, np.float32, case)
    ref_table, ref_var = _train("cpu", np.float64, case)
    scale = float(ref_table.abs().max())
    assert float((table - ref_table).abs().max()) <= 1e-3 * scale, name
    if ref_var is not None:
        assert torch.equal(torch.isnan(var), torch.isnan(ref_var))
        live = ~torch.isnan(ref_var)
        assert float((var[live] - ref_var[live]).abs().max()) \
            <= 1e-3 * float(ref_var[live].abs().max())
    again, var_again = _train(cuda, np.float32, case)
    assert torch.equal(again, table)
    assert (var is None) or torch.equal(torch.nan_to_num(var_again, nan=-1.0),
                                        torch.nan_to_num(var, nan=-1.0))
