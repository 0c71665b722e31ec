"""The fused GAME training program on the card, against the same sweeps on
the CPU in float64.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_program_cuda.py

A fixed effect, a per-user random effect and a user × item MF coordinate
sweep twice from the same state in f32 on the card and in f64 on the CPU:
every state tensor within 1e-3 of its largest magnitude; the card's run,
repeated, is bitwise equal; and every evaluation of the fixed effect's
solve launched the fused GLM kernel (B1) and its reduction once.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch import convert
from photon_ml_torch.algorithm.mf_coordinate import build_mf_dataset
from photon_ml_torch.data.game_data import build_game_dataset, build_random_effect_dataset
from photon_ml_torch.ops import fused_glm
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.parallel import distributed as dist
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _arrays(seed: int = 0, n: int = 4096, d_fe: int = 32, d_re: int = 8, users: int = 48,
            items: int = 24):
    rng = np.random.default_rng(seed)
    u, i = rng.integers(0, users, size=n), rng.integers(0, items, size=n)
    xg, xr = rng.normal(size=(n, d_fe)), rng.normal(size=(n, d_re))
    z = xg @ rng.normal(size=d_fe) / np.sqrt(d_fe) \
        + np.einsum("nd,nd->n", xr, 0.5 * rng.normal(size=(users, d_re))[u])
    y = (rng.uniform(size=n) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return dict(labels=y, feature_shards={"global": xg, "per_entity": xr},
                entity_keys={"user": np.char.add("u", u.astype(str)),
                             "item": np.char.add("i", i.astype(str))})


def _inputs(arrays, device, dtype):
    ds = build_game_dataset(**arrays, dtype=dtype, device=device)
    re_ds = {"user": build_random_effect_dataset(ds, "user", "per_entity")}
    mf_ds = {"mf": build_mf_dataset(ds, "user", "item")}
    return ds, re_ds, mf_ds


def _program():
    opt = OptimizerConfig(OptimizerType.LBFGS, max_iterations=10)
    auto = OptimizerConfig(OptimizerType.AUTO, max_iterations=10)
    return dist.GameTrainProgram(
        TaskType.LOGISTIC_REGRESSION, dist.FixedEffectStepSpec("global", opt, l2_weight=1.0),
        (dist.RandomEffectStepSpec("user", "per_entity", auto, l2_weight=1.0),),
        mf_specs=(dist.MatrixFactorizationStepSpec("mf", "user", "item", 4, auto,
                                                   l2_weight=10.0, num_alternations=2),))


def test_card_sweeps_match_the_cpu_in_f64(cuda):
    arrays = _arrays()
    program = _program()
    ds, re_ds, mf_ds = _inputs(arrays, cuda, np.float32)
    start = convert.train_state_to_numpy(program.init_state(ds, re_ds, mf_ds))
    evaluations = []
    inner = program._fe_objective.value_and_gradient
    program._fe_objective.value_and_gradient = lambda *a, **k: (evaluations.append(1),
                                                                inner(*a, **k))[1]
    fused_glm.launches = fused_glm.reduce_launches = 0
    runs = [dist.train_distributed(program, ds, re_ds, mf_datasets=mf_ds, num_iterations=2,
                                   state=convert.train_state_from_numpy(start, device=cuda))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_glm.launches == fused_glm.reduce_launches == len(evaluations) > 0
    card = [convert.train_state_to_numpy(r.state) for r in runs]
    assert runs[0].losses == runs[1].losses
    cds, cre, cmf = _inputs(arrays, "cpu", np.float64)
    cpu_start = {k: ({n: a.astype(np.float64) for n, a in v.items()} if isinstance(v, dict)
                     else v.astype(np.float64)) for k, v in start.items()}
    cpu = convert.train_state_to_numpy(dist.train_distributed(
        _program(), cds, cre, mf_datasets=cmf, num_iterations=2,
        state=convert.train_state_from_numpy(cpu_start, device="cpu")).state)
    pairs = [(card[0]["fe_coefficients"], card[1]["fe_coefficients"], cpu["fe_coefficients"])]
    for group in ("re_tables", "mf_rows", "mf_cols"):
        pairs += [(card[0][group][k], card[1][group][k], cpu[group][k]) for k in cpu[group]]
    for a, b, ref in pairs:
        assert np.array_equal(a, b)
        assert np.abs(a - ref).max() <= 1e-3 * np.abs(ref).max()
