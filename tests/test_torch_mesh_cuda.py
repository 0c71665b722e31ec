"""The fused program over a one-rank NCCL mesh on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_cuda.py

A fixed effect, a per-user random effect and a user × item MF coordinate
sweep twice over a one-rank NCCL group: the state within 1e-4 of its
largest magnitude of the same sweeps with ``mesh=None``, two mesh runs
bitwise equal, every evaluation of the fixed effect's solve one B1 launch
and one all-reduce, and scoring through the mesh equal to the one-device
transform.
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
from photon_ml_torch.parallel import mesh as mesh_ops
from photon_ml_torch.parallel import multihost
from photon_ml_torch.transformers import GameTransformer
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    info = multihost.initialize()
    assert info.backend == "nccl" and info.device.type == "cuda"
    try:
        yield mesh_ops.make_mesh()
    finally:
        multihost.shutdown()


def _data(seed: int = 0, n: int = 4099, d_fe: int = 32, d_re: int = 8, users: int = 48,
          items: int = 24):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, size=n)
    it = rng.integers(0, items, size=n)
    xg = rng.standard_normal((n, d_fe), dtype=np.float32)
    xr = rng.standard_normal((n, d_re), dtype=np.float32)
    z = xg @ (rng.normal(size=d_fe) / np.sqrt(d_fe)) \
        + np.einsum("nd,nd->n", xr, 0.5 * rng.normal(size=(users, d_re))[u])
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float32)
    ds = build_game_dataset(labels=y, feature_shards={"global": xg, "per_entity": xr},
                            entity_keys={"user": np.char.add("u", u.astype(str)),
                                         "item": np.char.add("i", it.astype(str))})
    re = {"user": build_random_effect_dataset(ds, "user", "per_entity")}
    return ds, re, {"mf": build_mf_dataset(ds, "user", "item")}


def _program(mesh=None):
    lbfgs = OptimizerConfig(OptimizerType.LBFGS, max_iterations=10)
    newton = OptimizerConfig(OptimizerType.NEWTON, max_iterations=10)
    return dist.GameTrainProgram(
        TaskType.LOGISTIC_REGRESSION, dist.FixedEffectStepSpec("global", lbfgs, l2_weight=1.0),
        (dist.RandomEffectStepSpec("user", "per_entity", newton, l2_weight=1.0),),
        mf_specs=(dist.MatrixFactorizationStepSpec("mf", "user", "item", 4, newton,
                                                   l2_weight=10.0),), mesh=mesh)


def _flat(state) -> dict:
    s = convert.train_state_to_numpy(state)
    out = {"fe": s["fe_coefficients"]}
    for g in ("re_tables", "mf_rows", "mf_cols"):
        out.update({f"{g}/{k}": v for k, v in s[g].items()})
    return out


def test_one_rank_mesh_matches_the_one_device_program(mesh):
    ds, re, mf = _data()
    prog = _program(mesh)
    start = prog.init_state(ds, re, mf)
    one = dist.train_distributed(_program(), ds, re, mf_datasets=mf, num_iterations=2,
                                 state=start)
    fused_glm.launches = 0
    mesh_ops.counts.reset()
    a = dist.train_distributed(prog, ds, re, mf_datasets=mf, mesh=mesh, num_iterations=2,
                               state=start)
    launches, calls = fused_glm.launches, mesh_ops.counts.snapshot()
    b = dist.train_distributed(prog, ds, re, mf_datasets=mf, mesh=mesh, num_iterations=2,
                               state=start)
    fa, fb, fo = _flat(a.state), _flat(b.state), _flat(one.state)
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    scale = max(np.abs(v).max() for v in fo.values())
    assert max(np.abs(fa[k] - fo[k]).max() for k in fo) <= 1e-4 * scale
    np.testing.assert_allclose(a.losses, one.losses, rtol=1e-5)
    # one B1 launch and one all-reduce an evaluation, plus the loss's
    assert launches > 0 and calls["all_reduce"]["calls"] == launches + 2
    # a sweep: the RE coordinate's offsets and table, the MF coordinate's
    # offsets and its row and column tables
    assert calls["all_gather"]["calls"] == 2 * (2 + 3)


def test_mesh_scoring_matches_the_one_device_transform(mesh):
    ds, re, mf = _data(1)
    prog = _program(mesh)
    res = dist.train_distributed(prog, ds, re, mf_datasets=mf, mesh=mesh, num_iterations=1)
    model = dist.state_to_game_model(prog, res.state, ds, re_datasets=re)
    one = GameTransformer(model).transform(ds).scores
    got = GameTransformer(model, mesh=mesh).transform(ds).scores
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6 * np.abs(one).max())
