"""Streamed GAME on the card, against the same program on the CPU in float64.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_streaming_game_cuda.py

A streamed GAME run launches B1 and its reduce once a chunk a value+gradient
epoch and ends within 1e-3·max|w| of the CPU's f64 run; ``schedule=None`` and
the uniform schedule, and two runs, are bitwise equal; a DuHL run's pinned
working set holds host arrays only; and a checkpoint written on the card
resumes on the card bitwise.
"""

import numpy as np
import pytest
import torch

from photon_ml_torch.algorithm.streaming_game import (
    DuHLChunkSchedule,
    DuHLScheduleConfig,
    StreamingGameProgram,
    UniformChunkSchedule,
)
from photon_ml_torch.io.checkpoint import TrainingCheckpointer
from photon_ml_torch.io.stream_reader import GameArrayChunkSource
from photon_ml_torch.ops import fused_glm
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.parallel.distributed import FixedEffectStepSpec, RandomEffectStepSpec
from photon_ml_torch.types import TaskType

pytestmark = pytest.mark.cuda

SWEEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _source(dtype, seed=0, n=6000, d_fe=48, d_re=8, users=60):
    rng = np.random.default_rng(seed)
    users_idx = np.sort(rng.integers(0, users, size=n)).astype(np.int32)
    x_fe = rng.normal(size=(n, d_fe))
    x_re = rng.normal(size=(n, d_re))
    z = x_fe @ rng.normal(size=d_fe) / 4 + (x_re * rng.normal(size=(users, d_re))[users_idx]).sum(1)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-z))).astype(float)
    return GameArrayChunkSource(
        features={"global": x_fe.astype(dtype), "per_entity": x_re.astype(dtype)},
        labels=y.astype(dtype), entity_idx={"user": users_idx}, chunk_records=1024,
        cluster_by="user")


def _program(source, device, schedule=None):
    opt = OptimizerConfig(OptimizerType.LBFGS, max_iterations=8, tolerance=0.0)
    return StreamingGameProgram(
        TaskType.LOGISTIC_REGRESSION, source, FixedEffectStepSpec("global", opt, l2_weight=1.0),
        (RandomEffectStepSpec("user", "per_entity", opt, l2_weight=1.0),), schedule=schedule,
        device=device)


def _state(result):
    st = result.state
    return {"fe": st.fe_coefficients.double().cpu(), "user": st.re_tables["user"].double().cpu()}


def test_streamed_game_on_the_card_matches_the_cpu(cuda):
    source = _source(np.float32)
    fused_glm.launches = fused_glm.reduce_launches = 0
    card = _program(source, cuda).train(num_sweeps=SWEEPS)
    assert fused_glm.launches == fused_glm.reduce_launches > 0
    assert fused_glm.launches % source.num_chunks == 0
    cpu = _program(_source(np.float64), "cpu").train(num_sweeps=SWEEPS)
    a, b = _state(card), _state(cpu)
    for k in b:
        assert float((a[k] - b[k]).abs().max()) <= 1e-3 * float(b[k].abs().max()), k


def test_schedules_and_repeats_are_bitwise(cuda):
    source = _source(np.float32)
    runs = [_program(source, cuda, UniformChunkSchedule(source.num_chunks)).train(
        num_sweeps=SWEEPS)] + [_program(source, cuda).train(num_sweeps=SWEEPS) for _ in range(2)]
    ref = _state(runs[0])
    for run in runs[1:]:
        assert run.losses == runs[0].losses
        assert all(_state(run)[k].equal(ref[k]) for k in ref)


def test_duhl_working_set_stays_on_the_host(cuda):
    source = _source(np.float32)
    schedule = DuHLChunkSchedule(DuHLScheduleConfig(working_set_chunks=2), source.num_chunks)
    program = _program(source, cuda, schedule)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    result = program.train(num_sweeps=4)
    assert program.cache_bytes() > 0 and np.isfinite(result.losses).all()
    assert all(isinstance(a, np.ndarray) for c in program._cache._store.values()
               for a in c.features.values())
    # what stays allocated is the state, not the pinned chunks
    assert torch.cuda.memory_allocated() - before < program.cache_bytes()


def test_checkpoint_resumes_bitwise_on_the_card(cuda, tmp_path):
    source = _source(np.float32)
    whole = _program(source, cuda).train(num_sweeps=SWEEPS)
    ck = TrainingCheckpointer(tmp_path / "ck")
    _program(source, cuda).train(num_sweeps=1, checkpointer=ck)
    resumed = _program(source, cuda).train(num_sweeps=SWEEPS, checkpointer=ck)
    assert resumed.losses == whole.losses
    assert all(_state(resumed)[k].equal(_state(whole)[k]) for k in ("fe", "user"))
