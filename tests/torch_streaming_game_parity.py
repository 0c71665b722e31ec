"""Fixtures of the port's streamed-GAME tests: entity-sorted GAME data made
from a numpy seed (in memory and as Avro), and the same streamed program
built in both packages."""

from __future__ import annotations

import os

import numpy as np

from photon_ml_torch.io import avro as tavro

#: the TrainingExampleAvro subset the streamed tests write
SCHEMA = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "fields": [
        {"name": "uid", "type": ["string", "null"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "userId", "type": ["string", "null"], "default": None},
        {"name": "features", "type": {"type": "array", "items": {
            "type": "record", "name": "FeatureAvro", "fields": [
                {"name": "name", "type": "string"},
                {"name": "term", "type": ["string", "null"], "default": None},
                {"name": "value", "type": "double"}]}}},
        {"name": "weight", "type": ["double", "null"], "default": None},
        {"name": "offset", "type": ["double", "null"], "default": None},
    ],
}


def game_arrays(seed: int = 0, n: int = 96, d_fe: int = 8, d_re: int = 4, n_users: int = 6,
                task: str = "LOGISTIC_REGRESSION") -> dict:
    """Entity-sorted in-memory GAME arrays: users in contiguous row runs."""
    rng = np.random.default_rng(seed)
    users = np.sort(rng.integers(0, n_users, size=n)).astype(np.int32)
    x_fe = rng.normal(size=(n, d_fe))
    x_re = rng.normal(size=(n, d_re))
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=n) < 0.5).astype(float)
    else:
        w_re = rng.normal(size=(n_users, d_re))
        y = x_fe @ rng.normal(size=d_fe) + (x_re * w_re[users]).sum(1) \
            + 0.1 * rng.normal(size=n)
    return dict(features={"global": x_fe, "per_entity": x_re}, labels=y,
                offsets=0.1 * rng.normal(size=n), weights=rng.uniform(0.5, 2.0, size=n),
                entity_idx={"user": users})


def skewed_arrays(seed: int = 3) -> dict:
    """Gap-skewed data (the JAX package's DuHL fixture): hot entities couple
    to the FE signal, cold entities see zero FE features."""
    rng = np.random.default_rng(seed)
    d_fe, d_re = 6, 4
    hot_rows, cold_rows = 256, 768
    n = hot_rows + cold_rows
    ents = np.concatenate([np.repeat(np.arange(4), hot_rows // 4),
                           4 + np.arange(cold_rows) // 8]).astype(np.int32)
    x_fe = rng.normal(size=(n, d_fe))
    x_fe[hot_rows:] = 0.0
    x_re = rng.normal(size=(n, d_re))
    w_fe = rng.normal(size=d_fe)
    w_re = 0.5 * rng.normal(size=(int(ents.max()) + 1, d_re))
    w_re[:4] *= 6.0
    y = x_fe @ w_fe + (x_re * w_re[ents]).sum(1) + 0.05 * rng.normal(size=n)
    return dict(features={"g": x_fe, "p": x_re}, labels=y, entity_idx={"user": ents})


def avro_records(n: int = 200, d: int = 5, n_users: int = 8, seed: int = 7) -> list:
    """TrainingExampleAvro rows sorted by user (a linear model plus noise)."""
    rng = np.random.default_rng(seed)
    users = np.sort(rng.integers(0, n_users, size=n))
    recs = []
    for i in range(n):
        x = rng.normal(size=d)
        recs.append({"uid": str(i), "label": float(x.sum() + 0.1 * rng.normal()),
                     "userId": f"u{users[i]:02d}",
                     "features": [{"name": f"f{j}", "term": "", "value": float(x[j])}
                                  for j in range(d)],
                     "weight": float(rng.uniform(0.5, 2.0)),
                     "offset": float(0.1 * rng.normal())})
    return recs


def write_avro(base, records, block_records: int = 16, name: str = "train") -> str:
    data = os.path.join(str(base), name)
    os.makedirs(data, exist_ok=True)
    tavro.write_container(os.path.join(data, "part-00000.avro"), SCHEMA, records,
                          block_records=block_records)
    return data


def specs(pkg: str, *, fe_shard="global", re_shard="per_entity", re_type="user",
          max_iter: int = 8, fe_l2: float = 0.1, re_l2: float = 1.0, re_max_iter=None,
          scheduler: dict | None = None):
    """(FixedEffectStepSpec, (RandomEffectStepSpec,)) of one package, L-BFGS;
    ``scheduler`` (LaneSchedulerConfig fields) schedules the RE lanes, with
    a live function stop at 1e-6."""
    if pkg == "jax":
        from photon_ml_tpu.optim.optimizer import (
            LaneSchedulerConfig,
            OptimizerConfig,
            OptimizerType,
        )
        from photon_ml_tpu.parallel.distributed import FixedEffectStepSpec, RandomEffectStepSpec
    else:
        from photon_ml_torch.optim.optimizer import (
            LaneSchedulerConfig,
            OptimizerConfig,
            OptimizerType,
        )
        from photon_ml_torch.parallel.distributed import FixedEffectStepSpec, RandomEffectStepSpec
    opt = OptimizerConfig(optimizer_type=OptimizerType.LBFGS, max_iterations=max_iter)
    re_opt = OptimizerConfig(optimizer_type=OptimizerType.LBFGS,
                             max_iterations=re_max_iter or max_iter)
    if scheduler is not None:
        re_opt = OptimizerConfig(optimizer_type=OptimizerType.LBFGS,
                                 max_iterations=re_max_iter or max_iter,
                                 rel_function_tolerance=1e-6,
                                 scheduler=LaneSchedulerConfig(**scheduler))
    return (FixedEffectStepSpec(fe_shard, opt, l2_weight=fe_l2),
            (RandomEffectStepSpec(re_type, re_shard, re_opt, l2_weight=re_l2),))


def program(pkg: str, source, task: str = "LOGISTIC_REGRESSION", schedule=None, **kw):
    """A StreamingGameProgram of one package over ``source``."""
    spec_kw = {k: kw.pop(k) for k in ("fe_shard", "re_shard", "re_type", "max_iter", "fe_l2",
                                      "re_l2", "re_max_iter", "scheduler") if k in kw}
    fe, res = specs(pkg, **spec_kw)
    if pkg == "jax":
        from photon_ml_tpu.algorithm.streaming_game import StreamingGameProgram
        from photon_ml_tpu.types import TaskType
    else:
        from photon_ml_torch.algorithm.streaming_game import StreamingGameProgram
        from photon_ml_torch.types import TaskType

        kw.setdefault("device", "cpu")
    return StreamingGameProgram(TaskType[task], source, fe, res, schedule=schedule, **kw)


def duhl(pkg: str, num_chunks: int, working_set: int = 4, tail: int = 1):
    if pkg == "jax":
        from photon_ml_tpu.algorithm.streaming_game import DuHLChunkSchedule, DuHLScheduleConfig
    else:
        from photon_ml_torch.algorithm.streaming_game import DuHLChunkSchedule, DuHLScheduleConfig
    return DuHLChunkSchedule(DuHLScheduleConfig(working_set_chunks=working_set,
                                                tail_chunks_per_sweep=tail), num_chunks)


def state_np(state) -> dict:
    """{"fe": [d], "re/<type>": [E, d]} of either package's state, in f64."""
    out = {"fe": np.asarray(state.fe_coefficients, dtype=np.float64)}
    for k, v in state.re_tables.items():
        out[f"re/{k}"] = np.asarray(v, dtype=np.float64)
    return out


def assert_states_close(got, ref, rel: float) -> None:
    got, ref = state_np(got), state_np(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(np.abs(ref[k]).max(), 1e-300)
        assert np.abs(got[k] - ref[k]).max() <= rel * scale, (k, np.abs(got[k] - ref[k]).max())


def assert_states_equal(got, ref) -> None:
    got, ref = state_np(got), state_np(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
