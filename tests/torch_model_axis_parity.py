"""The JAX side of the port's model-axis tests: the same numpy specs as
``tests/torch_mesh_parity.py``, trained, scored and fitted by the JAX package
with the fixed effect feature-sharded over a ("data", "model") mesh of its
8-device virtual CPU mesh (``tests/conftest.py``), in float64."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.ops.normalization import NormalizationContext as JNorm
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.parallel.scoring import DistributedScorer as JScorer
from tests import torch_mesh_parity as MP

#: the mesh shapes of the tests: (data, model)
SHAPES = ((1, 2), (2, 2))


def jmesh(data: int, model: int):
    return make_mesh(data=data, model=model)


def jprogram(p: dict, mesh, fe_feature_sharded: bool = True):
    """``MP.jprogram`` with the spec's normalization and the model axis."""
    prog = MP.jprogram(p, mesh)
    norm = p.get("normalization")
    if not norm and not fe_feature_sharded:
        return prog
    fe = jdist.FixedEffectStepSpec(p["fe_shard"], MP._opt(p["fe_opt"]), l2_weight=p["fe_l2"],
                                   down_sampling_rate=p.get("rate", 1.0))
    return jdist.GameTrainProgram(
        prog.task, fe, prog.re_specs, mf_specs=prog.mf_specs, extra_fes=prog.extra_fes,
        update_order=p.get("update_order"), mesh=mesh, use_pallas_fe=False,
        normalization=None if not norm else JNorm(
            None if norm.get("factors") is None else jnp.asarray(norm["factors"]),
            None if norm.get("shifts") is None else jnp.asarray(norm["shifts"])),
        fe_feature_sharded=fe_feature_sharded)


def jstate(st: dict):
    return jdist.GameTrainState(
        fe_coefficients=jnp.asarray(st["fe_coefficients"]),
        re_tables={k: jnp.asarray(v) for k, v in st["re_tables"].items()},
        mf_rows={k: jnp.asarray(v) for k, v in st["mf_rows"].items()},
        mf_cols={k: jnp.asarray(v) for k, v in st["mf_cols"].items()},
        extra_fe={k: jnp.asarray(v) for k, v in st["extra_fe"].items()})


def jdataset(a: dict, vocabs=None):
    """``MP.jdataset``; a COO shard spec may carry ``hybrid`` (HybridPolicy
    keyword arguments)."""
    from photon_ml_tpu.data import game_data as jgd

    def shard(v):
        if not isinstance(v, dict):
            return v
        v = dict(v)
        hybrid = v.pop("hybrid", None)
        return jsb.SparseShard(**v, hybrid_policy=None if hybrid is None
                               else jsb.HybridPolicy(**hybrid))

    kw = dict(labels=a["labels"], feature_shards={k: shard(v) for k, v in a["shards"].items()},
              entity_keys=a["entity_keys"], offsets=a["offsets"], weights=a["weights"],
              unique_ids=a["unique_ids"], ids=a.get("ids") or {}, dtype=np.float64)
    if vocabs is not None:
        kw["entity_vocabs"] = vocabs
    return jgd.build_game_dataset(**kw)


def jtrain(task: dict, shape=None):
    """The JAX package's train_distributed of a worker ``train`` task: over a
    (data, model) mesh with the FE feature-sharded, or on one device with
    ``shape`` None. Returns (result, program, dataset, re_datasets)."""
    mesh = None if shape is None else jmesh(*shape)
    ds = jdataset(task["data"])
    prog = jprogram(task["program"], mesh, fe_feature_sharded=shape is not None)
    re_ds, mf_ds = MP.jinputs(task["program"], ds)
    res = jdist.train_distributed(prog, ds, re_ds, mf_datasets=mf_ds or None, mesh=mesh,
                                  num_iterations=task.get("sweeps", 2),
                                  state=jstate(task["state"]),
                                  fe_feature_sharded=shape is not None)
    return res, prog, ds, re_ds


def jscores(task: dict, shape) -> np.ndarray:
    """The JAX DistributedScorer's scores of the task's held-out rows with the
    FE feature-sharded, from the JAX package's own trained model."""
    res, prog, ds, re_ds = jtrain(task, shape)
    model = jdist.state_to_game_model(prog, res.state, ds, re_datasets=re_ds)
    val = jdataset(task["score"]["data"], vocabs=ds.entity_vocabs)
    return JScorer(model, jmesh(*shape), fe_feature_sharded=True).score_dataset(val)


def jinit_state(task: dict) -> dict:
    """The JAX program's initial state of a task as numpy."""
    ds = jdataset(task["data"])
    prog = jprogram(task["program"], None, fe_feature_sharded=False)
    re_ds, mf_ds = MP.jinputs(task["program"], ds)
    return MP.state_numpy(prog.init_state(ds, re_ds, mf_ds or None))


def standardization(a: dict) -> dict:
    """Factors and shifts of the fixed-effect shard (its last column the
    intercept: factor 1, shift 0), as a program spec's normalization."""
    x = np.asarray(a["shards"]["global"])
    std = x.std(axis=0)
    factors = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    shifts = x.mean(axis=0)
    factors[-1], shifts[-1] = 1.0, 0.0
    return {"factors": factors, "shifts": shifts}


