"""The JAX side of the port's mesh tests: numpy fixtures as task specs for
``tests/torch_mesh_worker.py``, and the same specs built and trained by the
JAX package on the 8-device virtual CPU mesh (``tests/conftest.py``), all
in float64."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from photon_ml_tpu.algorithm import mf_coordinate as jmfc
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.projector.projectors import ProjectorType
from photon_ml_tpu.types import TaskType


def jmesh(data: int):
    return make_mesh(data=data, model=1)


def arrays(seed: int = 0, n: int = 203, users: int = 13, items: int = 7, d_fe: int = 5,
           d_re: int = 3, sparse: str | None = None, zero_share: float = 0.0,
           task: str = "LOGISTIC_REGRESSION") -> dict:
    """A numpy GAME fixture whose row and entity counts divide neither 2
    nor 4: planted fixed, per-user and per-item effects, offsets, weights
    with zeros, a query id column. ``sparse`` "fe" makes the fixed-effect
    shard sparse (COO, half its entries dropped, wider than dense); "both"
    puts the per-user effect on that sparse shard too."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, users, size=n)
    it = rng.integers(0, items, size=n)
    xg = rng.normal(size=(n, d_fe))
    xg[:, -1] = 1.0
    xr = rng.normal(size=(n, d_re))
    xr[:, -1] = 1.0
    if zero_share:
        xr[:, :-1][rng.uniform(size=(n, d_re - 1)) < zero_share] = 0.0
    z = xg @ rng.normal(size=d_fe) / np.sqrt(d_fe) \
        + np.einsum("nd,nd->n", xr, 0.7 * rng.normal(size=(users, d_re))[u])
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(np.float64)
    else:
        y = z + 0.1 * rng.normal(size=n)
    w = rng.uniform(0.5, 1.5, size=n)
    w[::11] = 0.0
    shards: dict = {"global": xg, "per_entity": xr}
    if sparse:
        wide = np.concatenate([xg, rng.normal(size=(n, 9))], axis=1)
        wide[:, :-1][rng.uniform(size=(n, wide.shape[1] - 1)) < 0.5] = 0.0
        rows, cols = np.nonzero(wide)
        coo = dict(rows=rows, cols=cols, vals=wide[rows, cols], num_samples=n,
                   feature_dim=wide.shape[1])
        shards["global"] = coo
        if sparse == "both":
            shards["per_entity"] = coo
    return dict(labels=y, shards=shards,
                entity_keys={"user": np.array([f"u{i}" for i in u]),
                             "item": np.array([f"i{i}" for i in it])},
                offsets=0.05 * rng.normal(size=n), weights=w,
                unique_ids=rng.permutation(n).astype(np.int64) + 1000,
                ids={"queryId": rng.integers(0, 6, size=n)})


def split(a: dict, held: int) -> tuple[dict, dict]:
    """(training, validation) rows of an ``arrays`` fixture of dense shards."""
    def part(sl):
        out = {k: (v[sl] if isinstance(v, np.ndarray) else v) for k, v in a.items()
               if k not in ("shards", "entity_keys", "ids")}
        out["shards"] = {k: v[sl] for k, v in a["shards"].items()}
        out["entity_keys"] = {k: v[sl] for k, v in a["entity_keys"].items()}
        out["ids"] = {k: v[sl] for k, v in a["ids"].items()}
        return out

    n = len(a["labels"])
    return part(slice(0, n - held)), part(slice(n - held, n))


def jdataset(a: dict, vocabs=None):
    shards = {k: jsb.SparseShard(**v) if isinstance(v, dict) else v
              for k, v in a["shards"].items()}
    kw = dict(labels=a["labels"], feature_shards=shards, entity_keys=a["entity_keys"],
              offsets=a["offsets"], weights=a["weights"], unique_ids=a["unique_ids"],
              ids=a.get("ids") or {}, dtype=np.float64)
    if vocabs is not None:
        kw["entity_vocabs"] = vocabs
    return jgd.build_game_dataset(**kw)


def _opt(spec):
    from photon_ml_tpu.optim.optimizer import LaneSchedulerConfig

    kind, iters, kw = spec
    kw = dict(kw)
    if isinstance(kw.get("scheduler"), dict):  # a lane scheduler's fields
        kw["scheduler"] = LaneSchedulerConfig(**kw["scheduler"])
    return OptimizerConfig(optimizer_type=OptimizerType[kind], max_iterations=iters, **kw)


def jprogram(p: dict, mesh):
    fe = jdist.FixedEffectStepSpec(p["fe_shard"], _opt(p["fe_opt"]), l2_weight=p["fe_l2"],
                                   down_sampling_rate=p.get("rate", 1.0))
    res = tuple(jdist.RandomEffectStepSpec(
        r["type"], r["shard"], _opt(r["opt"]), l2_weight=r["l2"],
        projector=ProjectorType[r.get("projector", "IDENTITY")]) for r in p.get("res", ()))
    mfs = tuple(jdist.MatrixFactorizationStepSpec(
        m["name"], m["row"], m["col"], num_latent_factors=m["k"], optimizer=_opt(m["opt"]),
        l2_weight=m["l2"], num_alternations=m.get("alternations", 1)) for m in p.get("mfs", ()))
    extra = tuple(jdist.FixedEffectStepSpec(e["shard"], _opt(e["opt"]), l2_weight=e["l2"])
                  for e in p.get("extra_fes", ()))
    return jdist.GameTrainProgram(TaskType[p["task"]], fe, res, mf_specs=mfs, extra_fes=extra,
                                  update_order=p.get("update_order"), mesh=mesh,
                                  use_pallas_fe=False)


def jinputs(p: dict, ds):
    b = tuple(p.get("bucket_sizes", (8, 32, 128)))
    re_ds = {}
    for r in p.get("res", ()):
        kw = dict(bucket_sizes=b)
        if r.get("projector", "IDENTITY") != "IDENTITY" and "sparse" not in r:
            kw["projector_type"] = ProjectorType[r["projector"]]
        re_ds[r["type"]] = jgd.build_random_effect_dataset(ds, r["type"], r["shard"], **kw)
    mf_ds = {m["name"]: jmfc.build_mf_dataset(ds, m["row"], m["col"], bucket_sizes=b)
             for m in p.get("mfs", ())}
    return re_ds, mf_ds


def state_numpy(state) -> dict:
    """A JAX GameTrainState as the worker's numpy dict."""
    groups = ("re_tables", "mf_rows", "mf_cols", "extra_fe")
    return {"fe_coefficients": np.asarray(state.fe_coefficients),
            **{g: {k: np.asarray(v) for k, v in getattr(state, g).items()} for g in groups}}


def jtrain(task: dict, data_axis: int):
    """The JAX package's train_distributed of a worker ``train`` task over a
    data=``data_axis`` mesh, from the task's state: (result, program,
    dataset, re_datasets)."""
    mesh = jmesh(data_axis)
    ds = jdataset(task["data"])
    prog = jprogram(task["program"], mesh)
    re_ds, mf_ds = jinputs(task["program"], ds)
    st = task["state"]
    state = jdist.GameTrainState(
        fe_coefficients=jnp.asarray(st["fe_coefficients"]),
        re_tables={k: jnp.asarray(v) for k, v in st["re_tables"].items()},
        mf_rows={k: jnp.asarray(v) for k, v in st["mf_rows"].items()},
        mf_cols={k: jnp.asarray(v) for k, v in st["mf_cols"].items()},
        extra_fe={k: jnp.asarray(v) for k, v in st["extra_fe"].items()})
    kw = dict(task.get("train_kw", {}))
    if task.get("validation"):
        val = jdataset(task["validation"], vocabs=ds.entity_vocabs)
        kw.update(validation_dataset=val,
                  validation_evaluators=[jev.parse_evaluator(s) for s in task["evaluators"]],
                  validation_eval_data=jev.EvaluationData(
                      labels=np.asarray(val.labels), offsets=np.asarray(val.offsets),
                      weights=np.asarray(val.weights), ids=val.ids))
    res = jdist.train_distributed(prog, ds, re_ds, mf_datasets=mf_ds or None, mesh=mesh,
                                  num_iterations=task.get("sweeps", 3), state=state, **kw)
    return res, prog, ds, re_ds


def jinit_state(task: dict) -> dict:
    """The JAX program's initial state of a task, as numpy (MF factors from
    the JAX package's draw, carried to both sides)."""
    ds = jdataset(task["data"])
    prog = jprogram(task["program"], None)
    re_ds, mf_ds = jinputs(task["program"], ds)
    return state_numpy(prog.init_state(ds, re_ds, mf_ds or None))


def assert_states_close(got: dict, ref: dict, rel: float) -> None:
    """Every tensor within ``rel`` of its largest magnitude."""
    np.testing.assert_allclose(got["fe_coefficients"], ref["fe_coefficients"], rtol=rel,
                               atol=rel * max(np.abs(ref["fe_coefficients"]).max(), 1e-30))
    for group in ("re_tables", "mf_rows", "mf_cols", "extra_fe"):
        assert sorted(got[group]) == sorted(ref[group]), group
        for k, r in ref[group].items():
            scale = np.nanmax(np.abs(r)) if r.size else 1.0
            np.testing.assert_allclose(got[group][k], r, rtol=rel, atol=rel * scale,
                                       err_msg=f"{group}/{k}")
