"""Rank processes of the port's mesh tests: spawned gloo ranks on the CPU.

This module imports no JAX and nothing of the JAX package: the tests build
numpy fixtures (and the JAX package's results) in their own process, hand
each task to :func:`spawn_ranks` as plain data, and compare what the ranks
write back. Every rank joins a ``file://`` rendezvous with a group timeout;
the parent joins every rank with a timeout and fails when one passes, so a
hung collective fails a test instead of stalling the suite.

A task is a dict with a ``kind`` (the ``_task_*`` functions below); each
rank returns a dict, and :func:`spawn_ranks` returns the list of them in
rank order.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

#: collective deadline of the test groups, and the parent's join deadline
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120


def spawn_ranks(world: int, tasks: list, tmp_path, *, timeout_s: float = JOIN_TIMEOUT_S,
                device: str = "cpu", group_timeout_s: float = GROUP_TIMEOUT_S) -> list:
    """Run ``tasks`` in ``world`` spawned ranks (gloo, on the CPU, or with
    ``device="cuda"`` every rank on card 0 with CUDA tensors); returns per
    task the list of the ranks' results. Raises if a rank fails or outlives
    ``timeout_s``. ``group_timeout_s``: the group's collective deadline."""
    import multiprocessing as mp

    tmp = Path(tmp_path)
    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps(tasks))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp), device, group_timeout_s),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [(tmp / f"error{r}.txt") for r in range(world)]
    if alive:
        raise TimeoutError(f"{len(alive)} of {world} ranks still running after {timeout_s} s; "
                           + _rank_report(tmp, world))
    for r, e in enumerate(errors):
        if e.exists():
            raise RuntimeError(f"rank {r} failed:\n{e.read_text()}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"rank exit codes {codes} (a negative code is the signal that "
                           f"ended the rank); " + _rank_report(tmp, world))
    per_rank = [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(world)]
    return [[per_rank[r][i] for r in range(world)] for i in range(len(tasks))]


def _rank_report(tmp: Path, world: int) -> str:
    """Where each rank got to (its last ``progress`` line, with the seconds
    since it started) and any traceback it wrote."""
    lines = []
    for r in range(world):
        progress = tmp / f"progress{r}.txt"
        last = progress.read_text().splitlines()[-1] if progress.exists() else "not started"
        lines.append(f"rank {r}: {last}")
        error = tmp / f"error{r}.txt"
        if error.exists():
            lines.append(error.read_text())
    return "\n".join(lines)


def _rank_main(rank: int, world: int, tmp: str, device: str = "cpu",
               group_timeout_s: float = GROUP_TIMEOUT_S) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)
    from photon_ml_torch.parallel import multihost

    started = time.monotonic()

    def progress(what: str) -> None:
        with open(Path(tmp, f"progress{rank}.txt"), "a") as f:
            f.write(f"{what} at {time.monotonic() - started:.1f} s\n")

    try:
        dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
        progress("joining the group")
        multihost.initialize(f"file://{tmp}/rendezvous", world, rank, device=dev,
                             backend="gloo", local_rank=0 if device == "cuda" else None,
                             timeout=datetime.timedelta(seconds=group_timeout_s))
        tasks = pickle.loads(Path(tmp, "job.pkl").read_bytes())
        out = []
        for i, t in enumerate(tasks):
            progress(f"task {i} ({t['kind']}) started")
            out.append(TASKS[t["kind"]](t, rank, world, Path(tmp)))
        progress("done")
        Path(tmp, f"out{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        Path(tmp, f"error{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        multihost.shutdown()


# -- builders (port side, from numpy) ----------------------------------------


def _opt(spec):
    from photon_ml_torch.optim.optimizer import (
        LaneSchedulerConfig,
        OptimizerConfig,
        OptimizerType,
    )

    kind, iters, kw = spec
    kw = dict(kw)
    if isinstance(kw.get("scheduler"), dict):  # a lane scheduler's fields
        kw["scheduler"] = LaneSchedulerConfig(**kw["scheduler"])
    return OptimizerConfig(optimizer_type=OptimizerType[kind], max_iterations=iters, **kw)


def _shards(shards: dict) -> dict:
    from photon_ml_torch.data.sparse_batch import HybridPolicy, SparseShard

    out = {}
    for k, v in shards.items():
        if isinstance(v, dict):  # COO, with an optional HybridPolicy spec
            v = dict(v)
            hybrid = v.pop("hybrid", None)
            out[k] = SparseShard(**v, hybrid_policy=None if hybrid is None
                                 else HybridPolicy(**hybrid))
        else:
            out[k] = v
    return out


def build_dataset(a: dict, vocabs=None):
    from photon_ml_torch.data import game_data as tgd

    kw = dict(labels=a["labels"], feature_shards=_shards(a["shards"]),
              entity_keys=a["entity_keys"], dtype=a.get("dtype", np.float64), device="cpu")
    for k in ("offsets", "weights", "unique_ids", "ids"):
        if a.get(k) is not None:
            kw[k] = a[k]
    if vocabs is not None:
        kw["entity_vocabs"] = vocabs
    return tgd.build_game_dataset(**kw)


def build_program(p: dict, mesh, fe_feature_sharded: bool = False):
    from photon_ml_torch.parallel import distributed as tdist
    from photon_ml_torch.projector.projectors import ProjectorType
    from photon_ml_torch.types import TaskType

    fe = tdist.FixedEffectStepSpec(p["fe_shard"], _opt(p["fe_opt"]), l2_weight=p["fe_l2"],
                                   down_sampling_rate=p.get("rate", 1.0))
    res = tuple(tdist.RandomEffectStepSpec(
        r["type"], r["shard"], _opt(r["opt"]), l2_weight=r["l2"],
        projector=ProjectorType[r.get("projector", "IDENTITY")]) for r in p.get("res", ()))
    mfs = tuple(tdist.MatrixFactorizationStepSpec(
        m["name"], m["row"], m["col"], num_latent_factors=m["k"], optimizer=_opt(m["opt"]),
        l2_weight=m["l2"], num_alternations=m.get("alternations", 1)) for m in p.get("mfs", ()))
    extra = tuple(tdist.FixedEffectStepSpec(e["shard"], _opt(e["opt"]), l2_weight=e["l2"])
                  for e in p.get("extra_fes", ()))
    return tdist.GameTrainProgram(TaskType[p["task"]], fe, res, mf_specs=mfs, extra_fes=extra,
                                  update_order=p.get("update_order"), mesh=mesh,
                                  use_kernel_fe=p.get("use_kernel_fe"),
                                  normalization=_normalization(p.get("normalization")),
                                  fe_feature_sharded=fe_feature_sharded)


def _normalization(spec):
    """A NormalizationContext from ``{"factors": [...], "shifts": [...]}``."""
    if not spec:
        return None
    from photon_ml_torch import convert

    return convert.normalization_from_numpy(spec.get("factors"), spec.get("shifts"),
                                            device="cpu")


def make_task_mesh(t: dict):
    """The task's ("data", "model") mesh: ``t["mesh"]`` = (data, model), or
    every rank on "data"."""
    from photon_ml_torch.parallel import mesh as M

    data, model = t.get("mesh", (None, 1))
    return M.make_mesh(data=data, model=model)


def build_inputs(p: dict, ds):
    from photon_ml_torch.algorithm import mf_coordinate as tmfc
    from photon_ml_torch.data import game_data as tgd
    from photon_ml_torch.projector.projectors import ProjectorType

    b = tuple(p.get("bucket_sizes", (8, 32, 128)))
    re_ds = {}
    for r in p.get("res", ()):
        kw = dict(bucket_sizes=b)
        if r.get("projector", "IDENTITY") != "IDENTITY" and "sparse" not in r:
            kw["projector_type"] = ProjectorType[r["projector"]]
        if r.get("projected_dim"):
            kw["projected_dim"] = r["projected_dim"]
        re_ds[r["type"]] = tgd.build_random_effect_dataset(ds, r["type"], r["shard"], **kw)
    mf_ds = {m["name"]: tmfc.build_mf_dataset(ds, m["row"], m["col"], bucket_sizes=b)
             for m in p.get("mfs", ())}
    return re_ds, mf_ds


def state_numpy(state) -> dict:
    from photon_ml_torch import convert

    return convert.train_state_to_numpy(state)


# -- tasks -------------------------------------------------------------------


def _task_train(t, rank, world, tmp):
    """train_distributed over the task's mesh (data=world by default) from
    the task's state; ``fe_feature_sharded`` lays the FE over "model", and
    the result then also holds the rank's FE block (``block``) and the
    solver's per-iteration values of every FE solve (``fe_values``)."""
    from photon_ml_torch import convert
    from photon_ml_torch.evaluation import evaluators as tev
    from photon_ml_torch.optim import optimizer as topt
    from photon_ml_torch.parallel import distributed as tdist
    from photon_ml_torch.parallel import mesh as M

    mesh = make_task_mesh(t)
    sharded = t.get("fe_feature_sharded", False)
    ds = build_dataset(t["data"])
    prog = build_program(t["program"], mesh, sharded)
    re_ds, mf_ds = build_inputs(t["program"], ds)
    state = convert.train_state_from_numpy(t["state"], device="cpu") if t.get("state") \
        else None
    kw = dict(t.get("train_kw", {}))
    if t.get("validation"):
        val = build_dataset(t["validation"], vocabs=ds.entity_vocabs)
        kw.update(validation_dataset=val,
                  validation_evaluators=[tev.parse_evaluator(s) for s in t["evaluators"]],
                  validation_eval_data=tev.EvaluationData(
                      labels=val.host_array("labels"), offsets=val.host_array("offsets"),
                      weights=val.host_array("weights"), ids=val.ids))
    fe_values = []
    solve = topt.solve

    def recording_solve(config, objective, w0, **skw):
        result = solve(config, objective, w0, **skw)
        if objective.batch is not None and getattr(objective.objective, "mesh", None) is mesh \
                and config is prog.fe.optimizer:
            fe_values.append({"values": result.value_history.numpy(),
                              "iterations": result.iterations, "reason": result.reason,
                              "length": int(w0.shape[0]),
                              "solution": int(result.coefficients.shape[0])})
        return result

    tdist.solve = recording_solve
    M.counts.reset()
    try:
        res = tdist.train_distributed(prog, ds, re_ds, mf_datasets=mf_ds or None, mesh=mesh,
                                      num_iterations=t.get("sweeps", 3), state=state,
                                      fe_feature_sharded=sharded, **kw)
    finally:
        tdist.solve = solve
    out = {"losses": res.losses, "state": state_numpy(prog.whole_state(res.state)),
           "metric_history": res.metric_history, "best_metric": res.best_metric,
           "collectives": M.counts.snapshot(), "by_axis": M.counts.by_axis(),
           "block": state_numpy(res.state) if sharded else None, "fe_values": fe_values}
    if t.get("score"):
        model = tdist.state_to_game_model(prog, res.state, ds, re_datasets=re_ds)
        out["scores"] = _score_model(model, t, mesh, sharded)
        if sharded:
            out["warm_block"] = state_numpy(tdist.game_model_to_state(prog, model, ds,
                                                                      re_datasets=re_ds))
    return out


def _score_model(model, t, mesh, fe_feature_sharded: bool = False) -> dict:
    from photon_ml_torch.parallel.scoring import DistributedScorer
    from photon_ml_torch.transformers import GameTransformer

    val = build_dataset(t["score"]["data"], vocabs=None)
    scorer = DistributedScorer(model, mesh, fe_feature_sharded=fe_feature_sharded)
    evs = t["score"]["evaluators"]
    return {
        "mesh": scorer.score_dataset(val),
        "one_device": GameTransformer(model).transform(val).scores,
        "evaluate": scorer.evaluate_dataset(val, evs),
        "transform": GameTransformer(model, evs, mesh=mesh,
                                     fe_feature_sharded=fe_feature_sharded
                                     ).transform(val).evaluations,
    }


def _task_objective(t, rank, world, tmp):
    """ShardedDenseGLMObjective on this rank's rows against nothing: the
    parent holds the results against the JAX package's."""
    import torch

    from photon_ml_torch.data.batch import LabeledPointBatch
    from photon_ml_torch.ops.losses import loss_for_task
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel.sharded_dense import ShardedDenseGLMObjective
    from photon_ml_torch.types import TaskType

    mesh = M.make_mesh()
    dtype = getattr(torch, t.get("dtype", "float64"))
    batch = LabeledPointBatch(features=torch.as_tensor(t["x"]).to(dtype),
                              labels=torch.as_tensor(t["y"]), offsets=torch.as_tensor(t["o"]),
                              weights=torch.as_tensor(t["w"]))
    local = M.shard_batch(batch, mesh)
    obj = ShardedDenseGLMObjective(loss_for_task(TaskType[t["task"]]), mesh,
                                   l2_weight=t["l2"], use_kernel=t.get("use_kernel"))
    w = torch.as_tensor(t["coef"])
    v = torch.as_tensor(t["vec"])
    value, grad = obj.value_and_gradient(w, local)
    return {"value": float(value), "grad": grad.numpy(), "value_only": float(obj.value(w, local)),
            "hv": obj.hessian_vector(w, v, local).numpy(), "rows": local.num_samples}


def _task_evaluators(t, rank, world, tmp):
    """Device evaluators over this rank's block of a padded score vector."""
    import torch

    from photon_ml_torch.evaluation import evaluators as tev
    from photon_ml_torch.evaluation import sharded as tsh
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel.distributed import MeshLayout

    mesh = M.make_mesh()
    scores = np.asarray(t["scores"])
    n = len(scores)
    n_pad = n + (-n) % world
    padded = np.concatenate([scores, np.full(n_pad - n, t.get("pad_score", 0.0))])
    rows = M.row_block(n_pad, mesh)
    data = tev.EvaluationData(labels=t["labels"], offsets=np.zeros(n), weights=t["weights"],
                              ids=t.get("ids", {}))
    evs = [tev.parse_evaluator(s) for s in t["evaluators"]]
    devs = tsh.prepare_device_evaluators(evs, data, n_pad=n_pad, device="cpu")
    layout = MeshLayout(mesh=mesh, rows=rows, num_rows=n_pad)
    values = tsh.evaluate_prepared(evs, devs, torch.as_tensor(padded[rows]), data,
                                   lambda: padded[:n], layout=layout)
    return dict(zip(t["evaluators"], values))


def _task_estimator(t, rank, world, tmp):
    """GameEstimator(mesh=...).fit, its models as numpy."""
    from photon_ml_torch import estimators as test_
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.ops.normalization import NormalizationType
    from photon_ml_torch.types import TaskType

    mesh = make_task_mesh(t)
    ds = build_dataset(t["data"])
    val = build_dataset(t["validation"], vocabs=ds.entity_vocabs) if t.get("validation") \
        else None
    configs = {}
    for cid, c in t["coordinates"].items():
        opt = CoordinateOptimizationConfig(optimizer=_opt(c["opt"]), l2_weight=c["l2"],
                                           down_sampling_rate=c.get("rate", 1.0),
                                           compute_variance=c.get("variance", False))
        if c["kind"] == "fe":
            configs[cid] = test_.FixedEffectCoordinateConfig(c["shard"], opt)
        elif c["kind"] == "re":
            configs[cid] = test_.RandomEffectCoordinateConfig(
                c["type"], c["shard"], opt, active_data_upper_bound=c.get("upper"),
                active_data_lower_bound=c.get("lower"))
        else:
            configs[cid] = test_.MatrixFactorizationCoordinateConfig(
                c["row"], c["col"], c["k"], opt, num_alternations=c.get("alternations", 2))
    initial = None
    if t.get("initial"):
        initial = _model_from_numpy(t["initial"], ds)
    est = test_.GameEstimator(TaskType[t["task"]], configs, num_iterations=t["sweeps"],
                              validation_evaluators=tuple(t.get("evaluators", ())),
                              locked_coordinates=frozenset(t.get("locked", ())), mesh=mesh,
                              fe_feature_sharded=t.get("fe_feature_sharded", False),
                              normalization=NormalizationType[t.get("normalization", "NONE")],
                              intercept_indices=t.get("intercepts", {}))
    res = est.fit(ds, validation_dataset=val, initial_model=initial)
    return {"model": _model_numpy(res.model), "best": _model_numpy(res.best_model),
            "best_metric": res.best_metric, "history": res.metric_history}


def _model_numpy(model) -> dict:
    out = {}
    for cid, m in model.models.items():
        if hasattr(m, "glm"):
            c = m.glm.coefficients
            out[cid] = {"means": c.means.numpy(),
                        "variances": None if c.variances is None else c.variances.numpy()}
        elif hasattr(m, "row_factors"):
            out[cid] = {"rows": m.row_factors.numpy(), "cols": m.col_factors.numpy(),
                        "row_keys": np.asarray(m.row_keys), "col_keys": np.asarray(m.col_keys)}
        else:
            out[cid] = {"table": m.coefficients.numpy(), "keys": np.asarray(m.entity_keys)}
    return out


def _model_from_numpy(spec: dict, ds):
    """A GameModel from ``{cid: {"kind": "fe"|"re", ...}}`` numpy arrays."""
    import torch

    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_torch.models.glm import GeneralizedLinearModel
    from photon_ml_torch.types import TaskType

    task = TaskType[spec.pop("__task__")]
    models = {}
    for cid, m in spec.items():
        if m["kind"] == "fe":
            models[cid] = FixedEffectModel(
                glm=GeneralizedLinearModel(Coefficients(means=torch.as_tensor(m["means"])), task),
                feature_shard_id=m["shard"])
        else:
            models[cid] = RandomEffectModel(
                coefficients=torch.as_tensor(m["table"]), entity_keys=np.asarray(m["keys"]),
                random_effect_type=m["type"], feature_shard_id=m["shard"], task=task)
    return GameModel(models=models)


def _task_driver(t, rank, world, tmp):
    """The GAME training and scoring drivers with --distributed (rank 0
    writes the outputs; other ranks write into a scratch directory)."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver

    train = game_training_driver.main(t["train_args"], device="cpu")
    score = game_scoring_driver.main(t["score_args"], device="cpu") if t.get("score_args") \
        else None
    return {"train": _plain(train), "score": _plain(score)}


def _plain(obj):
    """A pickle-safe copy of a driver summary (numbers, strings, lists)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _task_mesh_axes(t, rank, world, tmp):
    """A 1 x world mesh (make_mesh and make_hybrid_mesh): each rank's place
    and the collectives along each axis."""
    import torch

    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.parallel.column_sharded import fe_columns_of

    out = {}
    for name, build in (("make_mesh", M.make_mesh), ("hybrid", multihost.make_hybrid_mesh)):
        mesh = build(data=1, model=world)
        x = torch.tensor([float(rank + 1)], dtype=torch.float64)
        out[name] = {
            "place": (M.data_rank(mesh), M.model_rank(mesh), M.data_size(mesh),
                      M.model_size(mesh)),
            "model_sum": float(M.all_reduce_sum(x, mesh, axis="model")[0]),
            "data_sum": float(M.all_reduce_sum(x, mesh)[0]),
            "model_gather": M.all_gather_rows(x, mesh, axis="model").tolist(),
            "columns": fe_columns_of(7, mesh)}
    return out


def _task_column_objective(t, rank, world, tmp):
    """ColumnShardedGLMObjective over a (1, world) mesh: value, gradient and
    Hv at the task's vectors (whole -> the rank's block), the gradient at a
    vector with non-zero padding lanes, L-BFGS and TRON solves from the
    rank's zero block (with the shapes of the L-BFGS history written), and
    the refusal of a batch of other column blocks."""
    import torch

    from photon_ml_torch.ops.losses import loss_for_task
    from photon_ml_torch.optim import lbfgs as tlbfgs
    from photon_ml_torch.optim import optimizer as topt
    from photon_ml_torch.parallel import column_sharded as CS
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.types import TaskType

    mesh = make_task_mesh(t)
    shard = _shards({"x": t["shard"]})["x"]
    d = shard.feature_dim

    def build(blocks):
        return CS.build_column_sharded_batch(shard, t["y"], blocks, offsets=t["o"],
                                             weights=t["w"], hybrid=t.get("hybrid"),
                                             device="cpu")

    batch = build(M.model_size(mesh))
    local = CS.shard_column_batch(batch, mesh)
    obj = CS.ColumnShardedGLMObjective(loss_for_task(TaskType[t["task"]]), mesh,
                                       l2_weight=t["l2"])
    cols = slice(local.block_index * local.block, (local.block_index + 1) * local.block)

    def block(v, pad_value=0.0):
        padded = np.full(batch.padded_dim, pad_value)
        padded[:d] = v
        return torch.as_tensor(padded[cols])

    w, v = block(t["coef"]), block(t["vec"])
    value, grad = obj.value_and_gradient(w, local)
    out = {"value": float(value), "value_only": float(obj.value(w, local)),
           "grad": grad.numpy(), "hv": obj.hessian_vector(w, v, local).numpy(),
           "columns": (cols.start, cols.stop), "padded_dim": batch.padded_dim,
           "has_hot_head": local.has_hot_head, "block_w_pad": block(t["coef"], 0.3).numpy()}
    out["pad_grad"] = obj.value_and_gradient(block(t["coef"], 0.3), local)[1].numpy()
    shapes = []
    update = tlbfgs.update_history

    def spy(s_hist, y_hist, *args):
        shapes.append((tuple(s_hist.shape), tuple(y_hist.shape)))
        return update(s_hist, y_hist, *args)

    tlbfgs.update_history = spy
    try:
        for kind in t.get("solvers", ()):
            cfg = topt.OptimizerConfig(optimizer_type=topt.OptimizerType[kind],
                                       max_iterations=40)
            r = topt.solve(cfg, obj.bind(local), CS.init_column_sharded_coefficients(local, mesh))
            out[kind] = {"coef": r.coefficients.numpy(), "iterations": r.iterations,
                         "reason": r.reason, "values": r.value_history.numpy()}
    finally:
        tlbfgs.update_history = update
    out["history_shapes"] = sorted(set(shapes))
    try:
        obj.value_and_gradient(w, build(2 * M.model_size(mesh)))
        out["mismatch"] = "no error"
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


# -- partitioned I/O -----------------------------------------------------------


def shard_configs(spec: dict) -> dict:
    """FeatureShardConfigurations from ``{name: kwargs}``."""
    from photon_ml_torch.io.data_reader import FeatureShardConfiguration

    return {k: FeatureShardConfiguration(**v) for k, v in spec.items()}


def read_numpy(part) -> dict:
    """A PartitionedReadResult (or ReadResult) as numpy: its dataset's
    arrays, each sparse shard's coalesced triple and agreed layout, the
    index maps, vocabularies and the partition."""
    result = getattr(part, "result", part)
    ds = result.dataset
    out = {"labels": ds.host_array("labels"), "offsets": ds.host_array("offsets"),
           "weights": ds.host_array("weights"), "unique_ids": np.asarray(ds.unique_ids),
           "vocabs": {k: np.asarray(v) for k, v in ds.entity_vocabs.items()},
           "entity_idx": {k: ds.host_array(f"entity_idx/{k}") for k in ds.entity_idx},
           "ids": {k: np.asarray(v) for k, v in ds.ids.items()},
           "maps": {k: dict(m) for k, m in result.index_maps.items()},
           "intercepts": dict(result.intercept_indices), "shards": {}, "sparse": {}}
    for k, v in ds.feature_shards.items():
        if hasattr(v, "coalesced"):
            r, c, x = (np.asarray(a) for a in v.coalesced())
            policy = v.hybrid_policy
            out["sparse"][k] = {"rows": r, "cols": c, "vals": x, "n": v.num_samples,
                                "dim": v.feature_dim, "ell_width": v.ell_width,
                                "flat_block_nnz": v.flat_block_nnz,
                                "hot_ids": None if policy is None else policy.hot_ids}
        else:
            out["shards"][k] = ds.host_array(f"shard/{k}")
    if hasattr(part, "partition"):
        out.update(partition=dataclasses.astuple(part.partition), mode=part.mode,
                   bytes_decoded=part.bytes_decoded, input_bytes_total=part.input_bytes_total,
                   local_files=[os.path.basename(f) for f in part.local_files],
                   presence={k: np.asarray(v) for k, v in part.entity_rank_presence.items()})
    return out


def _rank_device():
    from photon_ml_torch.parallel import multihost

    return multihost.process_info().device


def _read_part(t, exchange):
    from photon_ml_torch.io.partitioned_reader import read_partitioned

    return read_partitioned(t["path"], shard_configs(t["configs"]), exchange=exchange,
                            random_effect_id_columns=tuple(t.get("re_columns", ())),
                            dtype=np.dtype(t.get("dtype", "float64")), device=_rank_device(),
                            tag=t.get("tag", "read"))


def _task_exchange(t, rank, world, tmp):
    """DistributedKVExchange over the group's store: allgather order,
    repeated tags kept apart, a barrier, then ranks whose calls diverge
    (rank 0 gathers "lonely", rank 1 "elsewhere"): each misses its deadline
    on the other's key."""
    from photon_ml_torch.parallel import multihost

    ex = multihost.default_exchange()
    out = {"type": type(ex).__name__,
           "first": ex.allgather("same", {"rank": rank, "x": [rank] * (rank + 1)}),
           "second": ex.allgather("same", rank * 10)}
    ex.barrier("b")
    short = multihost.DistributedKVExchange(timeout=t.get("timeout", 2.0))
    try:
        short.allgather("lonely" if rank == 0 else "elsewhere", rank)
        out["timeout"] = "no error"
    except TimeoutError as e:
        out["timeout"] = str(e)
    ex.barrier("after")
    return out


def _task_partitioned_read(t, rank, world, tmp):
    """read_partitioned through the group's key-value exchange."""
    from photon_ml_torch.parallel import multihost

    return read_numpy(_read_part(t, multihost.default_exchange()))


def _partitioned_inputs(t, exchange, part):
    from photon_ml_torch.data.game_data import build_random_effect_dataset_partitioned

    b = tuple(t["program"].get("bucket_sizes", (8, 32, 128)))
    return {r["type"]: build_random_effect_dataset_partitioned(
        part.result.dataset, r["type"], r["shard"], partition=part.partition,
        exchange=exchange, bucket_sizes=b,
        entity_rank_presence=part.entity_rank_presence.get(r["type"]))
        for r in t["program"].get("res", ())}


def _task_partitioned_train(t, rank, world, tmp):
    """read_partitioned -> build_random_effect_dataset_partitioned ->
    train_partitioned; beside it (``full``) the same program through the
    full read and train_distributed(mesh=), and (``estimator``)
    GameEstimator(partition=).fit. Over the task's mesh (``t["mesh"]``)
    the partition's ranks are the data ranks, and ``fe_feature_sharded``
    lays the FE over the model axis everywhere."""
    from photon_ml_torch import estimators as test_
    from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
    from photon_ml_torch.io.data_reader import read_merged
    from photon_ml_torch.parallel import distributed as tdist
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.types import TaskType

    mesh = make_task_mesh(t)
    sharded = t.get("fe_feature_sharded", False)
    ex = multihost.default_exchange()
    if M.model_size(mesh) > 1:
        ex = multihost.DataAxisExchange(ex, mesh)
    rank, world = M.data_rank(mesh), M.data_size(mesh)
    part = _read_part(t, ex)
    res = _partitioned_inputs(t, ex, part)
    prog = build_program(t["program"], mesh, sharded)
    M.counts.reset()
    out = {"read": read_numpy(part)}
    from photon_ml_torch.algorithm.lane_scheduler import make_schedulers

    schedulers = make_schedulers(prog.re_specs) or None
    result = tdist.train_partitioned(prog, {rank: (part.result.dataset, res)}, mesh, world,
                                     num_iterations=t.get("sweeps", 2), exchange=ex,
                                     fe_feature_sharded=sharded, schedulers=schedulers)
    if schedulers:
        out["scheduler_stats"] = {k: dataclasses.asdict(v.total_stats)
                                  for k, v in schedulers.items()}
    out.update(losses=result.losses, state=state_numpy(prog.whole_state(result.state)),
               block=state_numpy(result.state) if sharded else None,
               collectives=M.counts.snapshot(),
               buckets={k: [{"entity_rows": b.entity_rows.cpu().numpy(),
                             "sample_rows": b.sample_rows.cpu().numpy(),
                             "weights": b.weights.cpu().numpy()} for b in v.buckets]
                        for k, v in res.items()},
               fingerprint=tdist._partition_fingerprint(prog, {rank: (part.result.dataset,
                                                                      res)}, world))
    if t.get("checkpoint"):
        # one sweep checkpointed into a directory every rank sees, then the
        # whole run resumed from it (rank 0 writes, between barriers)
        from photon_ml_torch.io.checkpoint import TrainingCheckpointer

        ck = TrainingCheckpointer(tmp / "partitioned-ck")
        parts = {rank: (part.result.dataset, res)}
        tdist.train_partitioned(build_program(t["program"], mesh, sharded), parts, mesh, world,
                                num_iterations=1, exchange=ex, fe_feature_sharded=sharded,
                                checkpointer=ck)
        rprog = build_program(t["program"], mesh, sharded)
        again = tdist.train_partitioned(rprog, parts, mesh, world,
                                        num_iterations=t.get("sweeps", 2), exchange=ex,
                                        fe_feature_sharded=sharded, checkpointer=ck)
        out["resumed"] = {"losses": again.losses, "steps": ck.steps(),
                          "state": state_numpy(rprog.whole_state(again.state))}
    if t.get("full"):
        full = read_merged(t["path"], shard_configs(t["configs"]),
                           random_effect_id_columns=tuple(t.get("re_columns", ())),
                           dtype=np.dtype(t.get("dtype", "float64")),
                           device=_rank_device()).dataset
        fprog = build_program(t["program"], mesh, sharded)
        fres, _ = build_inputs(t["program"], full)
        fr = tdist.train_distributed(fprog, full, fres, mesh=mesh,
                                     num_iterations=t.get("sweeps", 2),
                                     fe_feature_sharded=sharded)
        out["full"] = {"losses": fr.losses, "state": state_numpy(fprog.whole_state(fr.state))}
    if t.get("estimator"):
        p = t["program"]
        configs = {"fixed": test_.FixedEffectCoordinateConfig(
            p["fe_shard"], CoordinateOptimizationConfig(optimizer=_opt(p["fe_opt"]),
                                                        l2_weight=p["fe_l2"]))}
        for r in p.get("res", ()):
            configs[r["type"]] = test_.RandomEffectCoordinateConfig(
                r["type"], r["shard"], CoordinateOptimizationConfig(optimizer=_opt(r["opt"]),
                                                                    l2_weight=r["l2"]),
                bucket_sizes=tuple(p.get("bucket_sizes", (8, 32, 128))))
        est = test_.GameEstimator(
            TaskType[p["task"]], configs, num_iterations=t.get("sweeps", 2), mesh=mesh,
            fe_feature_sharded=sharded,
            partition=test_.TrainPartition(info=part.partition, exchange=ex,
                                           entity_rank_presence=part.entity_rank_presence))
        out["estimator"] = _model_numpy(est.fit(part.result.dataset).model)
        out["program_model"] = _model_numpy(tdist.state_to_game_model(
            prog, result.state, part.result.dataset, re_datasets=res))
    if t.get("score"):
        from photon_ml_torch.parallel.scoring import DistributedScorer

        model = tdist.state_to_game_model(prog, result.state, part.result.dataset,
                                          re_datasets=res)
        from photon_ml_torch.io.partitioned_reader import read_partitioned

        # the held-out rows in the model's feature and entity spaces
        val = read_partitioned(t["score"]["path"], shard_configs(t["configs"]), exchange=ex,
                               index_maps=part.result.index_maps,
                               random_effect_id_columns=tuple(t.get("re_columns", ())),
                               entity_vocabs=part.result.dataset.entity_vocabs,
                               dtype=np.dtype(t.get("dtype", "float64")),
                               device=_rank_device(), tag="score")
        scorer = DistributedScorer(model, mesh, fe_feature_sharded=sharded)
        out["scores"] = scorer.score_partitioned({rank: val.result.dataset}, val.partition,
                                                 exchange=ex)[rank]
        out["score_read"] = read_numpy(val)
    return out


def _task_driver_runs(t, rank, world, tmp):
    """Driver runs in order, ``("train" | "score", argv)`` each; a run that
    raises ValueError records its message and the next runs go on."""
    from photon_ml_torch.cli import game_scoring_driver, game_training_driver

    drivers = {"train": game_training_driver, "score": game_scoring_driver}
    out = []
    for which, argv in t["runs"]:
        try:
            out.append({"summary": _plain(drivers[which].main(argv, device="cpu"))})
        except ValueError as e:
            out.append({"error": str(e)})
    return out


class _Killer:
    """An exchange wrapper that raises a transient preemption on ``rank`` at
    its first operation whose tag contains ``tag`` (the operation never
    reaches the store); the coordinator's calls pass through."""

    def __init__(self, inner, tag: str, rank: int, on_fire=None):
        self._inner, self._tag, self._target, self._on_fire = inner, tag, rank, on_fire
        self.fired = 0

    rank = property(lambda self: self._inner.rank)
    num_ranks = property(lambda self: self._inner.num_ranks)
    generation = property(lambda self: self._inner.generation)

    def set_generation(self, generation):
        self._inner.set_generation(generation)

    def fence_namespace(self):
        return self._inner.fence_namespace()

    def post_abort(self, info):
        self._inner.post_abort(info)

    def pending_abort(self):
        return self._inner.pending_abort()

    def _maybe_die(self, tag):
        if self._inner.rank == self._target and self._tag in tag and not self.fired:
            self.fired += 1
            if self._on_fire is not None:
                self._on_fire()
            raise RuntimeError("INTERNAL: device lost: worker preempted by the pool "
                               "scheduler; Socket closed")

    def allgather(self, tag, payload):
        self._maybe_die(tag)
        return self._inner.allgather(tag, payload)

    def barrier(self, tag):
        self._maybe_die(tag)
        return self._inner.barrier(tag)


def _task_driver_recovery(t, rank, world, tmp):
    """The GAME training driver's run ``argv`` over the group with rank 1
    killed once at the sweep-2 commit barrier of the run's
    coordinated-recovery exchange (the one ``multihost.default_exchange``
    hands the driver, wrapped); returns the summary, the kill's count and
    the recovery counters."""
    from photon_ml_torch.cli import game_training_driver
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.resilience import recovery

    real = multihost.default_exchange
    made = []

    def wrapped(*args, **kwargs):
        made.append(_Killer(real(*args, **kwargs), "checkpoint_commit/2/ready", 1))
        return made[-1]

    multihost.default_exchange = wrapped
    recovery.reset_counts()
    try:
        summary = game_training_driver.main(t["argv"], device="cpu")
    finally:
        multihost.default_exchange = real
    return {"summary": _plain(summary), "exchanges": len(made),
            "fired": sum(k.fired for k in made), "counts": dict(recovery.counts)}


class _Rows:
    """A run journal that keeps its rows with their wall-clock times."""

    def __init__(self):
        self.rows = []

    def record(self, kind, **fields):
        import time

        self.rows.append(_plain({"kind": kind, "time": time.time(), **fields}))


def _task_partitioned_recovery(t, rank, world, tmp):
    """train_partitioned under run_with_recovery(coordinator=) over the
    group's fenced key-value exchange, rank 1 killed once in sweep 2: at the
    commit barrier (``fault="commit"``) or inside the sweep's first
    all-gather (``fault="all_gather"``, which leaves rank 0 blocked in a gloo
    collective until the group's timeout). Every restart re-initializes the
    group on a fresh store prefix and rebuilds the mesh. Beside it
    (``reference``) the uninterrupted run."""
    import time

    from photon_ml_torch.io.checkpoint import TrainingCheckpointer
    from photon_ml_torch.parallel import distributed as tdist
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.resilience import CoordinatedRecovery, run_with_recovery

    plain_ex = multihost.default_exchange()
    part = _read_part(t, plain_ex)
    res = _partitioned_inputs(t, plain_ex, part)
    parts = {rank: (part.result.dataset, res)}
    sweeps = t["sweeps"]
    live = {"mesh": make_task_mesh(t)}
    prog = build_program(t["program"], live["mesh"])
    ref = tdist.train_partitioned(prog, parts, live["mesh"], world, num_iterations=sweeps,
                                  exchange=plain_ex)
    out = {"reference": {"losses": ref.losses, "state": state_numpy(prog.whole_state(ref.state))}}

    times = {}
    armed = {"on": False}
    fenced = multihost.DistributedKVExchange()
    killer = _Killer(fenced, "checkpoint_commit/2/ready" if t["fault"] == "commit" else
                     "never", 1, on_fire=lambda: times.setdefault("fault", time.time()))
    real_gather = M.all_gather_rows

    def gather(x, mesh, axis="data"):
        # armed once sweep 1 is committed: the next all-gather is sweep 2's
        if (t["fault"] == "all_gather" and rank == 1 and armed["on"] and not killer.fired):
            killer.fired += 1
            times["fault"] = time.time()
            raise RuntimeError("INTERNAL: device lost: worker preempted by the pool scheduler; "
                               "Socket closed")
        return real_gather(x, mesh, axis)

    class _Arming:
        """Arms the all-gather fault once sweep 1's commit is published."""

        def __getattr__(self, name):
            return getattr(killer, name)

        def barrier(self, tag):
            killer.barrier(tag)
            if tag == "checkpoint_commit/1/published":
                armed["on"] = True

        def allgather(self, tag, payload):
            return killer.allgather(tag, payload)

    exchange = _Arming()
    ck = TrainingCheckpointer(tmp / f"recovery-{t['fault']}")
    journal = _Rows()
    coord = CoordinatedRecovery(exchange, max_restarts=2, checkpointer=ck, journal=journal)
    M.all_gather_rows = gather
    box = {}

    def attempt(restart):
        if restart > 0:
            multihost.reinitialize(f"restart/{fenced.fence_namespace()}")
            live["mesh"] = make_task_mesh(t)
            times.setdefault("resumed", time.time())
        p = build_program(t["program"], live["mesh"])
        r = tdist.train_partitioned(p, parts, live["mesh"], world, num_iterations=sweeps,
                                    exchange=exchange, checkpointer=ck,
                                    resume_step=coord.resume_step)
        box["prog"] = p
        return r

    try:
        result = run_with_recovery(attempt, checkpointer=ck, journal=journal,
                                   coordinator=coord, description=f"rank {rank}")
    finally:
        M.all_gather_rows = real_gather
    restarts = [row for row in journal.rows if row["kind"] == "coordinated_restart"]
    aborts = [row for row in journal.rows if row["kind"] == "peer_abort"]
    out.update(losses=result.losses, state=state_numpy(box["prog"].whole_state(result.state)),
               fired=killer.fired, resume_step=coord.resume_step, generation=coord.generation,
               origin_rank=restarts[0]["origin_rank"] if restarts else None,
               peer_abort_origin=aborts[0]["origin_rank"] if aborts else None,
               t_fault=times.get("fault"), t_resumed=times.get("resumed"))
    return out


def _task_streamed_game(t, rank, world, tmp):
    """plan_partitioned_game_stream and StreamingGameProgram over the
    group's key-value exchange (``schedule``: a DuHL budget), and
    (``kill``) the same run with rank 1 killed at the sweep-2 commit under
    run_with_recovery(coordinator=); returns each run's losses, state,
    chunk loads and DuHL decisions."""
    from photon_ml_torch.algorithm.streaming_game import (
        DuHLChunkSchedule,
        DuHLScheduleConfig,
        StreamingGameProgram,
    )
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer
    from photon_ml_torch.io.stream_reader import plan_partitioned_game_stream
    from photon_ml_torch.optim.optimizer import OptimizerConfig
    from photon_ml_torch.parallel import distributed as tdist
    from photon_ml_torch.parallel import multihost
    from photon_ml_torch.resilience import CoordinatedRecovery, run_with_recovery
    from photon_ml_torch.types import TaskType

    def run(exchange, checkpointer=None, resume_step=None):
        source, maps, vocabs, partition = plan_partitioned_game_stream(
            t["path"], shard_configs(t["configs"]), ("userId",), exchange=exchange,
            chunk_records=t["chunk_records"], cluster_by="userId", dtype=np.float64)
        opt = OptimizerConfig(max_iterations=t.get("max_iter", 4))
        schedule = None
        if t.get("working_set"):
            schedule = DuHLChunkSchedule(DuHLScheduleConfig(working_set_chunks=t["working_set"]),
                                         partition.num_chunks)
        program = StreamingGameProgram(
            TaskType.LINEAR_REGRESSION, source,
            tdist.FixedEffectStepSpec("global", opt, l2_weight=0.1),
            (tdist.RandomEffectStepSpec("userId", "global", opt, l2_weight=1.0),),
            num_entities={"userId": len(vocabs["userId"])}, schedule=schedule,
            exchange=exchange, partition=partition, device="cpu")
        pins = []
        real_set = program._cache.set_pinned

        def set_pinned(pinned):
            pins.append(sorted(int(g) + program._chunk_lo for g in pinned))
            real_set(pinned)

        program._cache.set_pinned = set_pinned
        result = program.train(num_sweeps=t["sweeps"], checkpointer=checkpointer,
                               resume_step=resume_step)
        return {"losses": result.losses,
                "fe": result.state.fe_coefficients.numpy(),
                "user": result.state.re_tables["userId"].numpy(),
                "chunk_loads": result.chunk_loads, "pins": pins,
                "partition": dataclasses.asdict(partition)}

    out = {"plain": run(multihost.default_exchange())}
    if t.get("kill"):
        fenced = multihost.DistributedKVExchange()
        killer = _Killer(fenced, "checkpoint_commit/2", 1)
        ck = TrainingCheckpointer(tmp / "streamed-ck")
        journal = _Rows()
        coord = CoordinatedRecovery(killer, max_restarts=2, checkpointer=ck, journal=journal)
        got = run_with_recovery(
            lambda restart: run(killer, ck, coord.resume_step), checkpointer=ck,
            journal=journal, coordinator=coord, description=f"rank {rank}")
        aborts = [row for row in journal.rows if row["kind"] == "peer_abort"]
        out["killed"] = dict(got, fired=killer.fired, resume_step=coord.resume_step,
                             peer_abort_origin=aborts[0]["origin_rank"] if aborts else None)
    return out


TASKS = {
    "train": _task_train,
    "objective": _task_objective,
    "evaluators": _task_evaluators,
    "estimator": _task_estimator,
    "driver": _task_driver,
    "driver_recovery": _task_driver_recovery,
    "mesh_axes": _task_mesh_axes,
    "column_objective": _task_column_objective,
    "exchange": _task_exchange,
    "partitioned_read": _task_partitioned_read,
    "partitioned_train": _task_partitioned_train,
    "driver_runs": _task_driver_runs,
    "partitioned_recovery": _task_partitioned_recovery,
    "streamed_game": _task_streamed_game,
}
