"""The port's fused program over a data-axis mesh, against the JAX package's
mesh program and against its own one-device program, in float64 on the CPU.

The port runs in spawned gloo ranks (``tests/torch_mesh_worker.py``, one
group of 2 and one of 4 ranks for the whole file); the JAX package runs in
this process on the 8-device virtual CPU mesh, data=2 or data=4. The
fixtures' row and entity counts divide neither 2 nor 4, so the padding of
rows and of bucket lanes is on every path.
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.evaluation import sharded as jsh
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.data.batch import LabeledPointBatch as JBatch
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.parallel.scoring import DistributedScorer as JScorer
from photon_ml_tpu.parallel.sharded_dense import ShardedDenseGLMObjective as JSharded
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch.data.batch import LabeledPointBatch as TBatch
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.ops.losses import loss_for_task as tloss_for_task
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.types import TaskType as TTask
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W

LBFGS = ("LBFGS", 10, {})


def _program(res=(), mfs=(), **kw):
    return dict(task=kw.pop("task", "LOGISTIC_REGRESSION"), fe_shard="global", fe_opt=LBFGS,
                fe_l2=0.5, res=list(res), mfs=list(mfs), **kw)


def _re(t, shard="per_entity", **kw):
    return dict(type=t, shard=shard, opt=LBFGS, l2=1.0, **kw)


MF = dict(name="mf", row="user", col="item", k=2, opt=LBFGS, l2=2.0, alternations=2)


def _train_tasks() -> dict:
    """name -> worker train task (with its initial state from the JAX
    package's init_state)."""
    dense, val = MP.split(MP.arrays(0, n=263), 60)
    tasks = {
        # dense FE + per-user + per-item + MF, scored on held-out rows
        "dense_all": dict(kind="train", data=dense, program=_program(
            (_re("user"), _re("item")), (MF,)),
            score=dict(data=val, evaluators=["AUC", "RMSE", "AUC:queryId"])),
        # a sparse fixed effect and a compact per-user effect on its shard
        "sparse_compact": dict(kind="train", data=MP.arrays(1, sparse="both",
                                                            task="LINEAR_REGRESSION"),
                               program=_program((_re("user", "global",
                                                     projector="INDEX_MAP"),),
                                                task="LINEAR_REGRESSION")),
        # a sparse fixed effect and an INDEX_MAP per-user effect on a dense
        # shard with zeros
        "indexmap": dict(kind="train", data=MP.arrays(2, sparse="fe", zero_share=0.4),
                         program=_program((_re("user", projector="INDEX_MAP"),))),
        # per-sweep validation through the device evaluators, best-state tracking
        "validation": dict(kind="train", data=dense, program=_program((_re("user"),)),
                           validation=val, evaluators=["AUC", "RMSE", "RMSE:queryId"]),
    }
    for t in tasks.values():
        t["state"] = MP.jinit_state(t)
    return tasks


def _objective_tasks() -> dict:
    rng = np.random.default_rng(7)
    n, d = 101, 6
    base = dict(kind="objective", x=rng.normal(size=(n, d)), y=(rng.uniform(size=n) < 0.5) * 1.0,
                o=0.1 * rng.normal(size=n), w=rng.uniform(0.5, 1.5, size=n),
                coef=0.3 * rng.normal(size=d), vec=rng.normal(size=d), l2=0.7,
                task="LOGISTIC_REGRESSION")
    return {"f64": base,
            "kernel_path_f32": dict(base, use_kernel=True, task="POISSON_REGRESSION",
                                    y=rng.poisson(1.0, size=n) * 1.0),
            "bf16": dict(base, dtype="bfloat16")}


def _evaluator_task() -> dict:
    rng = np.random.default_rng(9)
    n = 157
    scores = np.round(rng.normal(size=n), 1)  # ties
    w = rng.uniform(0.5, 1.5, size=n)
    w[::7] = 0.0
    return dict(kind="evaluators", scores=scores, labels=(rng.uniform(size=n) < 0.4) * 1.0,
                weights=w, ids={"queryId": rng.integers(0, 9, size=n)}, pad_score=50.0,
                evaluators=["AUC", "AUPR", "RMSE", "MAE", "LOGISTIC_LOSS", "SQUARED_LOSS",
                            "POISSON_LOSS", "SMOOTHED_HINGE_LOSS", "AUC:queryId",
                            "RMSE:queryId", "PRECISION@3:queryId"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups run once a test run (the xdist workers share one
    build, ``torch_mesh_worker.run_once``): world -> name -> per-rank
    results."""
    return W.run_once("mesh_training", _build_runs, tmp_path_factory.mktemp("mesh-training"))


def _build_runs(base) -> dict:
    trains = _train_tasks()
    objectives = _objective_tasks()
    groups = {2: {**trains, **{f"objective_{k}": v for k, v in objectives.items()},
                  "evaluators": _evaluator_task(), "mesh_axes": dict(kind="mesh_axes")},
              4: {"dense_all": trains["dense_all"], "objective_f64": objectives["f64"],
                  "evaluators": _evaluator_task()}}
    out = {}
    for world, tasks in groups.items():
        names = list(tasks)
        spawn_dir = base / f"ranks{world}"
        spawn_dir.mkdir(parents=True)
        results = W.spawn_ranks(world, [tasks[k] for k in names], spawn_dir)
        out[world] = dict(zip(names, results))
    return {"results": out, "trains": trains, "objectives": objectives}


@pytest.mark.parametrize("world,case", [(2, "f64"), (2, "kernel_path_f32"), (2, "bf16"),
                                        (4, "f64")])
def test_sharded_dense_objective_matches_the_jax_package(runs, world, case):
    """Value, gradient and Hv summed over the ranks at rel 1e-10 of the JAX
    package's shard_map objective in f64 (2e-6 on the kernel path, whose
    plain version is f32; a bf16 block at the bf16 tolerance of the
    one-device parity test), and at 1e-12 of the port's one-device
    objective on the whole batch; the rows of 101 divide neither 2 nor 4."""
    t = runs["objectives"][case]
    got = runs["results"][world][f"objective_{case}"]
    dtype = {"bfloat16": "bfloat16"}.get(t.get("dtype"), "float64")
    import jax.numpy as jnp

    batch = JBatch(features=jnp.asarray(t["x"], dtype=dtype), labels=jnp.asarray(t["y"]),
                   offsets=jnp.asarray(t["o"]), weights=jnp.asarray(t["w"]))
    obj = JSharded(jloss_for_task(JTask[t["task"]]), MP.jmesh(world), l2_weight=t["l2"],
                   use_pallas=False)
    w, v = jnp.asarray(t["coef"]), jnp.asarray(t["vec"])
    value, grad = obj.value_and_gradient(w, batch)
    hv = obj.hessian_vector(w, v, batch)
    # B1's plain version (the kernel path on the CPU) computes in f32; JAX
    # rounds a bf16 block's X'r to bf16 through its matmul transpose, the
    # port keeps it in f32 (tests/test_torch_objective.py's bf16 tolerance)
    rel = {"f64": 1e-10, "kernel_path_f32": 2e-6, "bf16": 1e-6}[case]
    grad_rel = 5e-2 if case == "bf16" else rel
    # the port's own one-device objective on the whole batch
    one = GLMObjective(tloss_for_task(TTask[t["task"]]), l2_weight=t["l2"],
                       use_kernel=t.get("use_kernel"))
    tb = TBatch(features=torch.as_tensor(t["x"]).to(getattr(torch, dtype)),
                labels=torch.as_tensor(t["y"]), offsets=torch.as_tensor(t["o"]),
                weights=torch.as_tensor(t["w"]))
    tv, tg = one.value_and_gradient(torch.as_tensor(t["coef"]), tb)
    thv = one.hessian_vector(torch.as_tensor(t["coef"]), torch.as_tensor(t["vec"]), tb)
    own = 1e-12 if case != "kernel_path_f32" else 2e-6
    for r in got:
        assert r["rows"] == -(-101 // world)  # each rank's padded block
        assert r["value"] == pytest.approx(float(value), rel=rel)
        assert r["value_only"] == pytest.approx(float(obj.value(w, batch)), rel=rel)
        np.testing.assert_allclose(r["grad"], np.asarray(grad), rtol=grad_rel,
                                   atol=grad_rel * np.abs(np.asarray(grad)).max())
        np.testing.assert_allclose(r["hv"], np.asarray(hv), rtol=grad_rel,
                                   atol=grad_rel * np.abs(np.asarray(hv)).max())
        assert r["value"] == pytest.approx(float(tv), rel=own)
        np.testing.assert_allclose(r["grad"], tg.numpy(), rtol=own,
                                   atol=own * float(tg.abs().max()))
        np.testing.assert_allclose(r["hv"], thv.numpy(), rtol=own,
                                   atol=own * float(thv.abs().max()))
    assert all(np.array_equal(r["grad"], got[0]["grad"]) for r in got)


@pytest.mark.parametrize("world,name", [(2, "dense_all"), (4, "dense_all"), (2, "sparse_compact"),
                                        (2, "indexmap"), (2, "validation")])
def test_mesh_training_matches_the_jax_mesh_program(runs, world, name):
    """train_distributed over data=2 and data=4 in both packages from one
    state: states and losses at rel 1e-8, every rank with the same state."""
    task = runs["trains"][name]
    got = runs["results"][world][name]
    jres, *_ = MP.jtrain(task, world)
    ref = MP.state_numpy(jres.state)
    for r in got:
        MP.assert_states_close(r["state"], ref, 1e-8)
        np.testing.assert_allclose(r["losses"], jres.losses, rtol=1e-8)
    for r in got[1:]:
        for key in ("fe_coefficients",):
            assert np.array_equal(r["state"][key], got[0]["state"][key])
    if name == "validation":
        assert got[0]["best_metric"] == pytest.approx(jres.best_metric, rel=1e-8)
        assert len(got[0]["metric_history"]) == len(jres.metric_history) == 3
        for a, b in zip(got[0]["metric_history"], jres.metric_history):
            assert set(a) == set(b)
            for k in a:
                if k.startswith(("validate:", "train:")):
                    assert a[k] == pytest.approx(b[k], rel=1e-8), k


@pytest.mark.parametrize("world,name", [(2, "dense_all"), (4, "dense_all"), (2, "sparse_compact"),
                                        (2, "indexmap")])
def test_mesh_training_matches_the_one_device_program(runs, world, name):
    """The port's mesh program against its own mesh=None program on the same
    data and state: rel 1e-10 (only the f64 sum order differs); the
    collectives per sweep are the same on every rank."""
    task = runs["trains"][name]
    got = runs["results"][world][name]
    ds = W.build_dataset(task["data"])
    prog = W.build_program(task["program"], None)
    re_ds, mf_ds = W.build_inputs(task["program"], ds)
    from photon_ml_torch import convert

    res = tdist.train_distributed(prog, ds, re_ds, mf_datasets=mf_ds or None,
                                  num_iterations=task.get("sweeps", 3),
                                  state=convert.train_state_from_numpy(task["state"],
                                                                       device="cpu"))
    MP.assert_states_close(got[0]["state"], W.state_numpy(res.state), 1e-10)
    np.testing.assert_allclose(got[0]["losses"], res.losses, rtol=1e-12)
    assert all(r["collectives"] == got[0]["collectives"] for r in got)
    calls = got[0]["collectives"]
    assert calls["all_reduce"]["calls"] > 0
    if task["program"]["res"] or task["program"]["mfs"]:
        assert calls["all_gather"]["calls"] > 0


def test_device_evaluators_match_the_jax_package_and_the_host(runs):
    """Every device metric (ties, weight-0 rows, pads planted with a large
    score) equals the JAX package's device metric and the host evaluator's
    at 1e-12, at 2 and 4 ranks."""
    t = _evaluator_task()
    data = jev.EvaluationData(labels=t["labels"], offsets=np.zeros(len(t["labels"])),
                              weights=t["weights"], ids=t["ids"])
    for world in (2, 4):
        got = runs["results"][world]["evaluators"]
        n = len(t["scores"])
        n_pad = n + (-n) % world
        evs = [jev.parse_evaluator(s) for s in t["evaluators"]]
        devs = jsh.prepare_device_evaluators(evs, data, n_pad=n_pad)
        padded = np.concatenate([t["scores"], np.full(n_pad - n, t["pad_score"])])
        for spec, ev, dev in zip(t["evaluators"], evs, devs):
            host = tev.parse_evaluator(spec).evaluate(t["scores"], tev.EvaluationData(
                labels=t["labels"], offsets=np.zeros(n), weights=t["weights"], ids=t["ids"]))
            jval = float(jsh.jit_metric(dev.compute, padded, dev.consts))
            for r in got:
                assert r[spec] == pytest.approx(host, rel=1e-12, abs=1e-12), spec
                assert r[spec] == pytest.approx(jval, rel=1e-12, abs=1e-12), spec


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_scorer_matches_the_jax_scorer(runs, world):
    """DistributedScorer over the mesh: scores at rel 1e-12 of the port's
    one-device transform and at 1e-8 of the JAX package's DistributedScorer
    on its own trained model (the states agree at 1e-8); the device
    metrics and the mesh transform's host metrics agree."""
    task = runs["trains"]["dense_all"]
    got = runs["results"][world]["dense_all"][0]["scores"]
    scale = np.abs(got["one_device"]).max()
    np.testing.assert_allclose(got["mesh"], got["one_device"], rtol=1e-12, atol=1e-12 * scale)
    jres, jprog, jds, jre = MP.jtrain(task, world)
    jmodel = jdist.state_to_game_model(jprog, jres.state, jds, re_datasets=jre)
    val = MP.jdataset(task["score"]["data"], vocabs=jds.entity_vocabs)
    jscores = JScorer(jmodel, MP.jmesh(world)).score_dataset(val)
    np.testing.assert_allclose(got["mesh"], jscores, rtol=1e-7, atol=1e-7 * scale)
    for spec in task["score"]["evaluators"]:
        assert got["evaluate"][spec] == pytest.approx(got["transform"][spec], rel=1e-10)


def test_model_axis_mesh_in_a_group(runs):
    """In a group of 2, make_mesh and make_hybrid_mesh build a 1x2 mesh:
    rank r sits at (0, r); a model-axis all-reduce sums both ranks, a
    data-axis one only the rank itself; each rank's feature block of 7
    columns is ceil(7/2) wide, the last one padded."""
    got = runs["results"][2]["mesh_axes"]
    for r, ranks in enumerate(got):
        for name, v in ranks.items():
            assert v["place"] == [0, r, 1, 2] or v["place"] == (0, r, 1, 2), (name, v)
            assert v["model_sum"] == 3.0 and v["data_sum"] == r + 1.0
            assert v["model_gather"] == [1.0, 2.0]
            assert tuple(v["columns"]) == (4 * r, 4, 7)


def test_ranks_in_a_group_hold_one_model(runs):
    """Every rank of every group returns the same state bitwise (the tables
    are shared through the same all-gathers on every rank)."""
    for world in (2, 4):
        got = runs["results"][world]["dense_all"]
        for r in got[1:]:
            for group in ("re_tables", "mf_rows", "mf_cols"):
                for k, v in got[0]["state"][group].items():
                    assert np.array_equal(r["state"][group][k], v), (world, group, k)
