"""The port's fused program, scorer and estimator with the fixed effect
feature-sharded over the mesh's model axis, against the JAX package's and
against the port's own one-device program, in float64 on the CPU.

The port runs in spawned gloo ranks (``tests/torch_mesh_worker.py``): one
group of 2 ranks as a 1x2 mesh and one of 4 as a 2x2 mesh for the whole
file. The JAX package runs in this process on its 8-device virtual CPU mesh
(``make_mesh(data, model)``). Each rank holds its ``d/2`` FE columns and
FE block. The fixtures' FE widths (6 dense, 14 sparse) divide the model
axis, as the JAX package's placement needs; the estimator's width of 5 pads
to 6 (``fe_pad``), and tests/test_torch_column_sharded.py holds padding
lanes of column blocks.
"""

import functools

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCoordOpt
from photon_ml_tpu.ops.normalization import NormalizationType as JNormType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.parallel.column_sharded import split_fe
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W
from tests import torch_model_axis_parity as MA

LBFGS = ("LBFGS", 10, {})
SHAPES = {2: (1, 2), 4: (2, 2)}


def _program(res=(), mfs=(), **kw):
    return dict(task=kw.pop("task", "LOGISTIC_REGRESSION"), fe_shard="global", fe_opt=LBFGS,
                fe_l2=0.5, res=list(res), mfs=list(mfs), **kw)


def _re(t, shard="per_entity"):
    return dict(type=t, shard=shard, opt=LBFGS, l2=1.0)


MF = dict(name="mf", row="user", col="item", k=2, opt=LBFGS, l2=2.0, alternations=2)


def _tasks() -> dict:
    dense, val = MP.split(MP.arrays(0, n=263, d_fe=6), 60)
    hybrid = MP.arrays(3, sparse="fe")
    hybrid["shards"]["global"] = dict(hybrid["shards"]["global"],
                                      hybrid=dict(coverage=0.5, pad_multiple=2))
    tasks = {
        "dense_all": dict(data=dense, program=_program((_re("user"), _re("item"))),
                          score=dict(data=val, evaluators=["AUC", "RMSE"])),
        "standardized": dict(data=dense, program=_program(
            (_re("user"),), normalization=MA.standardization(dense))),
        "mf": dict(data=dense, program=_program((_re("user"), _re("item")), (MF,))),
        "sparse_ell": dict(data=MP.arrays(1, sparse="fe"), program=_program((_re("user"),))),
        "sparse_hybrid": dict(data=hybrid, program=_program((_re("user"),))),
    }
    for t in tasks.values():
        t.update(kind="train", sweeps=2, fe_feature_sharded=True)
        t["state"] = MA.jinit_state(t)
    return tasks


def _estimator_task() -> dict:
    dense, val = MP.split(MP.arrays(4, n=211), 50)
    opt = dict(opt=LBFGS, l2=0.5)
    return dict(kind="estimator", data=dense, validation=val, sweeps=2,
                fe_feature_sharded=True, evaluators=["AUC"], task="LOGISTIC_REGRESSION",
                coordinates={"fixed": dict(kind="fe", shard="global", **opt),
                             "per_user": dict(kind="re", type="user", shard="per_entity",
                                              **opt)})


def _build_runs(base) -> dict:
    tasks = dict(_TASKS(), estimator=_estimator_task())
    out = {}
    for world, shape in SHAPES.items():
        names = list(tasks)
        spawn_dir = base / f"model_axis{world}"
        spawn_dir.mkdir(parents=True)
        results = W.spawn_ranks(world, [dict(tasks[k], mesh=shape) for k in names], spawn_dir)
        out[world] = dict(zip(names, results))
    return {"results": out, "tasks": tasks}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank groups run once a test run (the xdist workers share one
    build, ``torch_mesh_worker.run_once``): world -> name -> per-rank
    results."""
    return W.run_once("model_axis", _build_runs, tmp_path_factory.mktemp("model-axis"))


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, world: int | None):
    task = _TASKS()[name]
    res, prog, ds, re_ds = MA.jtrain(task, None if world is None else SHAPES[world])
    return {"losses": np.asarray(res.losses, dtype=np.float64),
            "state": MP.state_numpy(res.state)}


@functools.lru_cache(maxsize=None)
def _TASKS():
    return _tasks()


@functools.lru_cache(maxsize=None)
def _port_one_device(name: str) -> dict:
    """The port's mesh=None program on the task, in this process."""
    task = _TASKS()[name]
    ds = W.build_dataset(task["data"])
    prog = W.build_program(task["program"], None)
    re_ds, mf_ds = W.build_inputs(task["program"], ds)
    res = tdist.train_distributed(prog, ds, re_ds, mf_datasets=mf_ds or None,
                                  num_iterations=task["sweeps"],
                                  state=convert.train_state_from_numpy(task["state"],
                                                                       device="cpu"))
    return {"losses": np.asarray(res.losses), "state": W.state_numpy(res.state)}


TRAINS = ["dense_all", "standardized", "mf", "sparse_ell", "sparse_hybrid"]
#: (losses, state) tolerances against the JAX package: MF at the JAX
#: package's own sharded-against-one-device 1e-5; sparse at its 1e-8/1e-7
TOL = {"mf": (1e-5, 1e-5), "sparse_ell": (1e-8, 1e-7), "sparse_hybrid": (1e-8, 1e-7)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", TRAINS)
def test_feature_sharded_program_matches_the_jax_package(runs, name, world):
    """train_distributed(fe_feature_sharded=True) at 1x2 and 2x2: losses at
    rel 1e-9 and the gathered state at 1e-8 of the JAX package's
    feature-sharded program (MF 1e-5, sparse 1e-8/1e-7, the JAX package's
    own bounds), and at the same bounds of the port's mesh=None program."""
    got = runs["results"][world][name][0]
    loss_tol, state_tol = TOL.get(name, (1e-9, 1e-8))
    for ref in (_jax_run(name, world), _port_one_device(name)):
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=loss_tol)
        MP.assert_states_close(got["state"], ref["state"], state_tol)


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_fe_block_only(runs, world):
    """The FE coefficients and every FE solve's start and solution are
    d/2 long on each rank (the solvers' history is held at that length in
    tests/test_torch_column_sharded.py); the blocks are the whole vector's
    halves."""
    for name in TRAINS:
        got = runs["results"][world][name]
        d = len(got[0]["state"]["fe_coefficients"])
        block = -(-d // 2)
        halves = {}
        for r in got:
            b = r["block"]
            assert b["fe_coefficients"].shape == (block,), name
            start, width, dim = b["fe_columns"]
            assert (width, dim) == (block, d) and start in (0, block), name
            assert all(v["length"] == v["solution"] == block for v in r["fe_values"]), name
            halves[start] = b["fe_coefficients"]
        whole = np.concatenate([halves[0], halves[block]])
        np.testing.assert_array_equal(whole, got[0]["state"]["fe_coefficients"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_takes_the_same_steps(runs, world):
    """Every rank's losses, per-iteration FE solve values, iterations and
    stop reasons, and gathered state are bitwise equal: the model-axis
    all-reduces hand every rank the same scalars."""
    for name in TRAINS + ["estimator"]:
        got = runs["results"][world][name]
        for r in got[1:]:
            for key in ("losses", "best_metric"):
                if key in got[0]:
                    assert repr(r[key]) == repr(got[0][key]), (name, key)
            for a, b in zip(r.get("fe_values", ()), got[0].get("fe_values", ())):
                assert (a["iterations"], a["reason"]) == (b["iterations"], b["reason"])
                np.testing.assert_array_equal(a["values"], b["values"])
            state = r.get("state") or r.get("model")
            ref = got[0].get("state") or got[0].get("model")
            for k, v in _flat(ref).items():
                np.testing.assert_array_equal(_flat(state)[k], v, err_msg=f"{name}/{k}")


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, np.ndarray) and tree.dtype != object:
        out[prefix] = tree
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_run_on_both_axes(runs, world):
    """A feature-sharded sweep all-reduces partial margins and the solver's
    inner products over "model" and gathers the FE block once (the model on
    output); the gradient block's sum over "data" appears only with a data
    axis of 2."""
    by_axis = runs["results"][world]["dense_all"][0]["by_axis"]
    assert by_axis["model"]["all_reduce"]["calls"] > 0
    assert by_axis["model"]["all_gather"]["calls"] == 1
    data_reduces = by_axis["data"].get("all_reduce", {}).get("calls", 0)
    # the training loss of each sweep, plus the FE evaluations' gradient sums
    assert data_reduces == 2 if world == 2 else data_reduces > 2


@pytest.mark.parametrize("world", [2, 4])
def test_feature_sharded_scoring_matches_the_jax_scorer(runs, world):
    """DistributedScorer and GameTransformer with fe_feature_sharded: scores
    at rel 1e-9 of the JAX scorer on its own model (the states agree at
    1e-8) and at 1e-12 of the port's one-device transform; the mesh metrics
    equal the transform's."""
    task = runs["tasks"]["dense_all"]
    got = runs["results"][world]["dense_all"][0]["scores"]
    scale = np.abs(got["one_device"]).max()
    np.testing.assert_allclose(got["mesh"], got["one_device"], rtol=1e-12, atol=1e-12 * scale)
    jscores = MA.jscores(task, SHAPES[world])
    np.testing.assert_allclose(got["mesh"], jscores, rtol=1e-8, atol=1e-9 * scale)
    for spec in task["score"]["evaluators"]:
        assert got["evaluate"][spec] == pytest.approx(got["transform"][spec], rel=1e-10)


@pytest.mark.parametrize("world", [2, 4])
def test_feature_sharded_estimator_matches_the_jax_estimator(runs, world):
    """GameEstimator(mesh=, fe_feature_sharded=True): d=5 pads to 6 on the
    model axis of 2 and the model leaves with 5 coefficients; the fitted
    models at rel 1e-8 of the JAX estimator's over the same mesh shape, the
    validation metric too."""
    t = runs["tasks"]["estimator"]
    got = runs["results"][world]["estimator"][0]
    ds = MP.jdataset(t["data"])
    val = MP.jdataset(t["validation"], vocabs=ds.entity_vocabs)
    opt = JCoordOpt(optimizer=MP._opt(LBFGS), l2_weight=0.5)
    est = jest.GameEstimator(
        JTask[t["task"]], {"fixed": jest.FixedEffectCoordinateConfig("global", opt),
                           "per_user": jest.RandomEffectCoordinateConfig("user", "per_entity",
                                                                         opt)},
        num_iterations=t["sweeps"], validation_evaluators=("AUC",), normalization=JNormType.NONE,
        mesh=MA.jmesh(*SHAPES[world]), fe_feature_sharded=True)
    res = est.fit(ds, validation_dataset=val)
    jfe = np.asarray(res.model.get("fixed").glm.coefficients.means)
    assert got["model"]["fixed"]["means"].shape == jfe.shape == (5,)
    np.testing.assert_allclose(got["model"]["fixed"]["means"], jfe, rtol=1e-8,
                               atol=1e-8 * np.abs(jfe).max())
    jtab = np.asarray(res.model.get("per_user").coefficients)
    np.testing.assert_allclose(got["model"]["per_user"]["table"], jtab, rtol=1e-8,
                               atol=1e-8 * np.abs(jtab).max())
    assert got["best_metric"] == pytest.approx(float(res.best_metric), rel=1e-8)


@pytest.mark.parametrize("world", [2, 4])
def test_model_axis_state_conversion_both_ways(runs, world):
    """A JAX state carried across (convert.train_state_from_numpy with a
    rank's fe_columns) is exactly that rank's block of the JAX vector, and
    the rank's block carried back (train_state_to_numpy) round-trips; the
    gathered FE vector is the blocks in model-rank order."""
    jstate = _jax_run("dense_all", world)["state"]
    d = len(jstate["fe_coefficients"])
    block = -(-d // 2)
    for rank, r in enumerate(runs["results"][world]["dense_all"]):
        columns = tuple(r["block"]["fe_columns"])
        carried = convert.train_state_from_numpy(jstate, device="cpu", fe_columns=columns)
        want = split_fe(torch.tensor(jstate["fe_coefficients"]), columns)
        assert torch.equal(carried.fe_coefficients, want) and carried.fe_columns == columns
        assert carried.fe_coefficients.shape == (block,)
        back = convert.train_state_to_numpy(carried)
        again = convert.train_state_from_numpy(back, device="cpu")
        assert torch.equal(again.fe_coefficients, carried.fe_coefficients)
        assert again.fe_columns == columns
        for k, v in jstate["re_tables"].items():
            np.testing.assert_array_equal(back["re_tables"][k], v)
    # game_model_to_state of the gathered model splits it into the same block
    for r in runs["results"][world]["dense_all"]:
        np.testing.assert_array_equal(r["warm_block"]["fe_coefficients"],
                                      r["block"]["fe_coefficients"])
        assert tuple(r["warm_block"]["fe_columns"]) == tuple(r["block"]["fe_columns"])
