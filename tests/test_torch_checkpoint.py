"""Checkpoints (``photon_ml_torch/io/checkpoint.py``) and every resume of the
port: the step layout, pruning and fallback against the JAX package's
checkpointer; a coordinate-descent resume, a ``train_distributed`` resume
(with MF) and a ``train_partitioned`` resume (two gloo ranks) each bitwise
the uninterrupted port run; and checkpoints crossing packages: a JAX-written
coordinate-descent or solver checkpoint resumed by the port, and the
reverse, each within rel 1e-8 of the other package's uninterrupted run."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.io import checkpoint as jck
from photon_ml_tpu.io import stream_reader as jsr
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JCfg
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch import estimators as test_
from photon_ml_torch import resilience as tres
from photon_ml_torch.io import checkpoint as tck
from photon_ml_torch.io import stream_reader as tsr
from photon_ml_torch.optim.optimizer import OptimizerConfig as TCfg
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.parallel.multihost import InProcessExchange
from photon_ml_torch.resilience import recovery
from photon_ml_torch.types import TaskType as TTask
from tests import torch_fused_parity as FP
from tests import torch_mesh_worker as W
from tests import torch_partitioned_parity as PP
from tests.torch_game_parity import assert_models_close, datasets, estimator_pair, game_arrays

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a/x": rng.normal(size=(3, 4)), "b": np.arange(5, dtype=np.int32),
            "keys": np.array(["u1", "u22"])}


def test_layout_pruning_and_fallback_match_the_reference(tmp_path):
    outs = []
    for mod in (jck, tck):
        d = tmp_path / mod.__name__
        ck = mod.TrainingCheckpointer(d, max_to_keep=3)
        for step in range(1, 6):
            ck.save(step, _arrays(step), {"note": step})
        # damage the newest step's arrays: restore falls back one step
        with open(d / "step_00000005" / "arrays.npz", "wb") as f:
            f.write(b"not a zip")
        restored = ck.restore()
        outs.append((sorted(os.listdir(d)), ck.steps(), ck.latest_step(),
                     ck.newest_loadable_step(), restored.step, restored.meta))
        with pytest.raises(ValueError, match="not found"):
            ck.restore(step=1)
    assert outs[1] == outs[0]
    assert outs[1][0] == ["step_00000003", "step_00000004", "step_00000005"]


@pytest.mark.parametrize("writer,reader", [(jck, tck), (tck, jck)], ids=["jax-to-port",
                                                                         "port-to-jax"])
def test_step_directories_cross_packages(tmp_path, writer, reader):
    arrays = _arrays(3)
    writer.TrainingCheckpointer(tmp_path).save(7, arrays, {"losses": [1.5, 0.5]})
    got = reader.TrainingCheckpointer(tmp_path).restore()
    assert got.step == 7 and got.meta == {"step": 7, "losses": [1.5, 0.5]}
    assert sorted(got.arrays) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(got.arrays[k], arrays[k])


def test_save_records_bytes_and_seconds(tmp_path):
    ck = tck.TrainingCheckpointer(tmp_path)
    ck.save(1, {"w": torch.zeros(1000, dtype=torch.float64)}, {})
    assert ck.last_save["bytes"] >= 8000 and ck.last_save["seconds"] >= 0.0
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp.")]


def test_commit_writes_once_between_barriers(tmp_path):
    """Two virtual ranks commit one step: rank 0 writes, both return after
    the publish barrier."""
    ck = tck.TrainingCheckpointer(tmp_path)
    exchanges = InProcessExchange.create_group(2)
    paths = [None, None]

    def rank(r):
        paths[r] = tck.commit_checkpoint(ck, 3, {"w": np.ones(2)}, {}, exchange=exchanges[r])

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert paths[0].endswith("step_00000003") and paths[1] is None
    assert ck.steps() == [3]


def test_fingerprint_mismatch_text_matches_the_reference():
    saved = {"lambdas": [1.0], "dim": 4, "task": "X"}
    expected = {"lambdas": [2.0], "dim": 4, "num_ranks": 1, "task": "X"}
    assert tck.fingerprint_mismatch(saved, expected) == jck.fingerprint_mismatch(saved, expected)
    assert tck.fingerprint_mismatch(expected, expected) is None


# -- coordinate descent --------------------------------------------------------


def _cd_pair(**kw):
    return estimator_pair(lanes="LBFGS", down_sampling_rate=0.7, **kw)


def _models_equal(a, b):
    pa, pb = convert.game_model_to_numpy(a), convert.game_model_to_numpy(b)
    assert list(pa) == list(pb)
    for cid in pa:
        for key, v in pa[cid].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(pb[cid][key], v, err_msg=f"{cid}/{key}")


def test_cd_resume_is_bitwise(tmp_path):
    """A 3-sweep fit stopped by a transient error after its 5th update and
    resumed by ``run_with_recovery`` from the per-update checkpoints equals
    the uninterrupted fit bit for bit (down-sampling seeds included)."""
    _, td = datasets(game_arrays(3))
    _, te = _cd_pair()
    whole = te.fit(td)
    ck = tck.TrainingCheckpointer(tmp_path / "ck")
    calls = {"n": 0}

    def stop(iteration, cid, info):
        calls["n"] += 1
        if calls["n"] == 5:
            raise tres.TransientError("stopped after update 5")

    recovery.reset_counts()
    resumed = tres.run_with_recovery(
        lambda restart: dataclasses.replace(te, checkpointer=ck, on_update=stop).fit(td),
        max_restarts=1, checkpointer=ck)
    _models_equal(whole.model, resumed.model)
    assert recovery.counts["checkpoint_restores"] == 1 and ck.latest_step() == 9
    assert [h["iteration"] for h in resumed.metric_history] == \
        [h["iteration"] for h in whole.metric_history]


def test_cd_refuses_another_update_sequence(tmp_path):
    _, td = datasets(game_arrays(4, n=200))
    _, te = _cd_pair(num_iterations=1)
    ck = tck.TrainingCheckpointer(tmp_path)
    dataclasses.replace(te, checkpointer=ck).fit(td)
    other = dataclasses.replace(te, checkpointer=ck,
                                update_sequence=("per_user", "fixed", "per_item"))
    with pytest.raises(ValueError, match="incompatible"):
        other.fit(td)
    dataclasses.replace(other, resume=False).fit(td)  # resume=False ignores it


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cd_checkpoints_cross_packages(tmp_path, writer):
    """One sweep checkpointed by ``writer``, resumed to three by the other
    package, ends within rel 1e-8 of the writer's uninterrupted fit."""
    jd, td = datasets(game_arrays(5))
    # no down-sampling: the JAX package's resume restarts a down-sampled
    # fixed effect's seed rotation (ROADMAP.md queue C), the port's does not
    je, te = estimator_pair(lanes="LBFGS")
    ck_j, ck_t = jck.TrainingCheckpointer(tmp_path), tck.TrainingCheckpointer(tmp_path)
    if writer == "jax":
        whole = je.fit(jd)
        dataclasses.replace(je, checkpointer=ck_j, num_iterations=1).fit(jd)
        resumed = dataclasses.replace(te, checkpointer=ck_t).fit(td)
        assert_models_close(whole.model, resumed.model)
    else:
        whole = te.fit(td)
        dataclasses.replace(te, checkpointer=ck_t, num_iterations=1).fit(td)
        resumed = dataclasses.replace(je, checkpointer=ck_j).fit(jd)
        assert_models_close(resumed.model, whole.model)


def test_game_model_arrays_keep_the_reference_keys(tmp_path):
    jd, td = datasets(game_arrays(6, n=200))
    je, te = _cd_pair(num_iterations=1)
    jarrays, jmeta = jck.game_model_to_arrays(je.fit(jd).model)
    tmodel = te.fit(td).model
    tarrays, tmeta = tck.game_model_to_arrays(tmodel)
    assert sorted(tarrays) == sorted(jarrays) and tmeta == jmeta
    back = tck.game_model_from_arrays(tarrays, tmeta, device="cpu")
    _models_equal(tmodel, back)
    ck = tck.TrainingCheckpointer(tmp_path)
    ck.save(1, *tck.pack_cd_state(tmodel, None, float("nan"), []))
    model, step = tck.latest_trained_model(ck, device="cpu")
    assert step == 1
    _models_equal(tmodel, model)


# -- streamed solver checkpoints across packages ----------------------------------


def _stream(mod, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(200, 8))
    y = (rng.random(200) < 1.0 / (1.0 + np.exp(-x @ rng.normal(size=8)))).astype(float)
    return mod.ArrayChunkSource(x, y, chunk_rows=48)


def _stop_after(ck, n):
    real = ck.save_progress
    seen = {"n": 0}

    def save(**kw):
        path = real(**kw)
        if kw.get("solver_state") is not None:
            seen["n"] += 1
            if seen["n"] == n:
                raise RuntimeError("worker has been preempted")
        return path

    ck.save_progress = save


@pytest.mark.parametrize("opt", ["LBFGS", "TRON"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_solver_checkpoints_cross_packages(tmp_path, writer, opt):
    """A streamed λ path stopped mid-solve in its second λ by ``writer`` and
    resumed by the other package ends within rel 1e-8 of the writer's
    uninterrupted run."""
    from photon_ml_tpu.optim.optimizer import OptimizerType as JType
    from photon_ml_torch.optim.optimizer import OptimizerType as TType

    lams = (0.5, 4.0)
    jrun = lambda ck=None: jest.train_glm_streaming(  # noqa: E731
        _stream(jsr), JTask.LOGISTIC_REGRESSION, regularization_weights=lams, checkpointer=ck,
        optimizer=JCfg(optimizer_type=JType[opt], max_iterations=12))
    trun = lambda ck=None: test_.train_glm_streaming(  # noqa: E731
        _stream(tsr), TTask.LOGISTIC_REGRESSION, regularization_weights=lams, checkpointer=ck,
        optimizer=TCfg(optimizer_type=TType[opt], max_iterations=12), device="cpu")
    first, second = (jrun, trun) if writer == "jax" else (trun, jrun)
    ckw = (jck if writer == "jax" else tck).SolverCheckpointer(tmp_path, max_to_keep=100)
    whole = first()
    _stop_after(ckw, 6)  # three in the first λ's solve or more: the stop is mid-solve
    with pytest.raises(RuntimeError, match="preempted"):
        first(ckw)
    meta = json.loads(open(os.path.join(tmp_path, sorted(os.listdir(tmp_path))[-1],
                                        "meta.json")).read())
    assert meta["state_fields"]
    ckr = (tck if writer == "jax" else jck).SolverCheckpointer(tmp_path, max_to_keep=100)
    resumed = second(ckr)
    for lam in lams:
        ref = np.asarray(whole[lam].coefficients.means, dtype=np.float64)
        got = resumed[lam].coefficients.means
        got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())


# -- the fused program ------------------------------------------------------------


@pytest.mark.parametrize("name", ["validation", "down_sampling"])
def test_train_distributed_resume_is_bitwise(tmp_path, name):
    """One sweep checkpointed, then the three-sweep run resumed from it:
    losses, state, best state and metric history equal the uninterrupted
    run's (MF included)."""
    case = FP.build_case(name)
    kw = dict(mf_datasets=case.tmf or None, **case.train_kw, **FP._validation_kw(case, 1))
    jstate = case.jprog.init_state(case.jds, case.jre, case.jmf or None)
    init = lambda: convert.train_state_from_numpy(jstate, device="cpu")  # noqa: E731
    whole = tdist.train_distributed(case.tprog, case.tds, case.tre, num_iterations=3,
                                    state=init(), **kw)
    ck = tck.TrainingCheckpointer(tmp_path)
    tdist.train_distributed(case.tprog, case.tds, case.tre, num_iterations=1, state=init(),
                            checkpointer=ck, **kw)
    assert ck.steps() == [1]
    before = recovery.counts["checkpoint_restores"]
    resumed = tdist.train_distributed(case.tprog, case.tds, case.tre, num_iterations=3,
                                      checkpointer=ck, **kw)
    assert recovery.counts["checkpoint_restores"] == before + 1
    assert resumed.losses == whole.losses
    for a, b in ((whole.state, resumed.state),
                 (whole.best_state or whole.state, resumed.best_state or resumed.state)):
        assert torch.equal(a.fe_coefficients, b.fe_coefficients)
        for group in ("re_tables", "mf_rows", "mf_cols", "extra_fe"):
            ga, gb = getattr(a, group), getattr(b, group)
            assert sorted(ga) == sorted(gb)
            for k in ga:
                assert torch.equal(ga[k], gb[k]), (group, k)
    assert resumed.metric_history == whole.metric_history
    assert ck.steps() == [1, 2, 3]


def test_train_distributed_refuses_a_foreign_checkpoint(tmp_path):
    case = FP.build_case("dryrun")
    ck = tck.TrainingCheckpointer(tmp_path)
    ck.save(1, {"model/fixed/means": np.zeros(3)}, {})
    with pytest.raises(ValueError, match="not a distributed-training checkpoint"):
        tdist.train_distributed(case.tprog, case.tds, case.tre, checkpointer=ck)


def test_train_partitioned_resume_on_two_ranks(tmp_path):
    """Two gloo ranks: a one-sweep checkpoint (rank 0 writes between
    barriers), then the two-sweep run resumed from it, bitwise the
    uninterrupted partitioned run on both ranks."""
    path = PP.write_input(tmp_path / "in", num_files=4)
    task = dict(kind="partitioned_train", path=path, configs=PP.CONFIGS["dense"],
                re_columns=["userId"], program=PP.program(), sweeps=2, checkpoint=True)
    (tmp_path / "ranks").mkdir()
    (ranks,) = W.spawn_ranks(2, [task], tmp_path / "ranks")
    for out in ranks:
        assert out["resumed"]["losses"] == out["losses"]
        assert out["resumed"]["steps"] == [1, 2]
        for k, v in out["state"].items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    np.testing.assert_array_equal(out["resumed"]["state"][k][kk], vv)
            else:
                np.testing.assert_array_equal(out["resumed"]["state"][k], v)


def test_train_partitioned_fingerprint_fails_fast(tmp_path):
    from photon_ml_torch.parallel import mesh as M
    from photon_ml_torch.parallel import multihost

    path = PP.write_input(tmp_path / "in", num_files=2)
    parts, ex = PP.tread_ranks(path, PP.CONFIGS["dense"], 1)
    ds = parts[0].result.dataset
    multihost.initialize(device="cpu")
    try:
        mesh = M.make_mesh()
        ck = tck.TrainingCheckpointer(tmp_path / "ck")
        prog = W.build_program(PP.program(res=False), mesh)
        tdist.train_partitioned(prog, {0: (ds, {})}, mesh, 1, num_iterations=1, exchange=ex[0],
                                checkpointer=ck)
        with pytest.raises(ValueError, match="beyond this run's num_iterations"):
            tdist.train_partitioned(prog, {0: (ds, {})}, mesh, 1, num_iterations=0,
                                    exchange=ex[0], checkpointer=ck)
        meta_path = tmp_path / "ck" / "step_00000001" / "meta.json"
        meta = json.loads(meta_path.read_text())
        meta["partition_fingerprint"]["block_rows"] += 1
        meta_path.write_text(json.dumps(meta))
        with pytest.raises(ValueError, match=r"partition fingerprint \(differs on \['block_rows'\]"):
            tdist.train_partitioned(prog, {0: (ds, {})}, mesh, 1, num_iterations=2,
                                    exchange=ex[0], checkpointer=ck)
    finally:
        multihost.shutdown()


def test_mf_and_compact_models_round_trip_across_packages():
    """tests/test_mf.py's checkpoint round trip, through both packages; a
    compact random effect keeps its active columns (the port's extra keys,
    which the JAX package ignores)."""
    from photon_ml_tpu.models.game import GameModel as JGame
    from photon_ml_tpu.models.matrix_factorization import MatrixFactorizationModel as JMF
    from photon_ml_tpu.types import TaskType as JT
    from photon_ml_torch.models.game import GameModel, RandomEffectModel
    from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel

    rng = np.random.default_rng(0)
    rows, cols = rng.normal(size=(3, 2)), rng.normal(size=(4, 2))
    rk, ck = np.array(["u0", "u1", "u2"]), np.array(["i0", "i1", "i2", "i3"])
    jmodel = JGame(models={"mf": JMF(row_factors=rows, col_factors=cols, row_effect_type="user",
                                     col_effect_type="item", row_keys=rk, col_keys=ck,
                                     task=JT.LINEAR_REGRESSION)})
    arrays, meta = jck.game_model_to_arrays(jmodel)
    restored = tck.game_model_from_arrays(arrays, meta, device="cpu").models["mf"]
    assert isinstance(restored, MatrixFactorizationModel)
    np.testing.assert_array_equal(restored.row_factors.numpy(), rows)
    np.testing.assert_array_equal(restored.col_keys, ck)
    compact = RandomEffectModel(coefficients=torch.as_tensor(rng.normal(size=(3, 2))),
                                entity_keys=rk, random_effect_type="user",
                                feature_shard_id="wide", task=TTask.LINEAR_REGRESSION,
                                active_cols=np.array([[0, 5], [2, 9], [1, 9]], np.int32),
                                feature_dim=9)
    tmodel = GameModel(models={"mf": restored, "user": compact})
    arrays, meta = tck.game_model_to_arrays(tmodel)
    back = jck.game_model_from_arrays(arrays, meta).models
    np.testing.assert_array_equal(np.asarray(back["mf"].col_factors), cols)
    np.testing.assert_array_equal(np.asarray(back["user"].coefficients),
                                  compact.coefficients.numpy())
    again = tck.game_model_from_arrays(arrays, meta, device="cpu").models["user"]
    np.testing.assert_array_equal(again.active_cols, compact.active_cols)
    assert again.feature_dim == 9
