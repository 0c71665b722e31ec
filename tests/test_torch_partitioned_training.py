"""The port's partitioned training against the JAX package's, in float64 on
the CPU: read_partitioned -> build_random_effect_dataset_partitioned ->
train_partitioned on two spawned gloo ranks (``tests/torch_mesh_worker.py``)
against the JAX package's on two virtual ranks over a data=2 virtual CPU
mesh, rel 1e-8; against the port's own full read through
train_distributed(mesh=) on entity-clustered input, rel 1e-10; on inputs
whose users span the ranks (the rank-local semantics: the last lane in
bucket order, then rank order, wins the table row), rel 1e-8 against the JAX
package. GameEstimator(partition=) and the guards raise the JAX package's
messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCoordOpt
from photon_ml_tpu.ops.normalization import NormalizationType as JNorm
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.projector.projectors import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig as TCoordOpt
from photon_ml_torch.ops.normalization import NormalizationType as TNorm
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOpt
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.parallel import mesh as M
from photon_ml_torch.parallel import multihost
from photon_ml_torch.projector.projectors import ProjectorType as TProj
from photon_ml_torch.types import TaskType as TTask
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W
from tests import torch_partitioned_parity as PP

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

#: name -> (shard layout, input kwargs, program kwargs, worker extras)
CASES = {
    "dense": ("dense", dict(num_files=4), dict(),
              dict(full=True, estimator=True)),
    "logistic_sparse": ("sparse", dict(num_files=4, task="LOGISTIC_REGRESSION", seed=2),
                        dict(task="LOGISTIC_REGRESSION"), dict(full=True)),
    "hybrid": ("hybrid", dict(num_files=3, seed=3), dict(), dict(full=True)),
    # users on both ranks, one bucket: the later rank's lane wins the row
    "spanning": ("dense", dict(num_files=4, clustered=False, seed=5),
                 dict(bucket_sizes=(64,)), dict()),
    # users on both ranks in buckets of different capacities: the table is
    # shared after every bucket
    "spanning_buckets": ("dense", dict(num_files=4, clustered=False, uneven=True,
                                       users_per_file=6), dict(), dict()),
    # lane-scheduled per-user solves: each rank compacts its own stragglers
    "scheduled": ("dense", dict(num_files=4, seed=7), dict(scheduler={"probe_iterations": 2}),
                  dict()),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("partitioned-training")
    tasks, inputs = [], {}
    for name, (kind, data_kw, prog_kw, extra) in CASES.items():
        path = PP.write_input(base / name, **data_kw)
        inputs[name] = path
        tasks.append(dict(kind="partitioned_train", path=path, configs=PP.CONFIGS[kind],
                          re_columns=["userId"], program=PP.program(**prog_kw), sweeps=2,
                          **extra))
    ranks = base / "ranks"
    ranks.mkdir()
    results = W.spawn_ranks(2, tasks, ranks)
    jax = {name: PP.jtrain_partitioned(inputs[name], PP.CONFIGS[CASES[name][0]], t["program"])
           for name, t in zip(CASES, tasks)}
    return {"port": dict(zip(CASES, results)), "jax": jax}


@pytest.mark.parametrize("case", list(CASES))
def test_train_partitioned_matches_the_jax_package(runs, case):
    """Losses and every state tensor at rel 1e-8 of the JAX package's
    train_partitioned, on both ranks, which hold one state bitwise."""
    jres = runs["jax"][case][0]
    ref = MP.state_numpy(jres.state)
    got = runs["port"][case]
    for r in got:
        np.testing.assert_allclose(r["losses"], jres.losses, rtol=1e-8)
        MP.assert_states_close(r["state"], ref, 1e-8)
    for k, v in got[0]["state"]["re_tables"].items():
        assert np.array_equal(got[1]["state"]["re_tables"][k], v)
    assert np.array_equal(got[1]["state"]["fe_coefficients"], got[0]["state"]["fe_coefficients"])


@pytest.mark.parametrize("case", ["dense", "logistic_sparse", "hybrid"])
def test_partitioned_matches_the_full_read(runs, case):
    """On entity-clustered input the partitioned run lands on the full
    read's train_distributed(mesh=) state, rel 1e-10."""
    for r in runs["port"][case]:
        assert r["read"]["presence"]["userId"].max() == 1
        np.testing.assert_allclose(r["losses"], r["full"]["losses"], rtol=1e-10)
        MP.assert_states_close(r["state"], r["full"]["state"], 1e-10)


def test_scheduled_ranks_probe_and_rescue_their_own_lanes(runs):
    """Two ranks of the lane-scheduled program (the JAX package's state, in
    the test above): every rank probed its own lanes and rescued some, with
    no all-gather more than the unscheduled program makes (the all-reduces
    are the fixed effect's evaluations, which the data decides)."""
    for r, plain in zip(runs["port"]["scheduled"], runs["port"]["dense"]):
        stats = r["scheduler_stats"]["userId"]
        assert stats["lanes_probed"] == stats["lanes_total"] > 0
        assert stats["lanes_rescued"] > 0 and stats["rescue_blocks"] > 0
        assert r["collectives"]["all_gather"]["calls"] \
            == plain["collectives"]["all_gather"]["calls"]


def test_spanning_entities_take_the_last_lane(runs):
    """Users with rows on both ranks: every user is on two ranks; in
    ``spanning_buckets`` some user sits in a different bucket on each rank
    (so the table is shared after every bucket, one all-gather more a
    bucket), and the state matches the JAX package's (the test above)."""
    for case in ("spanning", "spanning_buckets"):
        r0, r1 = runs["port"][case]
        assert r0["read"]["presence"]["userId"].min() == 2
    caps = [{int(e): i for i, b in enumerate(r["buckets"]["userId"])
             for e in b["entity_rows"] if e < 2**31 - 1}
            for r in runs["port"]["spanning_buckets"]]
    assert any(caps[0][e] != caps[1][e] for e in caps[0] if e in caps[1])
    gathers = {c: runs["port"][c][0]["collectives"]["all_gather"]["calls"]
               for c in ("spanning", "spanning_buckets")}
    buckets = len(runs["port"]["spanning_buckets"][0]["buckets"]["userId"])
    # one all-gather of the lanes' rows, then per sweep the offsets and the
    # table once (or once a bucket)
    assert gathers == {"spanning": 1 + 2 * 2, "spanning_buckets": 1 + 2 * (1 + buckets)}


def test_estimator_partition_matches_train_partitioned(runs):
    """GameEstimator(partition=TrainPartition(...)).fit on each rank's block
    gives train_partitioned's model, rel 1e-10."""
    for r in runs["port"]["dense"]:
        est, prog = r["estimator"], r["program_model"]
        np.testing.assert_allclose(est["fixed"]["means"], prog["global"]["means"], rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(est["userId"]["table"], prog["userId"]["table"], rtol=1e-10,
                                   atol=1e-12)


def test_partition_fingerprint_matches(runs):
    for case in ("dense", "hybrid"):
        jres, jprog, jparts, jre = runs["jax"][case]
        for r, got in enumerate(runs["port"][case]):
            ref = jdist._partition_fingerprint(jprog, {r: (jparts[r].result.dataset, jre[r])}, 2)
            assert got["fingerprint"] == ref


@pytest.fixture
def group_of_one():
    multihost.initialize(device="cpu")
    try:
        yield M.make_mesh()
    finally:
        multihost.shutdown()


def _guard_configs(module, coord_opt, opt, proj, kind: str) -> dict:
    o = dict(optimizer=opt(max_iterations=2), l2_weight=1.0)
    fe = module.FixedEffectCoordinateConfig("global", coord_opt(**o))
    re = dict(random_effect_type="userId", feature_shard_id="perUser")
    if kind == "projected":
        return {"fe": fe, "re": module.RandomEffectCoordinateConfig(
            **re, optimization=coord_opt(**o), projector_type=proj.RANDOM, projected_dim=2)}
    if kind == "mf":
        return {"fe": fe, "mf": module.MatrixFactorizationCoordinateConfig(
            "userId", "queryId", 2, coord_opt(**o))}
    if kind == "riders":
        return {"fe": module.FixedEffectCoordinateConfig("global", coord_opt(
            **o, down_sampling_rate=0.5, compute_variance=True)),
            "re": module.RandomEffectCoordinateConfig(**re, optimization=coord_opt(**o),
                                                      features_to_samples_ratio=0.5)}
    if kind == "sparse_re":
        return {"fe": fe, "re": module.RandomEffectCoordinateConfig(
            "userId", "global", coord_opt(**o))}
    return {"fe": fe, "re": module.RandomEffectCoordinateConfig(**re,
                                                                optimization=coord_opt(**o))}


GUARDS = [("projected", {}), ("mf", {}), ("riders", {}), ("sparse_re", {}),
          ("plain", {"normalization": "STANDARDIZATION"}), ("plain", {"validation": True}),
          ("plain", {"locked": True})]


@pytest.mark.parametrize("kind,kw", GUARDS, ids=[f"{k}-{'-'.join(kw)}" for k, kw in GUARDS])
def test_estimator_guard_matches_the_jax_package(tmp_path, group_of_one, kind, kw):
    """Configurations outside the partitioned surface raise the JAX
    package's ValueError, word for word, before any rank-local work."""
    spec = PP.CONFIGS["sparse" if kind == "sparse_re" else "dense"]
    path = PP.write_input(tmp_path / "in", num_files=2)
    jparts, jex = PP.jread_ranks(path, spec, 2, evaluation_id_columns=("queryId",))
    tparts, tex = PP.tread_ranks(path, spec, 2, evaluation_id_columns=("queryId",))
    messages = []
    for module, parts, ex, coord_opt, opt, proj, task, norm, mesh in (
            (jest, jparts, jex, JCoordOpt, JOpt, JProj, JTask, JNorm, MP.jmesh(2)),
            (test_, tparts, tex, TCoordOpt, TOpt, TProj, TTask, TNorm, group_of_one)):
        configs = _guard_configs(module, coord_opt, opt, proj, kind)
        extra = {}
        if "normalization" in kw:
            extra["normalization"] = norm[kw["normalization"]]
        if "locked" in kw:
            extra["locked_coordinates"] = frozenset({"re"})
        est = module.GameEstimator(task.LINEAR_REGRESSION, configs, mesh=mesh,
                                   partition=module.TrainPartition(info=parts[0].partition,
                                                                   exchange=ex[0]), **extra)
        ds = parts[0].result.dataset
        with pytest.raises(ValueError) as e:
            est.fit(ds, validation_dataset=ds if "validation" in kw else None,
                    initial_model="model" if "locked" in kw else None)
        messages.append(str(e.value).splitlines()[0])
    assert messages[1] == messages[0]
    assert messages[0].startswith("partitioned training does not support")


def test_partition_without_a_mesh_refuses_as_the_jax_package(tmp_path):
    path = PP.write_input(tmp_path / "in", num_files=2)
    tparts, tex = PP.tread_ranks(path, PP.CONFIGS["dense"], 2)
    jparts, jex = PP.jread_ranks(path, PP.CONFIGS["dense"], 2)
    messages = []
    for module, parts, ex, coord_opt, opt, task in ((jest, jparts, jex, JCoordOpt, JOpt, JTask),
                                                    (test_, tparts, tex, TCoordOpt, TOpt,
                                                     TTask)):
        est = module.GameEstimator(task.LINEAR_REGRESSION, {"fe": module.FixedEffectCoordinateConfig(
            "global", coord_opt(optimizer=opt(max_iterations=2)))},
            partition=module.TrainPartition(info=parts[0].partition, exchange=ex[0]))
        with pytest.raises(ValueError) as e:
            est.fit(parts[0].result.dataset)
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "requires a mesh" in messages[0]


def test_partitioned_guards_match_the_jax_package():
    """_partitioned_guards: MF coordinates, sparse RE shards and projected
    REs raise the JAX package's messages."""
    lbfgs = ("LBFGS", 2, {})
    mf = dict(name="mf", row="user", col="item", k=2, opt=lbfgs, l2=1.0)
    cases = [(dict(mfs=[mf]), {}), ({}, {0: ({"re_sparse": {}}, {})}),
             ({}, {0: ({}, {"__projections__": {}})})]
    for extra, prepared in cases:
        p = dict(PP.program(res=False), **extra)
        messages = []
        for guards, prog in ((jdist._partitioned_guards, MP.jprogram(p, None)),
                             (tdist._partitioned_guards, W.build_program(p, None))):
            with pytest.raises(ValueError) as e:
                guards(prog, prepared)
            messages.append(str(e.value))
        assert messages[0] == messages[1]


#: checkpoints and resume (item 16) and schedulers (item 18) are ported: each option now trains
REFUSALS = [("checkpointer", "a checkpointer", None),
            ("resume", False, None), ("resume_step", 3, None),
            ("checkpoint_every", 2, None), ("schedulers", "a scheduler", None)]


@pytest.mark.parametrize("option,value,item", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_train_partitioned_refuses_before_any_data(group_of_one, option, value, item,
                                                   tmp_path):
    """What is not ported raises NotImplementedError naming its ROADMAP item
    before any data is touched (the parts are None); the checkpoint options
    (item None) train a sweep (tests/test_torch_checkpoint.py resumes)."""
    prog = W.build_program(PP.program(), group_of_one)
    if item is None:
        from photon_ml_torch.io.checkpoint import TrainingCheckpointer

        if option == "checkpointer":
            value = TrainingCheckpointer(tmp_path / "ck")
        if option == "schedulers":  # the lane scheduler is ported (item 18)
            from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler
            from photon_ml_torch.optim.optimizer import LaneSchedulerConfig

            value = {"userId": LaneScheduler(LaneSchedulerConfig())}
        path = PP.write_input(tmp_path / "in", num_files=2)
        parts, ex = PP.tread_ranks(path, PP.CONFIGS["dense"], 1)
        prog = W.build_program(PP.program(res=False), group_of_one)
        result = tdist.train_partitioned(prog, {0: (parts[0].result.dataset, {})}, group_of_one,
                                         1, num_iterations=1, exchange=ex[0], **{option: value})
        assert len(result.losses) == 1 and np.isfinite(result.losses[0])
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        tdist.train_partitioned(prog, None, group_of_one, 1, **{option: value})


def test_train_partitioned_with_one_column_block(tmp_path, group_of_one):
    """fe_feature_sharded over a model axis of 1 is one column block: the
    partitioned program trains as without it (tests/test_torch_model_axis_io.py
    runs a model axis of 2); a program built without the flag refuses inputs
    laid out with it over a model axis only."""
    path = PP.write_input(tmp_path / "in", num_files=2)
    parts, ex = PP.tread_ranks(path, PP.CONFIGS["dense"], 1)
    ds = parts[0].result.dataset
    runs = []
    for flag in (False, True):
        prog = W.build_program(PP.program(res=False), group_of_one, flag)
        runs.append(tdist.train_partitioned(prog, {0: (ds, {})}, group_of_one, 1,
                                            num_iterations=1, exchange=ex[0],
                                            fe_feature_sharded=flag))
    assert runs[0].losses == runs[1].losses and runs[1].state.fe_columns is None
    assert torch.equal(runs[0].state.fe_coefficients, runs[1].state.fe_coefficients)


def test_prepare_partitioned_inputs_takes_this_ranks_block_only(tmp_path, group_of_one):
    path = PP.write_input(tmp_path / "in", num_files=2)
    parts, ex = PP.tread_ranks(path, PP.CONFIGS["dense"], 1)
    prog = W.build_program(PP.program(), group_of_one)
    ds = parts[0].result.dataset
    with pytest.raises(ValueError, match="this rank's block only"):
        tdist.prepare_partitioned_inputs(prog, {1: (ds, {})}, group_of_one, 1)
    with pytest.raises(ValueError, match="one rank a partition"):
        tdist.prepare_partitioned_inputs(prog, {0: (ds, {})}, group_of_one, 2)
    data, _, state = tdist.prepare_partitioned_inputs(
        W.build_program(PP.program(res=False), group_of_one), {0: (ds, {})}, group_of_one, 1,
        exchange=ex[0])
    assert data["mesh"].rows == slice(0, ds.num_samples) and state.re_tables == {}
    assert dataclasses.is_dataclass(data["mesh"])
