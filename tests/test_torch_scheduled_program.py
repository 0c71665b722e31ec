"""The fused program's lane-scheduled sweep (``GameTrainProgram.step_scheduled``
through ``train_distributed``) against the JAX package's, on one device on
the CPU in float64: three sweeps with IDENTITY (and an MF coordinate),
RANDOM and INDEX_MAP random effects, freezing on and off; losses and states
within 1e-8 of the largest magnitude. A program without a scheduler is
bitwise the plain step, and a checkpointed partitioned run refuses freeze
tolerances with the JAX package's message."""

import dataclasses

import numpy as np
import pytest

from photon_ml_tpu.algorithm import mf_coordinate as jmfc
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.optim.optimizer import LaneSchedulerConfig as JSched
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.projector.projectors import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.algorithm import mf_coordinate as tmfc
from photon_ml_torch.algorithm.lane_scheduler import LaneScheduler
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig as TSched
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.projector.projectors import ProjectorType as TProj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_fused_parity import assert_states_close
from tests.torch_game_parity import game_arrays, optimizer_pair, projected_arrays

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

CASES = {
    "identity-mf": dict(projector="IDENTITY", mf=True),
    "identity-freeze": dict(projector="IDENTITY", freeze=(0.3, 0.3)),
    "random": dict(projector="RANDOM"),
    "index-map": dict(projector="INDEX_MAP"),
}


def _build(name, scheduled=True):
    c = CASES[name]
    proj = c["projector"]
    a = game_arrays(11, n=500, n_users=18, n_items=6) if proj == "IDENTITY" \
        else projected_arrays(4)
    common = dict(labels=a["labels"], feature_shards={"global": a["xg"], "per_entity": a["xr"]},
                  entity_keys={"user": a["users"], "item": a["items"]}, offsets=a["offsets"],
                  weights=a["weights"], unique_ids=a["unique_ids"], dtype=np.float64)
    jds = jgd.build_game_dataset(**common)
    tds = tgd.build_game_dataset(**common, device="cpu")
    types = ("user", "item") if proj == "IDENTITY" else ("user",)
    kw = dict(bucket_sizes=(8, 32, 128))
    if proj == "RANDOM":
        kw["projected_dim"] = 4
    jre = {t: jgd.build_random_effect_dataset(jds, t, "per_entity", projector_type=JProj[proj],
                                              **kw) for t in types}
    tre = {t: tgd.build_random_effect_dataset(tds, t, "per_entity", projector_type=TProj[proj],
                                              **kw) for t in types}
    jmf = tmf = None
    if c.get("mf"):
        jmf = {"mf": jmfc.build_mf_dataset(jds, "user", "item", bucket_sizes=(8, 32, 128))}
        tmf = {"mf": tmfc.build_mf_dataset(tds, "user", "item", bucket_sizes=(8, 32, 128))}
    freeze = c.get("freeze", (0.0, 0.0))
    sched = dict(probe_iterations=2, freeze_coefficient_tolerance=freeze[0],
                 freeze_gradient_tolerance=freeze[1])
    progs = []
    for side, (dist, task, pt, cls) in enumerate(((jdist, JTask, JProj, JSched),
                                                  (tdist, TTask, TProj, TSched))):
        fe_opt = optimizer_pair("LBFGS", 10)[side]
        re_opt = optimizer_pair("LBFGS", 12, rel_function_tolerance=1e-6)[side]
        if scheduled:
            re_opt = dataclasses.replace(re_opt, scheduler=cls(**sched))
        mfs = ()
        if c.get("mf"):
            mfs = (dist.MatrixFactorizationStepSpec("mf", "user", "item", num_latent_factors=2,
                                                    optimizer=optimizer_pair("LBFGS", 8)[side],
                                                    l2_weight=2.0),)
        progs.append(dist.GameTrainProgram(
            task.LOGISTIC_REGRESSION, dist.FixedEffectStepSpec("global", fe_opt, l2_weight=0.5),
            tuple(dist.RandomEffectStepSpec(t, "per_entity", re_opt, l2_weight=1.0,
                                            projector=pt[proj]) for t in types),
            mf_specs=mfs))
    return jds, tds, jre, tre, jmf, tmf, progs


@pytest.mark.parametrize("name", list(CASES))
def test_scheduled_program_matches(name):
    jds, tds, jre, tre, jmf, tmf, (jprog, tprog) = _build(name)
    jstate = jprog.init_state(jds, jre, jmf)
    tstate = convert.train_state_from_numpy(jstate, device="cpu")
    jres = jdist.train_distributed(jprog, jds, jre, mf_datasets=jmf, num_iterations=3,
                                   state=jstate)
    tres = tdist.train_distributed(tprog, tds, tre, mf_datasets=tmf, num_iterations=3,
                                   state=tstate)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-8)
    assert_states_close(jres.state, tres.state, 1e-8)
    assert tres.losses[-1] <= tres.losses[0]


def test_step_scheduled_without_schedulers_is_the_step():
    _, tds, _, tre, _, _, (_, tprog) = _build("identity-freeze", scheduled=False)
    data, buckets = tprog.prepare_inputs(tds, tre)
    state = tprog.init_state(tds, tre)
    a, la = tprog.step(data, buckets, state)
    b, lb = tprog.step_scheduled(data, buckets, state, schedulers={})
    assert float(la) == float(lb)
    for k in a.re_tables:
        assert np.array_equal(a.re_tables[k].numpy(), b.re_tables[k].numpy())
    sched = {"user": LaneScheduler(TSched(probe_iterations=2))}
    c, _ = tprog.step_scheduled(data, buckets, state, schedulers=sched)
    assert sched["user"].last_stats.lanes_probed > 0
    assert not np.array_equal(c.re_tables["user"].numpy(), a.re_tables["user"].numpy())


def test_partitioned_checkpoint_refuses_freezing(tmp_path):
    from photon_ml_tpu.io.checkpoint import TrainingCheckpointer as JCk
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer as TCk

    _, _, _, _, _, _, (jprog, tprog) = _build("identity-freeze")
    msgs = []
    for dist, prog, ck, cls in ((jdist, jprog, JCk, JSched), (tdist, tprog, TCk, TSched)):
        sched = {"user": (LaneScheduler if dist is tdist else _jax_scheduler())(
            cls(freeze_coefficient_tolerance=0.1, freeze_gradient_tolerance=0.1))}
        with pytest.raises(ValueError) as err:
            dist.train_partitioned(prog, {}, None, 1, schedulers=sched,
                                   checkpointer=ck(tmp_path / dist.__name__))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _jax_scheduler():
    from photon_ml_tpu.algorithm.lane_scheduler import LaneScheduler as J

    return J
