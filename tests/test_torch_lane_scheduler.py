"""The port's lane scheduler (``algorithm/lane_scheduler.py``) against the
JAX package's, on the CPU in float64: the lane compaction's arrays equal,
scheduled random-effect updates over three sweeps (IDENTITY, INDEX_MAP,
RANDOM; freezing on and off) with tables within 1e-8·max|w|, per-lane
iterations and reasons and the sweep's SchedulerStats equal, the active set
reset after the final sweep, and the per-coordinate errors with the JAX
package's messages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.algorithm import lane_scheduler as jls
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.optim.optimizer import LaneSchedulerConfig as JSched
from photon_ml_tpu.projector import projectors as jproj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.algorithm import lane_scheduler as tls
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig as TSched
from photon_ml_torch.projector import projectors as tproj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, game_arrays, optimizer_pair, projected_arrays
from tests.torch_parity import to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

RTOL = 1e-8


def _random_host_blocks(rng, shapes):
    blocks = []
    for e, cap, d, with_cols in shapes:
        b = {"features": rng.normal(size=(e, cap, d)), "labels": rng.uniform(size=(e, cap)),
             "weights": rng.uniform(size=(e, cap)),
             "sample_rows": rng.integers(-1, 500, size=(e, cap)).astype(np.int32),
             "entity_rows": rng.permutation(1000)[:e].astype(np.int32)}
        if with_cols:
            b["col_index"] = rng.integers(0, d + 1, size=(e, d)).astype(np.int32)
        blocks.append(b)
    return blocks


@pytest.mark.parametrize("with_cols", [False, True], ids=["identity", "index-map"])
def test_compact_lane_blocks_match(with_cols):
    rng = np.random.default_rng(0)
    blocks = _random_host_blocks(rng, [(9, 8, 3, with_cols), (5, 8, 3, with_cols),
                                       (12, 32, 3, with_cols), (7, 8, 3, with_cols)])
    groups = [[(0, np.array([1, 4, 8])), (1, np.array([0, 2])), (3, np.array([6]))],
              [(2, np.arange(12))]]
    device_blocks = [{k: torch.from_numpy(v) for k, v in b.items()} for b in blocks]
    for picks in groups:
        pad_to = tls._pow2_lanes(sum(len(l) for _, l in picks))
        assert pad_to == jls._pow2_lanes(sum(len(l) for _, l in picks))
        ref = jgd.compact_lane_blocks(blocks, picks, pad_to=pad_to,
                                      sentinel_row=jls.SENTINEL_ROW)
        got = tgd.compact_lane_blocks(device_blocks, picks, pad_to=pad_to,
                                      sentinel_row=tls.SENTINEL_ROW)
        assert sorted(ref[0]) == sorted(got[0])
        for key in ref[0]:
            assert got[0][key].numpy().dtype == ref[0][key].dtype, key
            assert np.array_equal(got[0][key].numpy(), ref[0][key]), key
        for i in (1, 2):
            assert np.array_equal(ref[i], got[i])
    with pytest.raises(ValueError, match="do not fit pad_to"):
        tgd.compact_lane_blocks(device_blocks, groups[1], pad_to=8, sentinel_row=0)


def _build_pair(a, jd, td, projector, **build):
    kw = dict(active_data_upper_bound=40, active_data_lower_bound=2, **build)
    return (jgd.build_random_effect_dataset(
                jd, "user", "per_entity", projector_type=jproj.ProjectorType[projector], **kw),
            tgd.build_random_effect_dataset(
                td, "user", "per_entity", projector_type=tproj.ProjectorType[projector], **kw))


def _scheduled_pair(projector, lanes="LBFGS", *, freeze=(0.0, 0.0), probe=2, iterations=12,
                    seed=3):
    a = (game_arrays(seed) if projector == "IDENTITY" else projected_arrays(seed))
    jd, td = datasets(a)
    jre, tre = _build_pair(a, jd, td, projector,
                           **({"projected_dim": 5} if projector == "RANDOM" else {}))
    sched = dict(probe_iterations=probe, freeze_coefficient_tolerance=freeze[0],
                 freeze_gradient_tolerance=freeze[1])
    jopt, topt = optimizer_pair(lanes, iterations, rel_function_tolerance=1e-6)
    jopt = dataclasses.replace(jopt, scheduler=JSched(**sched))
    topt = dataclasses.replace(topt, scheduler=TSched(**sched))
    common = dict(coordinate_id="per_user", intercept_index=0 if projector != "IDENTITY" else 2)
    jc = jcoord.RandomEffectCoordinate(
        dataset=jd, re_dataset=jre, task=JTask.LOGISTIC_REGRESSION,
        config=jcoord.CoordinateOptimizationConfig(optimizer=jopt, l2_weight=1.0), **common)
    tc = tcoord.RandomEffectCoordinate(
        dataset=td, re_dataset=tre, task=TTask.LOGISTIC_REGRESSION,
        config=tcoord.CoordinateOptimizationConfig(optimizer=topt, l2_weight=1.0), **common)
    return jc, tc, td


def _assert_close(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(to_np(got), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30))


def _sweeps(jc, tc, td, sweeps=3):
    """``sweeps`` scheduled updates with changing residual offsets; per sweep
    the tables, the traces and the scheduler's stats compared."""
    extra = 0.3 * np.random.default_rng(2).normal(size=td.num_samples)
    jm, tm = jc.initial_model(), tc.initial_model()
    stats = []
    for sweep in range(sweeps):
        jc.set_sweep(sweep, sweeps)
        tc.set_sweep(sweep, sweeps)
        scale = 1.0 + 0.1 * sweep
        jm, jinfo = jc.update_model(jm, jnp.asarray(extra) * scale)
        tm, tinfo = tc.update_model(tm, torch.from_numpy(extra) * scale)
        _assert_close(tm.coefficients, jm.coefficients)
        assert len(jinfo.buckets) == len(tinfo.buckets)
        for jt, tt in zip(jinfo.buckets, tinfo.buckets):
            assert np.array_equal(np.asarray(jt.iterations), tt.iterations.numpy())
            assert np.array_equal(np.asarray(jt.reason), tt.reason.numpy())
            assert np.array_equal(np.asarray(jt.valid), tt.valid.numpy())
            np.testing.assert_allclose(tt.value.numpy(), np.asarray(jt.value), rtol=1e-9,
                                       atol=1e-9)
        js, ts = jc._scheduler.last_stats, tc._scheduler.last_stats
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        stats.append(ts)
        if sweep < sweeps - 1 and jc._scheduler.frozen_rows is not None:
            assert np.array_equal(jc._scheduler.frozen_rows, tc._scheduler.frozen_rows)
    assert tc._scheduler.frozen_rows is None and jc._scheduler.frozen_rows is None
    return stats


@pytest.mark.parametrize("freeze", [(0.0, 0.0), (0.3, 0.3)], ids=["no-freeze", "freeze"])
@pytest.mark.parametrize("projector", ["IDENTITY", "INDEX_MAP", "RANDOM"])
def test_scheduled_updates_match(projector, freeze):
    jc, tc, td = _scheduled_pair(projector, freeze=freeze)
    stats = _sweeps(jc, tc, td, sweeps=4 if freeze[0] else 3)
    assert stats[0].lanes_probed == stats[0].lanes_total > 0
    assert sum(s.lanes_rescued for s in stats) > 0 and sum(s.rescue_blocks for s in stats) > 0
    if freeze[0]:
        assert sum(s.lanes_newly_frozen for s in stats) > 0
        assert sum(s.lanes_frozen_skipped for s in stats) > 0
        assert stats[-1].lanes_frozen_skipped == 0  # the final sweep runs everyone


@pytest.mark.parametrize("lanes", ["OWLQN", "NEWTON", "TRON"])
def test_scheduled_updates_with_the_other_lanes_match(lanes):
    jc, tc, td = _scheduled_pair("IDENTITY", lanes, iterations=10 if lanes != "TRON" else 8)
    if lanes == "OWLQN":
        for c in (jc, tc):
            c.config = dataclasses.replace(c.config, l1_weight=0.2)
    _sweeps(jc, tc, td, sweeps=2)


def test_scheduled_update_records_counters():
    from photon_ml_torch.telemetry.registry import MetricsRegistry

    reg = MetricsRegistry()
    _, tc, td = _scheduled_pair("IDENTITY")
    tc._scheduler = tls.LaneScheduler(tc.config.optimizer.scheduler, registry=reg)
    tm, _ = tc.update_model(tc.initial_model(), None)
    snap = reg.snapshot()
    stats = tc._scheduler.last_stats
    assert reg.counter("scheduler/sweeps").value == 1
    assert reg.counter("scheduler/lanes_probed").value == stats.lanes_probed
    assert reg.counter("scheduler/rescue_blocks").value == stats.rescue_blocks
    assert reg.histogram(tls.LANE_ITERS_METRIC).count == stats.lanes_total
    assert snap


def test_scheduler_none_is_bitwise_the_plain_update():
    jc, tc, td = _scheduled_pair("IDENTITY")
    plain = dataclasses.replace(tc.config.optimizer, scheduler=None)
    tc.config = dataclasses.replace(tc.config, optimizer=plain)
    bare = tcoord.RandomEffectCoordinate(
        coordinate_id="per_user", dataset=td, re_dataset=tc.re_dataset, task=tc.task,
        config=tcoord.CoordinateOptimizationConfig(optimizer=dataclasses.replace(plain),
                                                   l2_weight=1.0), intercept_index=2)
    a, _ = tc.update_model(tc.initial_model(), None)
    b, _ = bare.update_model(bare.initial_model(), None)
    assert torch.equal(a.coefficients, b.coefficients)


def _errors(jc, tc, call):
    msgs = []
    for c in (jc, tc):
        with pytest.raises(ValueError) as err:
            call(c)
        msgs.append(str(err.value).splitlines()[0])
    return msgs


@pytest.mark.parametrize("case", ["buckets", "rows", "frozen-mask"])
def test_per_coordinate_errors_match(case):
    jc, tc, _ = _scheduled_pair("IDENTITY")
    jc.update_model(jc.initial_model(), None)
    tc.update_model(tc.initial_model(), None)

    def call(c):
        sched = c._scheduler
        ctx = c._prepare_solve(c.initial_model(), None)
        objective, projector, full_offsets, _n, _c, table = ctx
        blocks = c._scheduler_blocks(projector)
        opt = c.config.optimizer
        if case == "buckets":
            # the JAX package checks when it reads the buckets for compaction
            (sched._host_rows if hasattr(sched, "_host_rows") else sched._host_cache)(blocks[:-1])
        elif case == "rows":
            sched.solve(objective, opt, blocks, full_offsets, table[:-1])
        else:
            sched.freeze_rows(np.zeros(3, dtype=bool))
            sched.solve(objective, opt, blocks, full_offsets, table, final_sweep=False)

    ref, got = _errors(jc, tc, call)
    assert got == ref


def test_refresh_selection_shape_error_matches():
    jc, tc, _ = _scheduled_pair("IDENTITY")
    ref, got = _errors(jc, tc, lambda c: c.set_refresh_selection(np.zeros(3, dtype=bool)))
    assert got == ref


def _scheduled_estimators(freeze=(0.0, 0.0), **kw):
    """``estimator_pair``'s GAME configuration with both random effects
    lane-scheduled (probe 2, a live function stop at 1e-6)."""
    from tests.torch_game_parity import estimator_pair

    je, te = estimator_pair(lane_iterations=12, **kw)
    sched = dict(probe_iterations=2, freeze_coefficient_tolerance=freeze[0],
                 freeze_gradient_tolerance=freeze[1])

    def scheduled(est, cls):
        configs = dict(est.coordinate_configs)
        for cid in ("per_user", "per_item"):
            c = configs[cid]
            opt = dataclasses.replace(c.optimization.optimizer, rel_function_tolerance=1e-6,
                                      scheduler=cls(**sched))
            configs[cid] = dataclasses.replace(
                c, optimization=dataclasses.replace(c.optimization, optimizer=opt))
        return dataclasses.replace(est, coordinate_configs=configs)

    return scheduled(je, JSched), scheduled(te, TSched)


@pytest.mark.parametrize("freeze", [(0.0, 0.0), (0.3, 0.3)], ids=["no-freeze", "freeze"])
def test_scheduled_game_fit_matches(freeze):
    from tests.torch_game_parity import assert_models_close

    a = game_arrays(5)
    jd, td = datasets(a)
    je, te = _scheduled_estimators(freeze, num_iterations=2)
    jr, tr = je.fit(jd), te.fit(td)
    assert_models_close(jr.model, tr.model)
    for jh, th in zip(jr.metric_history, tr.metric_history):
        assert jh.keys() == th.keys()
        np.testing.assert_allclose([th[k] for k in th if k.startswith("train")],
                                   [jh[k] for k in jh if k.startswith("train")], rtol=1e-8)
