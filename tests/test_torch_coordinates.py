"""Each coordinate's ``update_model`` in the port against the JAX package's
on one numpy fixture, on the CPU in float64: coefficients, tables and
variances within 1e-8 relative, per-lane iterations and reasons equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.optim.optimizer import LaneSchedulerConfig as JScheduler
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.ops import packed_glm
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig as TScheduler
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, game_arrays, optimizer_pair
from tests.torch_parity import normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _configs(kind, iterations, tolerance=1e-7, **kw):
    jopt, topt = optimizer_pair(kind, iterations, tolerance=tolerance)
    return (jcoord.CoordinateOptimizationConfig(optimizer=jopt, **kw),
            tcoord.CoordinateOptimizationConfig(optimizer=topt, **kw))


def _fe_pair(a, jd, td, task, norm_kind, **cfg):
    jcfg, tcfg = _configs("LBFGS", 40, l2_weight=0.5, **cfg)
    jn, tn = normalizations(norm_kind, a["xg"], intercept_index=5)
    common = dict(coordinate_id="fixed", feature_shard_id="global", intercept_index=5)
    return (jcoord.FixedEffectCoordinate(dataset=jd, task=JTask[task], config=jcfg,
                                         normalization=jn, use_pallas=False, **common),
            tcoord.FixedEffectCoordinate(dataset=td, task=TTask[task], config=tcfg,
                                         normalization=tn, **common))


def _assert_close(got, ref, rtol=1e-8):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_np(got), ref, rtol=rtol,
                               atol=rtol * max(np.nanmax(np.abs(ref)), 1e-30))


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION",
                                  "POISSON_REGRESSION"])
@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
def test_fixed_effect_update_matches(task, norm):
    a = game_arrays(0, task=task)
    jd, td = datasets(a)
    jc, tc = _fe_pair(a, jd, td, task, norm)
    extra = 0.2 * np.random.default_rng(1).normal(size=td.num_samples)
    jm, tm = jc.initial_model(), tc.initial_model()
    for sweep in range(2):  # the second update warm-starts from the first
        jm, jres = jc.update_model(jm, jnp.asarray(extra) * (sweep + 1))
        tm, tres = tc.update_model(tm, torch.from_numpy(extra) * (sweep + 1))
        assert tres.iterations == int(jres.iterations) and tres.reason == int(jres.reason)
        _assert_close(tm.glm.coefficients.means, jm.glm.coefficients.means)
        _assert_close(tc.score(tm), jc.score(jm))
    assert tm.feature_shard_id == "global" and tm.task == TTask[task]


@pytest.mark.parametrize("task,rate", [("LOGISTIC_REGRESSION", 0.6), ("LINEAR_REGRESSION", 0.5)])
def test_fixed_effect_down_sampling_matches(task, rate):
    a = game_arrays(1, task=task)
    jd, td = datasets(a)
    jc, tc = _fe_pair(a, jd, td, task, "NONE", down_sampling_rate=rate)
    jm, tm = jc.initial_model(), tc.initial_model()
    previous = None
    for _ in range(2):  # the sampling seed rotates per update
        jm, _ = jc.update_model(jm, None)
        tm, _ = tc.update_model(tm, None)
        _assert_close(tm.glm.coefficients.means, jm.glm.coefficients.means)
        assert previous is None or not np.allclose(previous, to_np(tm.glm.coefficients.means))
        previous = to_np(tm.glm.coefficients.means)
    assert tc._update_count == jc._update_count == 2


@pytest.mark.parametrize("mode", ["full", "diagonal"])
def test_fixed_effect_variances_match(mode):
    a = game_arrays(2)
    jd, td = datasets(a)
    jc, tc = _fe_pair(a, jd, td, "LOGISTIC_REGRESSION", "STANDARDIZATION",
                      compute_variance=True, variance_mode=mode)
    jm, _ = jc.update_model(jc.initial_model(), None)
    tm, _ = tc.update_model(tc.initial_model(), None)
    _assert_close(tm.glm.coefficients.variances, jm.glm.coefficients.variances, rtol=1e-7)


@pytest.mark.parametrize("unit", ["fma", "mma"])
@pytest.mark.parametrize("aux", ["packed", "columns"])
def test_fixed_effect_update_through_the_packed_path(unit, aux):
    """``use_kernel=True`` on the CPU runs the packed kernel's plain version
    in f32; the JAX coordinate runs its Pallas kernel in interpret mode. The
    solves agree to f32 solver accuracy (1e-3 of the largest coefficient)."""
    a = game_arrays(3)
    jd, td = datasets(a, dtype=np.float32)
    jc, tc = _fe_pair(a, jd, td, "LOGISTIC_REGRESSION", "NONE")
    jn, tn = normalizations("STANDARDIZATION", a["xg"], intercept_index=5, dtype=np.float32)
    jc = dataclasses.replace(jc, use_pallas=True, normalization=jn)
    tc = dataclasses.replace(tc, use_kernel=True, kernel_unit=unit, kernel_aux=aux,
                             normalization=tn)
    before = (packed_glm.packed_launches, packed_glm.columns_launches)
    jm, _ = jc.update_model(jc.initial_model(), None)
    tm, tres = tc.update_model(tc.initial_model(), None)
    assert tres.iterations > 3
    _assert_close(tm.glm.coefficients.means, jm.glm.coefficients.means, rtol=1e-3)
    # on the CPU nothing is launched: the counters count kernel launches only
    assert (packed_glm.packed_launches, packed_glm.columns_launches) == before


def _re_pair(a, jd, td, task, lanes, norm_kind="NONE", iterations=10, **cfg):
    jcfg, tcfg = _configs(lanes, iterations, l2_weight=1.0, **cfg)
    jn, tn = (None, None) if norm_kind is None else normalizations(
        norm_kind, a["xr"], intercept_index=2)
    kw = dict(active_data_upper_bound=40, active_data_lower_bound=2)
    jre = jgd.build_random_effect_dataset(jd, "user", "per_entity", **kw)
    tre = tgd.build_random_effect_dataset(td, "user", "per_entity", **kw)
    common = dict(coordinate_id="per_user", intercept_index=2)
    return (jcoord.RandomEffectCoordinate(dataset=jd, re_dataset=jre, task=JTask[task],
                                          config=jcfg, normalization=jn, **common),
            tcoord.RandomEffectCoordinate(dataset=td, re_dataset=tre, task=TTask[task],
                                          config=tcfg, normalization=tn, **common))


def _assert_traces_equal(jinfo, tinfo):
    assert len(jinfo.buckets) == len(tinfo.buckets)
    for jt, tt in zip(jinfo.buckets, tinfo.buckets):
        assert np.array_equal(np.asarray(jt.iterations), tt.iterations.numpy())
        assert np.array_equal(np.asarray(jt.reason), tt.reason.numpy())
        assert np.array_equal(np.asarray(jt.valid), tt.valid.numpy())
        np.testing.assert_allclose(tt.value.numpy(), np.asarray(jt.value), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("lanes", ["LBFGS", "NEWTON", "AUTO"])
@pytest.mark.parametrize("task,norm", [("LOGISTIC_REGRESSION", None),
                                       ("LOGISTIC_REGRESSION", "STANDARDIZATION"),
                                       ("LINEAR_REGRESSION", "SCALE_WITH_STANDARD_DEVIATION"),
                                       ("POISSON_REGRESSION", None)])
def test_random_effect_update_matches(lanes, task, norm):
    a = game_arrays(4, task=task)
    jd, td = datasets(a)
    # a Newton step is exact for the squared loss up to the 1e-7 jitter: at
    # the default tolerance a second round would compare step candidates
    # whose values tie at rounding level, so these lanes stop after one
    tolerance = 1e-5 if task == "LINEAR_REGRESSION" and lanes != "LBFGS" else 1e-7
    jc, tc = _re_pair(a, jd, td, task, lanes, norm, tolerance=tolerance)
    extra = 0.3 * np.random.default_rng(2).normal(size=td.num_samples)
    jm, tm = jc.initial_model(), tc.initial_model()
    assert tm.coefficients.shape == jm.coefficients.shape
    for sweep in range(2):
        jm, jinfo = jc.update_model(jm, jnp.asarray(extra) * (sweep + 1))
        tm, tinfo = tc.update_model(tm, torch.from_numpy(extra) * (sweep + 1))
        _assert_traces_equal(jinfo, tinfo)
        _assert_close(tm.coefficients, jm.coefficients)
        _assert_close(tc.score(tm), jc.score(jm))
    assert tm.variances is None
    # entities below the lower bound were never trained: their rows stay 0
    trained = np.concatenate([b.entity_rows.numpy() for b in tc.re_dataset.buckets])
    untrained = np.setdiff1d(np.arange(tm.num_entities), trained)
    assert len(untrained) > 0 and float(tm.coefficients[untrained].abs().sum()) == 0.0


@pytest.mark.parametrize("mode", ["full", "diagonal"])
@pytest.mark.parametrize("norm", [None, "SCALE_WITH_STANDARD_DEVIATION"])
def test_random_effect_variances_match(mode, norm):
    a = game_arrays(5)
    jd, td = datasets(a)
    jc, tc = _re_pair(a, jd, td, "LOGISTIC_REGRESSION", "NEWTON", norm, compute_variance=True,
                      variance_mode=mode)
    jm, _ = jc.update_model(jc.initial_model(), None)
    tm, _ = tc.update_model(tc.initial_model(), None)
    ref, got = np.asarray(jm.variances), tm.variances.numpy()
    assert np.array_equal(np.isnan(ref), np.isnan(got)) and np.isnan(got).any()
    np.testing.assert_allclose(got[~np.isnan(got)], ref[~np.isnan(ref)], rtol=1e-7)


def test_solve_config_matches():
    for kind, l1 in (("AUTO", 0.0), ("AUTO", 0.3), ("LBFGS", 0.2), ("TRON", 0.0), ("OWLQN", 0.0)):
        jcfg, tcfg = _configs(kind, 7, l1_weight=l1)
        for small in (False, True):
            from photon_ml_tpu.ops.losses import LogisticLoss as JLoss
            from photon_ml_torch.ops.losses import LogisticLoss as TLoss
            ref = jcoord._solve_config(jcfg, loss=JLoss(), small_dense=small)
            got = tcoord._solve_config(tcfg, loss=TLoss(), small_dense=small)
            assert got.optimizer_type.name == ref.optimizer_type.name
            assert got.l1_weight == ref.l1_weight and got.max_iterations == 7
        assert tcfg.uses_owlqn == jcfg.uses_owlqn
    with pytest.raises(ValueError, match="variance"):
        tcoord.CoordinateOptimizationConfig(optimizer=tcfg.optimizer, variance_mode="bogus")


def test_model_coordinate_and_base_class():
    a = game_arrays(6)
    jd, td = datasets(a)
    _, tc = _re_pair(a, jd, td, "LOGISTIC_REGRESSION", "NEWTON")
    model, _ = tc.update_model(tc.initial_model(), None)
    locked = tcoord.ModelCoordinate("per_user", td, model)
    assert locked.initial_model() is model
    same, info = locked.update_model(model, torch.zeros(td.num_samples, dtype=torch.float64))
    assert same is model and info is None
    assert torch.equal(locked.score(model), tc.score(model))
    base = tcoord.Coordinate()
    for call in (lambda: base.update_model(model, None), lambda: base.score(model),
                 base.initial_model):
        with pytest.raises(NotImplementedError):
            call()


def test_random_effect_scheduler_raises():
    """The lane scheduler is ported (it raised while it waited for item 18):
    a scheduled update matches the JAX package's."""
    a = game_arrays(7)
    jd, td = datasets(a)
    jc, tc = _re_pair(a, jd, td, "LOGISTIC_REGRESSION", "LBFGS")
    opt = dataclasses.replace(tc.config.optimizer, scheduler=TScheduler(probe_iterations=2))
    tc = dataclasses.replace(tc, config=dataclasses.replace(tc.config, optimizer=opt))
    jopt = dataclasses.replace(jc.config.optimizer, scheduler=JScheduler(probe_iterations=2))
    jc = dataclasses.replace(jc, config=dataclasses.replace(jc.config, optimizer=jopt))
    jm, jinfo = jc.update_model(jc.initial_model(), None)
    tm, tinfo = tc.update_model(tc.initial_model(), None)
    _assert_close(tm.coefficients, jm.coefficients)
    _assert_traces_equal(jinfo, tinfo)
    assert tc._scheduler.last_stats.lanes_probed > 0


def test_fixed_effect_on_a_sparse_shard_matches():
    """A sparse fixed-effect shard inside GAME: the port binds it with
    ``SparseLabeledPointBatch.from_shard`` once and re-offsets it per update."""
    from photon_ml_tpu.data.sparse_batch import SparseShard as JShard
    from photon_ml_torch.data.sparse_batch import SparseShard as TShard

    a = game_arrays(8, n=300)
    rng = np.random.default_rng(3)
    n, d = 300, 40
    rows = np.repeat(np.arange(n), 4)
    cols = rng.integers(0, d, size=4 * n)
    vals = rng.normal(size=4 * n)
    kw = dict(labels=a["labels"], entity_keys={"user": a["users"]}, offsets=a["offsets"],
              weights=a["weights"], dtype=np.float64)
    jd = jgd.build_game_dataset(feature_shards={"wide": JShard(
        rows=rows, cols=cols, vals=vals, num_samples=n, feature_dim=d)}, **kw)
    td = tgd.build_game_dataset(feature_shards={"wide": TShard(
        rows=rows, cols=cols, vals=vals, num_samples=n, feature_dim=d)}, device="cpu", **kw)
    jcfg, tcfg = _configs("LBFGS", 30, l2_weight=1.0)
    jc = jcoord.FixedEffectCoordinate("fixed", jd, "wide", JTask.LOGISTIC_REGRESSION, jcfg)
    tc = tcoord.FixedEffectCoordinate("fixed", td, "wide", TTask.LOGISTIC_REGRESSION, tcfg)
    extra = 0.2 * rng.normal(size=n)
    jm, tm = jc.initial_model(), tc.initial_model()
    for sweep in range(2):
        jm, _ = jc.update_model(jm, jnp.asarray(extra) * sweep)
        tm, _ = tc.update_model(tm, torch.from_numpy(extra) * sweep)
        _assert_close(tm.glm.coefficients.means, jm.glm.coefficients.means)
        _assert_close(tc.score(tm), jc.score(jm))
    assert len(td._sparse_batches) == 1  # bound once, re-offset per update
    plain = convert.game_model_to_numpy(
        __import__("photon_ml_torch.models.game", fromlist=["GameModel"]).GameModel({"fixed": tm}))
    assert plain["fixed"]["means"].shape == (d,)
