"""The GAME slice as a whole: ``GameEstimator.fit`` in both packages on one
numpy fixture (CPU, float64), the models carried across with
``photon_ml_torch.convert``, scores on held-out rows with unseen entities
equal at 1e-8, projected random effects and elastic-net and TRON lanes
included; the evaluators; and the options outside the slice, which raise
``NotImplementedError`` naming their ROADMAP item."""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.ops.normalization import NormalizationType
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig, OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import (
    assert_models_close,
    datasets,
    estimator_pair,
    game_arrays,
    model_to_plain,
    projected_arrays,
)


@pytest.mark.parametrize("lanes", ["LBFGS", "NEWTON", "AUTO"])
@pytest.mark.parametrize("norm", ["NONE", "STANDARDIZATION"])
def test_fit_and_held_out_scores_match(lanes, norm):
    train, held = game_arrays(0, held_out=300)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    je, te = estimator_pair(lanes=lanes, normalization=norm, upper_bound=60, lower_bound=2,
                            compute_variance=True)
    jr, tr = je.fit(jd), te.fit(td)
    assert_models_close(jr.model, tr.model, rtol=1e-7)
    for ref_ds, got_ds in ((jd, td), (jh, th)):
        ref = np.asarray(jr.model.score_dataset(ref_ds))
        got = tr.model.score(got_ds).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())
    assert int((th.entity_idx["user"] < 0).sum()) > 0
    # the JAX model carried into the port scores the same rows the same way
    carried = convert.game_model_from_numpy(model_to_plain(jr.model), device="cpu")
    np.testing.assert_allclose(carried.score(th).numpy(),
                               np.asarray(jr.model.score_dataset(jh)), rtol=1e-10, atol=1e-12)


def _projected_estimators(lanes: str, norm: str, *, l1: float = 0.0, tolerance: float = 1e-7,
                          compute_variance: bool = False, **user):
    """The same GAME configuration in both packages on ``projected_arrays``:
    a fixed effect on "global", a per-user effect on "per_entity" with
    ``user`` options (projector, width, Pearson ratio) and ``lanes``, and an
    IDENTITY per-item effect with Newton lanes."""
    from photon_ml_tpu import estimators as jest
    from photon_ml_tpu import estimators as jest
    from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCfg
    from photon_ml_tpu.ops.normalization import NormalizationType as JNorm
    from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
    from photon_ml_tpu.optim.optimizer import OptimizerType as JType
    from photon_ml_tpu.projector.projectors import ProjectorType as JProj

    def configs(est, cfg, opt, kind, proj):
        def o(t, it, **kw):
            return cfg(optimizer=opt(optimizer_type=kind[t], max_iterations=it,
                                     tolerance=tolerance if t == lanes else 1e-7),
                       l2_weight=1.0, compute_variance=compute_variance, **kw)

        kw = dict(user)
        if "projector_type" in kw:
            kw["projector_type"] = proj[kw["projector_type"]]
        return {"fixed": est.FixedEffectCoordinateConfig("global", o("LBFGS", 30)),
                "per_user": est.RandomEffectCoordinateConfig(
                    "user", "per_entity", o(lanes, 10, l1_weight=l1), active_data_lower_bound=2,
                    **kw),
                "per_item": est.RandomEffectCoordinateConfig("item", "per_entity",
                                                             o("NEWTON", 10))}

    common = dict(num_iterations=2, intercept_indices={"global": 4, "per_entity": 0})
    from photon_ml_torch.projector.projectors import ProjectorType as TProj
    je = jest.GameEstimator(task=JTask.LOGISTIC_REGRESSION, normalization=JNorm[norm],
                            coordinate_configs=configs(jest, JCfg, JOpt, JType, JProj),
                            use_pallas=False, **common)
    te = test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION, normalization=NormalizationType[norm],
                             coordinate_configs=configs(test_, CoordinateOptimizationConfig,
                                                        OptimizerConfig, OptimizerType, TProj),
                             **common)
    return je, te


PROJECTED_FITS = {
    "index-map-standardized-variances": dict(lanes="NEWTON", norm="STANDARDIZATION",
                                             compute_variance=True, projector_type="INDEX_MAP"),
    "random-scaled": dict(lanes="LBFGS", norm="SCALE_WITH_STANDARD_DEVIATION",
                          projector_type="RANDOM", projected_dim=5),
    "index-map-pearson": dict(lanes="NEWTON", norm="NONE", projector_type="INDEX_MAP",
                              features_to_samples_ratio=0.5),
    "identity-pearson": dict(lanes="LBFGS", norm="NONE", features_to_samples_ratio=0.5),
    "elastic-net-lanes": dict(lanes="LBFGS", norm="NONE", l1=0.05),
    "owlqn-index-map": dict(lanes="OWLQN", norm="STANDARDIZATION", l1=0.02,
                            projector_type="INDEX_MAP"),
    "tron-lanes": dict(lanes="TRON", norm="NONE", tolerance=1e-5),
    "tron-random": dict(lanes="TRON", norm="STANDARDIZATION", tolerance=1e-5,
                        projector_type="RANDOM", projected_dim=6),
}


@pytest.mark.parametrize("name", list(PROJECTED_FITS))
def test_projected_and_other_lane_fits_match(name):
    """A 2-sweep fit with a projected per-user effect, elastic-net (OWL-QN)
    or TRON lanes: models (variances included) within 1e-7 relative, scores
    on training and held-out rows (unseen users among them) within 1e-8."""
    train, held = projected_arrays(6, held_out=200)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    je, te = _projected_estimators(**PROJECTED_FITS[name])
    jr, tr = je.fit(jd), te.fit(td)
    assert_models_close(jr.model, tr.model, rtol=1e-7)
    for ref_ds, got_ds in ((jd, td), (jh, th)):
        ref = np.asarray(jr.model.score_dataset(ref_ds))
        np.testing.assert_allclose(tr.model.score(got_ds).numpy(), ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())
    losses = [h["train:LOGISTIC_LOSS"] for h in tr.metric_history]
    assert losses == pytest.approx([h["train:LOGISTIC_LOSS"] for h in jr.metric_history],
                                   rel=1e-9)
    assert int((th.entity_idx["user"] < 0).sum()) > 0


def test_lbfgsb_random_effect_fit_raises_the_references_error():
    _, td = datasets(projected_arrays(7, n=200))
    jd, _ = datasets(projected_arrays(7, n=200))
    je, te = _projected_estimators("LBFGSB", "NONE")
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints"):
        je.fit(jd)  # under jit the JAX package appends a traceback note
    with pytest.raises(ValueError, match="^LBFGSB requires box constraints$"):
        te.fit(td)


def test_fit_in_float32_runs_and_improves():
    """The production dtype on the CPU: the closed form in f32."""
    a = game_arrays(1)
    _, td = datasets(a, dtype=np.float32)
    _, te = estimator_pair(lanes="NEWTON")
    tr = te.fit(td)
    losses = [h["train:LOGISTIC_LOSS"] for h in tr.metric_history]
    assert losses[-1] < losses[0] and tr.model.get("fixed").glm.coefficients.means.dtype == \
        torch.float32


def test_fit_with_a_sparse_fixed_effect_shard_matches():
    from photon_ml_tpu import estimators as jest
    from photon_ml_tpu import estimators as jest
    from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCfg
    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_tpu.data.sparse_batch import SparseShard as JShard
    from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
    from photon_ml_tpu.optim.optimizer import OptimizerType as JType

    a = game_arrays(2, n=400)
    rng = np.random.default_rng(4)
    n, d = 400, 60
    rows, cols = np.repeat(np.arange(n), 5), rng.integers(0, d, size=5 * n)
    vals = rng.normal(size=5 * n)
    kw = dict(labels=a["labels"], entity_keys={"user": a["users"]}, weights=a["weights"],
              dtype=np.float64)
    shard = dict(rows=rows, cols=cols, vals=vals, num_samples=n, feature_dim=d)
    jd = jgd.build_game_dataset(feature_shards={"wide": JShard(**shard), "per_entity": a["xr"]},
                                **kw)
    td = tgd.build_game_dataset(feature_shards={"wide": SparseShard(**shard),
                                                "per_entity": a["xr"]}, device="cpu", **kw)

    def configs(est, cfg, opt, kind):
        o = lambda t, it: cfg(optimizer=opt(optimizer_type=kind[t], max_iterations=it),  # noqa: E731
                              l2_weight=1.0)
        return {"fixed": est.FixedEffectCoordinateConfig("wide", o("LBFGS", 30)),
                "per_user": est.RandomEffectCoordinateConfig("user", "per_entity",
                                                             o("NEWTON", 10))}

    jr = jest.GameEstimator(task=JTask.LOGISTIC_REGRESSION, num_iterations=2,
                            coordinate_configs=configs(jest, JCfg, JOpt, JType)).fit(jd)
    tr = test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION, num_iterations=2,
                             coordinate_configs=configs(test_, CoordinateOptimizationConfig,
                                                        OptimizerConfig, OptimizerType)).fit(td)
    assert_models_close(jr.model, tr.model)
    np.testing.assert_allclose(tr.model.score(td).numpy(), np.asarray(jr.model.score_dataset(jd)),
                               rtol=1e-8, atol=1e-9)


def _re_config(**kw):
    opt = kw.pop("optimization", CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=3), l2_weight=1.0))
    return test_.RandomEffectCoordinateConfig("user", "per_entity", opt, **kw)


def _lbfgs(**kw):
    return CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(OptimizerType.LBFGS, max_iterations=3, **kw), l2_weight=1.0)


@pytest.mark.parametrize("config,options,item", [
    (_re_config(optimization=_lbfgs(scheduler=LaneSchedulerConfig())), {}, 18),
], ids=["lane-scheduler"])
def test_coordinates_outside_the_slice_raise(config, options, item):
    """The coordinate kinds that waited for an item are ported: a
    lane-scheduled random effect (item 18) now fits, and matches the JAX
    package's scheduled fit."""
    from photon_ml_tpu import estimators as jest
    from photon_ml_tpu.algorithm.coordinates import CoordinateOptimizationConfig as JCfg
    from photon_ml_tpu.optim.optimizer import LaneSchedulerConfig as JSched
    from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOpt
    from photon_ml_tpu.optim.optimizer import OptimizerType as JType

    jd, td = datasets(game_arrays(3, n=200))
    jopt = JCfg(optimizer=JOpt(JType.LBFGS, max_iterations=3), l2_weight=1.0)
    jsched = JCfg(optimizer=JOpt(JType.LBFGS, max_iterations=3, scheduler=JSched()),
                  l2_weight=1.0)
    jr = jest.GameEstimator(
        task=JTask.LOGISTIC_REGRESSION, use_pallas=False,
        coordinate_configs={"fixed": jest.FixedEffectCoordinateConfig("global", jopt),
                            "other": jest.RandomEffectCoordinateConfig("user", "per_entity",
                                                                       jsched)}).fit(jd)
    est = test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION,
                              coordinate_configs={"fixed": test_.FixedEffectCoordinateConfig(
                                  "global", _lbfgs()), "other": config}, **options)
    assert item == 18 and config.optimization.optimizer.scheduler is not None
    assert_models_close(jr.model, est.fit(td).model)


@pytest.mark.parametrize("field,item", [("checkpointer", 16)])
def test_estimator_options_outside_the_slice_raise(field, item, tmp_path):
    """Checkpoints (item 16) are ported: one of another update sequence is
    refused. Telemetry is ported too (tests/test_torch_telemetry.py)."""
    _, td = datasets(game_arrays(4, n=200))
    _, te = estimator_pair(lanes="NEWTON", num_iterations=1)
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer

    ck = TrainingCheckpointer(tmp_path)
    ck.save(1, {}, {"model": {"order": ["other"]}})
    with pytest.raises(ValueError, match="incompatible"):
        dataclasses.replace(te, checkpointer=ck).fit(td)


@pytest.mark.parametrize("other", ["random-effect", "matrix-factorization"])
def test_feature_sharded_fit_needs_a_mesh(other):
    """fe_feature_sharded lays the fixed effect over a mesh's model axis
    (tests/test_torch_model_axis.py fits it over 1x2 and 2x2 meshes):
    without a mesh it is refused before any data is read."""
    config = (_re_config() if other == "random-effect"
              else test_.MatrixFactorizationCoordinateConfig("user", "item", 4, _lbfgs()))
    est = test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION, fe_feature_sharded=True,
                              coordinate_configs={"fixed": test_.FixedEffectCoordinateConfig(
                                  "global", _lbfgs()), "other": config})
    with pytest.raises(ValueError, match="^fe_feature_sharded requires a mesh"):
        est.fit(None)


def test_sparse_random_effect_shard_raises():
    """A random effect on a sparse shard trains compact; a RANDOM projection
    of it is refused as the JAX package refuses it."""
    a = game_arrays(5, n=60)
    shard = SparseShard(rows=np.arange(60), cols=np.zeros(60, dtype=np.int64),
                        vals=np.ones(60), num_samples=60, feature_dim=4)
    td = tgd.build_game_dataset(labels=a["labels"], feature_shards={"wide": shard},
                                entity_keys={"user": a["users"]}, dtype=np.float64,
                                device="cpu")
    est = test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION, coordinate_configs={
        "re": test_.RandomEffectCoordinateConfig("user", "wide", _lbfgs(),
                                                 projector_type="RANDOM", projected_dim=2)})
    with pytest.raises(ValueError, match="IDENTITY/INDEX_MAP"):
        est.fit(td)
    with pytest.raises(TypeError, match="unknown configuration"):
        test_.GameEstimator(task=TTask.LOGISTIC_REGRESSION,
                            coordinate_configs={"x": object()}).fit(td)


def test_standardization_without_an_intercept_falls_back_to_scaling():
    _, td = datasets(game_arrays(6, n=200))
    _, te = estimator_pair(normalization="STANDARDIZATION")
    te = dataclasses.replace(te, intercept_indices={})
    norms = te._prepare_normalization(td)
    assert set(norms) == {"global", "per_entity"}
    assert all(n.shifts is None and n.factors is not None for n in norms.values())
    assert dataclasses.replace(te, normalization=NormalizationType.NONE) \
        ._prepare_normalization(td) == {}


def test_device_policy_of_the_game_entry_points(monkeypatch):
    a = game_arrays(7, n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgd.build_game_dataset(labels=a["labels"], feature_shards={"global": a["xg"]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.game_model_from_numpy({})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.game_dataset_from_numpy(unique_ids=np.arange(2), labels=np.zeros(2),
                                        offsets=np.zeros(2), weights=np.ones(2),
                                        feature_shards={}, entity_idx={}, entity_vocabs={})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.random_effect_dataset_from_numpy(random_effect_type="u", feature_shard_id="s",
                                                 buckets=[], num_entities=0, dim=1)


SPECS = ["AUC", "AUPR", "RMSE", "MAE", "LOGISTIC_LOSS", "SQUARED_LOSS", "POISSON_LOSS",
         "SMOOTHED_HINGE_LOSS", "AUC:queryId", "RMSE:queryId", "PRECISION@3:queryId"]


@pytest.mark.parametrize("spec", SPECS)
def test_evaluators_match(spec):
    a = game_arrays(8)
    rng = np.random.default_rng(0)
    scores = rng.normal(size=len(a["labels"]))
    data = dict(labels=a["labels"], offsets=a["offsets"], weights=a["weights"],
                ids={"queryId": a["query"]})
    ref, got = jev.parse_evaluator(spec), tev.parse_evaluator(spec)
    assert (got.name, got.larger_is_better) == (ref.name, ref.larger_is_better)
    np.testing.assert_allclose(got.evaluate(scores, tev.EvaluationData(**data)),
                               ref.evaluate(scores, jev.EvaluationData(**data)), rtol=1e-12)
    assert got.better_than(1.0, float("nan")) and not got.better_than(float("nan"), 1.0)
    assert got.better_than(2.0, 1.0) == ref.better_than(2.0, 1.0)


@pytest.mark.parametrize("spec,error", [("NOPE", "Unknown evaluator"), ("AUC:", "missing an id"),
                                        ("MAE:queryId", "Unsupported per-query"),
                                        ("PRECISION@0:queryId", "positive integer")])
def test_bad_evaluator_specs_raise(spec, error):
    with pytest.raises(ValueError, match=error):
        tev.parse_evaluator(spec)


def test_evaluator_helpers():
    for task in ("LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION",
                 "SMOOTHED_HINGE_LOSS_LINEAR_SVM"):
        assert tev.default_evaluator_for_task(TTask[task]).name == \
            jev.default_evaluator_for_task(JTask[task]).name
    a = game_arrays(9, n=100)
    data = tev.EvaluationData(labels=a["labels"], offsets=a["offsets"], weights=a["weights"])
    with pytest.raises(KeyError, match="queryId"):
        tev.parse_evaluator("AUC:queryId").evaluate(np.zeros(100), data)
    one_class = tev.EvaluationData(labels=np.ones(100), offsets=a["offsets"],
                                   weights=a["weights"], ids={"queryId": a["query"]})
    assert np.isnan(tev.parse_evaluator("AUC:queryId").evaluate(np.zeros(100), one_class))
    with pytest.raises(NotImplementedError):
        tev.Evaluator().evaluate(np.zeros(1), data)
