"""``run_coordinate_descent`` in the port against the JAX package's on one
numpy fixture, on the CPU in float64: per-update training loss, fixed-effect
coefficients and random-effect tables of a 3-sweep run within 1e-8 relative,
for L-BFGS and Newton lanes, with and without standardization and
down-sampling, with a validation evaluator picking the best model."""

import numpy as np
import pytest
import torch

from photon_ml_torch.algorithm import coordinate_descent as tcd
from photon_ml_torch.algorithm.coordinates import lane_iteration_histogram
from photon_ml_torch.evaluation.evaluators import EvaluationData, parse_evaluator
from photon_ml_torch.optim.common import LaneTraces, SolverResult
from tests.torch_game_parity import assert_models_close, datasets, estimator_pair, game_arrays


def _assert_history_close(ref, got, rtol=1e-8):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert list(r) == list(g)
        assert (r["iteration"], r["coordinate"]) == (g["iteration"], g["coordinate"])
        for key in r:
            if key not in ("iteration", "coordinate"):
                np.testing.assert_allclose(g[key], r[key], rtol=rtol, err_msg=key)


@pytest.mark.parametrize("lanes", ["LBFGS", "NEWTON"])
@pytest.mark.parametrize("norm,rate", [("NONE", 1.0), ("STANDARDIZATION", 0.7)],
                         ids=["plain", "standardized-downsampled"])
def test_three_sweeps_match(lanes, norm, rate):
    a = game_arrays(0)
    jd, td = datasets(a)
    je, te = estimator_pair(lanes=lanes, normalization=norm, down_sampling_rate=rate,
                            upper_bound=40, lower_bound=2)
    jr, tr = je.fit(jd), te.fit(td)
    _assert_history_close(jr.metric_history, tr.metric_history)
    assert_models_close(jr.model, tr.model)
    assert len(tr.metric_history) == 9
    losses = [h["train:LOGISTIC_LOSS"] for h in tr.metric_history]
    assert losses[-1] < losses[2] < losses[0]  # the data loss falls sweep over sweep
    assert tr.best_model is tr.model and np.isnan(tr.best_metric)


@pytest.mark.parametrize("task,lanes", [("LINEAR_REGRESSION", "LBFGS"),
                                        ("POISSON_REGRESSION", "NEWTON")])
def test_other_tasks_match(task, lanes):
    a = game_arrays(1, task=task)
    jd, td = datasets(a)
    je, te = estimator_pair(task, lanes=lanes, num_iterations=2)
    jr, tr = je.fit(jd), te.fit(td)
    _assert_history_close(jr.metric_history, tr.metric_history)
    assert_models_close(jr.model, tr.model)


@pytest.mark.parametrize("evaluators", [("AUC",), ("LOGISTIC_LOSS", "AUC:queryId")])
def test_validation_evaluator_picks_the_best_model(evaluators):
    train, held = game_arrays(2, held_out=250)
    jd, td = datasets(train)
    jv, tv = datasets(held, vocabs=jd.entity_vocabs)
    je, te = estimator_pair(lanes="NEWTON", validation_evaluators=evaluators)
    jr, tr = je.fit(jd, validation_dataset=jv), te.fit(td, validation_dataset=tv)
    _assert_history_close(jr.metric_history, tr.metric_history)
    np.testing.assert_allclose(tr.best_metric, jr.best_metric, rtol=1e-8)
    assert_models_close(jr.best_model, tr.best_model)
    assert_models_close(jr.model, tr.model)
    first = f"validate:{parse_evaluator(evaluators[0]).name}"
    values = [h[first] for h in tr.metric_history]
    best = max(values) if parse_evaluator(evaluators[0]).larger_is_better else min(values)
    assert tr.best_metric == best


def test_locked_coordinate_and_warm_start():
    a = game_arrays(3)
    jd, td = datasets(a)
    je, te = estimator_pair(lanes="NEWTON", num_iterations=1)
    jr, tr = je.fit(jd), te.fit(td)
    import dataclasses
    je2 = dataclasses.replace(je, locked_coordinates=frozenset({"per_item"}), num_iterations=2)
    te2 = dataclasses.replace(te, locked_coordinates=frozenset({"per_item"}), num_iterations=2)
    jr2, tr2 = je2.fit(jd, initial_model=jr.model), te2.fit(td, initial_model=tr.model)
    _assert_history_close(jr2.metric_history, tr2.metric_history)
    assert_models_close(jr2.model, tr2.model)
    assert tr2.model.get("per_item") is tr.model.get("per_item")
    assert [h["coordinate"] for h in tr2.metric_history] == ["fixed", "per_user"] * 2
    with pytest.raises(ValueError, match="requires an initial model"):
        te2.fit(td)


def test_on_update_sees_solver_results_and_lane_traces():
    a = game_arrays(4)
    _, td = datasets(a)
    seen = []
    _, te = estimator_pair(lanes="LBFGS", num_iterations=2,
                           on_update=lambda it, cid, info: seen.append((it, cid, info)))
    te.fit(td)
    assert [(it, cid) for it, cid, _ in seen] == [
        (i, c) for i in range(2) for c in ("fixed", "per_user", "per_item")]
    assert isinstance(seen[0][2], SolverResult) and isinstance(seen[1][2], LaneTraces)
    hist = lane_iteration_histogram(seen[1][2])
    assert sum(hist.values()) == sum(int(t.valid.sum()) for t in seen[1][2].buckets)
    assert len(hist) > 1  # lanes finish at different iterations


def test_non_finite_update_raises():
    a = game_arrays(5)
    a["labels"] = a["labels"].copy()
    a["labels"][3] = np.nan
    _, td = datasets(a)
    _, te = estimator_pair(lanes="NEWTON", num_iterations=1)
    with pytest.raises(tcd.DivergenceError, match="fixed"):
        te.fit(td)


@pytest.mark.parametrize("kw,item", [({"checkpointer": object()}, 16)])
def test_checkpoints_and_telemetry_raise(kw, item, tmp_path):
    """Checkpoints (item 16) are ported: a checkpoint of another update
    sequence raises (tests/test_torch_checkpoint.py resumes them). Telemetry
    is ported too (tests/test_torch_telemetry.py)."""
    from photon_ml_torch.io.checkpoint import TrainingCheckpointer

    ck = TrainingCheckpointer(tmp_path)
    ck.save(1, {}, {"model": {"order": ["other"]}})
    with pytest.raises(ValueError, match="incompatible"):
        tcd.run_coordinate_descent({"fixed": None}, ["fixed"], 1, checkpointer=ck)


def test_run_without_evaluators_keeps_no_history():
    a = game_arrays(6, n=300)
    _, td = datasets(a)
    _, te = estimator_pair(lanes="NEWTON", num_iterations=1)
    sequence, coordinates = te._build_coordinates(td, None)
    result = tcd.run_coordinate_descent(coordinates, sequence, 1)
    assert result.metric_history == [] and result.best_model is result.model
    data = EvaluationData(labels=td.host_array("labels"), offsets=td.host_array("offsets"),
                          weights=td.host_array("weights"))
    with_loss = tcd.run_coordinate_descent(
        coordinates, sequence, 1, training_evaluator=parse_evaluator("LOGISTIC_LOSS"),
        training_data=data)
    assert len(with_loss.metric_history) == 3
    scores = result.model.score_dataset(td)
    assert scores.shape == (300,) and bool(torch.isfinite(scores).all())
