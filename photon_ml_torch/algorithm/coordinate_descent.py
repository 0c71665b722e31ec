"""Block coordinate descent over GAME coordinates with residual offsets.

Counterpart of ``photon_ml_tpu/algorithm/coordinate_descent.py``; reference
photon-lib algorithm/CoordinateDescent.scala, the GAME training loop. Per
(iteration, coordinate): compute the partial score (the full training score
minus this coordinate's own), retrain the coordinate against it, refresh the
full score (CoordinateDescent.scala:198-255); track the best model by the
first validation evaluator (:183-192, :323-356); locked coordinates never
retrain (:44-49).

Scores are [n] tensors on the dataset's device; the residual update is one
elementwise subtract. Checkpoints and telemetry are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import Coordinate
from photon_ml_torch.evaluation.evaluators import EvaluationData, Evaluator
from photon_ml_torch.models.game import DatumScoringModel, GameModel

logger = logging.getLogger(__name__)


class DivergenceError(RuntimeError):
    """A coordinate update produced non-finite scores or a non-finite
    objective value."""


@dataclasses.dataclass
class CoordinateDescentResult:
    model: GameModel
    best_model: GameModel
    best_metric: float
    metric_history: list


def _host(scores) -> np.ndarray:
    return scores.detach().cpu().numpy() if isinstance(scores, torch.Tensor) \
        else np.asarray(scores)


def run_coordinate_descent(
    coordinates: Mapping[str, Coordinate],
    update_sequence: Sequence[str],
    num_iterations: int,
    *,
    initial_models: Mapping[str, DatumScoringModel] | None = None,
    locked_coordinates: frozenset[str] | set[str] = frozenset(),
    training_evaluator: Evaluator | None = None,
    training_data: EvaluationData | None = None,
    validation_evaluators: Sequence[Evaluator] = (),
    validation_scorer=None,
    validation_data: EvaluationData | None = None,
    checkpointer=None,
    check_finite: bool = True,
    telemetry=None,
    on_update: Callable[[int, str, object], None] | None = None,
) -> CoordinateDescentResult:
    """Run block coordinate descent.

    validation_scorer: callable(GameModel) -> host array of validation
    scores; the FIRST validation evaluator selects the best model across
    updates, as in the reference (:183-192).

    check_finite: raise :class:`DivergenceError` the moment a coordinate
    update produces non-finite scores, instead of training on.

    on_update: called with (iteration, coordinate id, solver info) after
    each update: a SolverResult for a fixed effect, LaneTraces for a random
    effect.
    """
    if checkpointer is not None:
        raise NotImplementedError(
            "checkpoints in run_coordinate_descent are not ported yet: ROADMAP.md item 16")
    if telemetry is not None:
        raise NotImplementedError(
            "solver telemetry is not ported yet: ROADMAP.md item 19; use on_update")

    models: dict[str, DatumScoringModel] = {}
    scores: dict[str, torch.Tensor] = {}
    best_model: GameModel | None = None
    best_metric = float("nan")
    history: list[dict] = []

    for cid in update_sequence:
        coord = coordinates[cid]
        if initial_models and cid in initial_models:
            models[cid] = initial_models[cid]
        else:
            models[cid] = coord.initial_model()
        scores[cid] = coord.score(models[cid])

    def full_score():
        it = iter(scores.values())
        total = next(it).clone()
        for s in it:
            total = total + s
        return total

    for iteration in range(num_iterations):
        for cid in update_sequence:
            coord = coordinates[cid]
            if cid in locked_coordinates:
                continue
            # partial score = everything except this coordinate
            partial = full_score() - scores[cid]
            model, info = coord.update_model(models[cid], partial)
            models[cid] = model
            scores[cid] = coord.score(model)
            if check_finite:
                # reduce on the device: only a flag crosses to the host
                finite = bool(torch.isfinite(scores[cid]).all())
                if finite and info is not None and hasattr(info, "value"):
                    # a failed solve can leave finite warm-start coefficients
                    # but a non-finite objective (e.g. NaN labels)
                    finite = bool(np.isfinite(float(info.value)))
                if not finite:
                    raise DivergenceError(
                        f"coordinate '{cid}' produced non-finite scores at CD "
                        f"iteration {iteration}")

            metrics: dict[str, float] = {}
            if training_evaluator is not None and training_data is not None:
                # scores include the base offsets: the optimizer minimizes
                # the loss of margins with offsets
                total = _host(full_score()) + training_data.offsets
                metrics[f"train:{training_evaluator.name}"] = training_evaluator.evaluate(
                    total, training_data)

            game_model = GameModel(models=dict(models))
            if validation_evaluators and validation_scorer is not None \
                    and validation_data is not None:
                val_scores = _host(validation_scorer(game_model))
                for i, ev in enumerate(validation_evaluators):
                    v = ev.evaluate(val_scores, validation_data)
                    metrics[f"validate:{ev.name}"] = v
                    if i == 0 and (best_model is None or ev.better_than(v, best_metric)):
                        best_model, best_metric = game_model, v
            if metrics:
                logger.info("CD iter %d coord %s: %s", iteration, cid, metrics)
                history.append({"iteration": iteration, "coordinate": cid, **metrics})
            if on_update is not None:
                on_update(iteration, cid, info)

    final = GameModel(models=dict(models))
    if best_model is None:
        best_model = final
    return CoordinateDescentResult(model=final, best_model=best_model, best_metric=best_metric,
                                   metric_history=history)
