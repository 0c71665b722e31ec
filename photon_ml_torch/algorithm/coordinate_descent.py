"""Block coordinate descent over GAME coordinates with residual offsets.

Counterpart of ``photon_ml_tpu/algorithm/coordinate_descent.py``; reference
photon-lib algorithm/CoordinateDescent.scala, the GAME training loop. Per
(iteration, coordinate): compute the partial score (the full training score
minus this coordinate's own), retrain the coordinate against it, refresh the
full score (CoordinateDescent.scala:198-255); track the best model by the
first validation evaluator (:183-192, :323-356); locked coordinates never
retrain (:44-49).

Scores are [n] tensors on the dataset's device; the residual update is one
elementwise subtract. With a checkpointer, coordinate-descent progress is
saved every ``checkpoint_every`` updates and at the last one
(``io/checkpoint.pack_cd_state``), and a resumed run skips the updates the
checkpoint holds. Solver telemetry is ROADMAP.md item 19.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import Coordinate
from photon_ml_torch.evaluation.evaluators import EvaluationData, Evaluator
from photon_ml_torch.io.checkpoint import (  # noqa: F401  (DivergenceError re-exported)
    DivergenceError,
    commit_checkpoint,
    pack_cd_state,
    unpack_cd_state,
)
from photon_ml_torch.models.game import DatumScoringModel, GameModel
from photon_ml_torch.resilience import recovery

logger = logging.getLogger(__name__)


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
    checkpoint_every: int = 1,
    resume: bool = True,
    check_finite: bool = True,
    telemetry=None,
    on_update: Callable[[int, str, object], None] | None = None,
) -> CoordinateDescentResult:
    """Run block coordinate descent.

    validation_scorer: callable(GameModel) -> host array of validation
    scores; the FIRST validation evaluator selects the best model across
    updates, as in the reference (:183-192).

    checkpointer: an ``io/checkpoint.TrainingCheckpointer``. Progress (the
    current models, the best model, the metric history) is saved every
    ``checkpoint_every`` coordinate updates and at the last update; with
    ``resume=True`` the newest checkpoint is restored and the updates it
    holds are skipped. A checkpoint of another update sequence is refused.

    check_finite: raise :class:`DivergenceError` the moment a coordinate
    update produces non-finite scores, instead of training on.

    on_update: called with (iteration, coordinate id, solver info) after
    each update: a SolverResult for a fixed effect, LaneTraces for a random
    effect.
    """
    if telemetry is not None:
        raise NotImplementedError(
            "solver telemetry is not ported yet: ROADMAP.md item 19; use on_update")

    models: dict[str, DatumScoringModel] = {}
    scores: dict[str, torch.Tensor] = {}
    best_model: GameModel | None = None
    best_metric = float("nan")
    history: list[dict] = []
    start_slot = 0  # the global update counter: iteration * len(sequence) + position

    restored = None
    if checkpointer is not None and resume:
        ckpt = checkpointer.restore()
        if ckpt is not None:
            saved_order = ckpt.meta.get("model", {}).get("order")
            # the fast-forward maps the checkpoint's step onto this sequence's
            # slots, so the order must match exactly
            if saved_order is not None and list(saved_order) != list(update_sequence):
                raise ValueError(
                    "checkpoint is incompatible with this run: it holds "
                    f"coordinates {saved_order} but the update sequence is "
                    f"{list(update_sequence)}; pass resume=False or a fresh "
                    "checkpoint directory")
            device = getattr(getattr(coordinates[update_sequence[0]], "dataset", None),
                             "device", None)
            restored_model, best_model, best_metric, history = unpack_cd_state(ckpt,
                                                                               device=device)
            restored = restored_model.models
            start_slot = int(ckpt.step)
            recovery.counts["checkpoint_restores"] += 1
            logger.info("Resuming coordinate descent from checkpoint step %d", start_slot)

    for cid in update_sequence:
        coord = coordinates[cid]
        if restored is not None and cid in restored:
            models[cid] = restored[cid]
        elif initial_models and cid in initial_models:
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

    n_seq = len(update_sequence)
    # the last slot that updates (locked coordinates never reach the save)
    unlocked = [i for i, c in enumerate(update_sequence) if c not in locked_coordinates]
    final_update_slot = (num_iterations - 1) * n_seq + max(unlocked) if unlocked else -1
    for iteration in range(num_iterations):
        for position, cid in enumerate(update_sequence):
            slot = iteration * n_seq + position
            coord = coordinates[cid]
            if cid in locked_coordinates:
                continue
            if slot < start_slot:
                coord.skip_update()  # done before the restored checkpoint
                continue
            if hasattr(coord, "set_sweep"):
                # a lane-scheduled random effect's active set needs the final
                # sweep, which runs every entity
                coord.set_sweep(iteration, num_iterations)
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
                        f"iteration {iteration}"
                        + (f"; last good checkpoint: step {checkpointer.latest_step()} in "
                           f"{checkpointer.directory}" if checkpointer is not None else ""))

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
            if checkpointer is not None and (
                    (slot + 1) % max(1, checkpoint_every) == 0 or slot == final_update_slot):
                arrays, meta = pack_cd_state(GameModel(models=dict(models)), best_model,
                                             best_metric, history)
                commit_checkpoint(checkpointer, slot + 1, arrays, meta)

    final = GameModel(models=dict(models))
    if best_model is None:
        best_model = final
    return CoordinateDescentResult(model=final, best_model=best_model, best_metric=best_metric,
                                   metric_history=history)
