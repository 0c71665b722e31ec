"""GameTransformer: the scoring facade (the port's single-device form).

Counterpart of ``photon_ml_tpu/transformers.py``'s single-device branch;
reference photon-api transformers/GameTransformer.scala:156-298 — score a
GAME dataset with a GameModel (sum of sub-model scores) plus the dataset's
offsets, then run the evaluators on the host. The mesh-sharded scorer is
the multi-GPU slice's (ROADMAP.md item 15).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from photon_ml_torch.data.game_data import GameDataset
from photon_ml_torch.evaluation.evaluators import EvaluationData, parse_evaluator
from photon_ml_torch.models.game import GameModel


@dataclasses.dataclass
class ScoredDataset:
    """Per-sample scores + evaluation results (reference ScoredGameDatum)."""

    unique_ids: np.ndarray
    scores: np.ndarray
    evaluations: dict[str, float]


@dataclasses.dataclass
class GameTransformer:
    model: GameModel
    evaluator_specs: Sequence[str] = ()

    def transform(self, dataset: GameDataset) -> ScoredDataset:
        scores = (self.model.score_dataset(dataset) + dataset.offsets).detach().cpu().numpy()
        evaluations: dict[str, float] = {}
        if self.evaluator_specs:
            data = EvaluationData(
                labels=dataset.host_array("labels"),
                offsets=dataset.host_array("offsets"),
                weights=dataset.host_array("weights"),
                ids=dataset.ids,
            )
            for spec in self.evaluator_specs:
                ev = parse_evaluator(spec)
                evaluations[ev.name] = ev.evaluate(scores, data)
        return ScoredDataset(unique_ids=dataset.unique_ids, scores=scores,
                             evaluations=evaluations)
