"""GameTransformer: the scoring facade.

Counterpart of ``photon_ml_tpu/transformers.py``; reference photon-api
transformers/GameTransformer.scala:156-298 — score a GAME dataset with a
GameModel (sum of sub-model scores) plus the dataset's offsets, then run the
evaluators on the host. ``mesh=`` scores each rank's rows through
``parallel/scoring.DistributedScorer`` and gathers them; every rank of the
mesh calls ``transform`` with the same dataset. ``fe_feature_sharded`` lays
the fixed effect's feature axis over the mesh's "model" axis (True, or the
coordinate id; it requires a mesh).
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
    #: a ("data", "model") DeviceMesh (``parallel/mesh.make_mesh``): score
    #: through DistributedScorer instead of the one-device path
    mesh: object | None = None
    #: the fixed effect whose feature axis shards over "model" (True: the
    #: only one)
    fe_feature_sharded: "bool | str" = False
    #: the DistributedScorer, built on first use and kept across transforms;
    #: ``dataclasses.replace`` builds a new one
    _scorer: object | None = dataclasses.field(default=None, init=False, repr=False,
                                               compare=False)

    def transform(self, dataset: GameDataset) -> ScoredDataset:
        evaluations: dict[str, float] = {}
        if self.mesh is not None or self.fe_feature_sharded:
            from photon_ml_torch.parallel.scoring import DistributedScorer

            if self._scorer is None:
                self._scorer = DistributedScorer(self.model, self.mesh,
                                                 fe_feature_sharded=self.fe_feature_sharded)
            # the scores are gathered anyway (they are the product), so the
            # metrics are the exact host evaluators'
            scores, evaluations = self._scorer.score_and_evaluate(dataset, self.evaluator_specs)
        else:
            scores = (self.model.score_dataset(dataset) + dataset.offsets).detach().cpu().numpy()
        if self.evaluator_specs and not evaluations:
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
