"""GAME <-> hyperparameter-search glue.

Reference parity: photon-client estimators/
GameEstimatorEvaluationFunction.scala (vectorize GAME configs <-> candidate
vectors; each evaluation is a full GameEstimator.fit) and
GameTrainingDriver.runHyperparameterTuning (GameTrainingDriver.scala:631-663:
RANDOM vs BAYESIAN mode, n iterations, tuned reg weights), plus
hyperparameter/HyperparameterSerialization.scala (config round trip).

Counterpart of ``photon_ml_tpu/hyperparameter/game_glue.py``: each
candidate is a whole ``GameEstimator.fit`` of the port, and the saved
``tuned-hyperparameters.json`` has the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Mapping, Sequence

import numpy as np

from photon_ml_torch.data.game_data import GameDataset
from photon_ml_torch.estimators import GameEstimator
from photon_ml_torch.hyperparameter.rescaling import DimensionSpec, VectorRescaling
from photon_ml_torch.hyperparameter.search import (
    GaussianProcessSearch,
    RandomSearch,
    SearchResult,
)


class HyperparameterTuningMode(enum.Enum):
    """Reference: HyperparameterTuningMode {NONE, RANDOM, BAYESIAN}."""

    NONE = "NONE"
    RANDOM = "RANDOM"
    BAYESIAN = "BAYESIAN"


@dataclasses.dataclass
class TuningResult:
    best_reg_weights: dict[str, float]
    best_value: float
    search: SearchResult
    #: (reg weights, fit result) per evaluated candidate — populated only
    #: with keep_models=True (ModelOutputMode.TUNED/ALL)
    tuned_results: list = dataclasses.field(default_factory=list)
    #: (reg weights, fit result) of the best tuning candidate — always
    #: tracked (O(1) memory) so best-over-all selection never needs the list
    best_result: tuple | None = None
    #: (reg weights, raw metric) per evaluated candidate — lightweight,
    #: always tracked; persisted so later runs can seed their search
    #: (reference HyperparameterSerialization priors)
    observations_reg: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GameHyperparameterTuner:
    """Tunes per-coordinate L2 regularization weights of a GameEstimator.

    Each candidate evaluation clones the estimator with the candidate's reg
    weights, runs a full fit, and reads the first validation evaluator —
    negated when larger-is-better so the searchers always minimize (the
    reference flips via Evaluator.betterThan in the same way).
    """

    estimator: GameEstimator
    #: coordinate id -> (low, high) λ range searched on a log scale
    reg_ranges: Mapping[str, tuple[float, float]]
    mode: HyperparameterTuningMode = HyperparameterTuningMode.BAYESIAN
    seed: int = 0

    def __post_init__(self):
        self._coord_ids = list(self.reg_ranges.keys())
        self.rescaling = VectorRescaling(
            [
                DimensionSpec(cid, lo, hi, log_scale=True)
                for cid, (lo, hi) in self.reg_ranges.items()
            ]
        )

    def _apply(self, reg_weights: Mapping[str, float]) -> GameEstimator:
        configs = dict(self.estimator.coordinate_configs)
        for cid, lam in reg_weights.items():
            cfg = configs[cid]
            configs[cid] = dataclasses.replace(
                cfg,
                optimization=dataclasses.replace(cfg.optimization, l2_weight=float(lam)),
            )
        return dataclasses.replace(self.estimator, coordinate_configs=configs)

    def tune(
        self,
        dataset: GameDataset,
        validation_dataset: GameDataset,
        *,
        num_iterations: int = 10,
        prior_observations: Sequence[tuple[Mapping[str, float], float]] = (),
        keep_models: bool = False,
    ) -> TuningResult:
        from photon_ml_torch.evaluation.evaluators import parse_evaluator

        if not self.estimator.validation_evaluators:
            raise ValueError("hyperparameter tuning needs validation_evaluators")
        evaluator = parse_evaluator(self.estimator.validation_evaluators[0])
        sign = -1.0 if evaluator.larger_is_better else 1.0
        tuned_results: list = []
        observations_reg: list = []
        best_seen: list = [None, np.inf]  # (reg, result), signed value

        def evaluate(candidate: np.ndarray) -> float:
            values = self.rescaling.to_hyperparameters(candidate)
            reg = dict(zip(self._coord_ids, values.tolist()))
            est = self._apply(reg)
            result = est.fit(dataset, validation_dataset=validation_dataset)
            if keep_models:
                tuned_results.append((reg, result))
            if not np.isnan(result.best_metric):  # keep the file strict JSON
                observations_reg.append((reg, float(result.best_metric)))
            value = sign * float(result.best_metric)
            if not np.isnan(value) and value < best_seen[1]:
                best_seen[0], best_seen[1] = (reg, result), value
            return value

        if self.mode == HyperparameterTuningMode.BAYESIAN:
            search: RandomSearch = GaussianProcessSearch(self.rescaling.dim, self.seed)
        elif self.mode == HyperparameterTuningMode.RANDOM:
            search = RandomSearch(self.rescaling.dim, self.seed)
        else:
            raise ValueError("tuning mode NONE — nothing to do")

        import logging

        for reg, value in prior_observations:
            if np.isnan(value):
                continue
            missing = [cid for cid in self._coord_ids if cid not in reg]
            if missing:
                # e.g. priors from a run with different coordinate names —
                # skip, don't crash after the grid already trained
                logging.getLogger(__name__).warning(
                    "skipping prior observation missing coordinates %s "
                    "(tunable: %s)", missing, self._coord_ids,
                )
                continue
            vec = np.array([reg[cid] for cid in self._coord_ids])
            search.observe_prior(self.rescaling.to_unit(vec), sign * value)
            # seed priors chain into this run's saved observations so a
            # sequence of seeded runs accumulates history
            observations_reg.append((dict(reg), float(value)))

        result = search.find(evaluate, num_iterations)
        best_values = self.rescaling.to_hyperparameters(result.best_candidate)
        return TuningResult(
            best_reg_weights=dict(zip(self._coord_ids, best_values.tolist())),
            best_value=sign * result.best_value,
            search=result,
            tuned_results=tuned_results,
            best_result=best_seen[0],
            observations_reg=observations_reg,
        )


def save_tuned_config(result: TuningResult, path: str) -> None:
    """JSON persistence of tuned reg weights (reference
    HyperparameterSerialization.scala)."""
    payload = {
        "best_reg_weights": result.best_reg_weights,
        "best_value": result.best_value,
        "observations": [
            {"candidate": o.candidate.tolist(), "value": o.value}
            for o in result.search.observations
        ],
        # hyperparameter-space observations, loadable as priors by a later
        # run (--hyperparameter-prior-json)
        "prior_observations": [
            {"reg_weights": reg, "metric": metric}
            for reg, metric in result.observations_reg
        ],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def load_prior_observations(path: str) -> list[tuple[dict, float]]:
    """Read a previous run's tuned-hyperparameters.json into (reg weights,
    metric) priors for ``GameHyperparameterTuner.tune``."""
    with open(path) as f:
        payload = json.load(f)
    return [
        (dict(o["reg_weights"]), float(o["metric"]))
        for o in payload.get("prior_observations", [])
        if not np.isnan(float(o["metric"]))
    ]


def load_tuned_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
