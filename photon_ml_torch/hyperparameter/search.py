"""Random (Sobol) and Gaussian-process (Bayesian) hyperparameter search.

Reference parity: photon-lib hyperparameter/search/RandomSearch.scala:33-50
(Sobol candidate generation in the unit cube, evaluation loop with observed
and prior-observation seeding) and GaussianProcessSearch.scala (fit GP on
observations, pick the candidate maximizing expected improvement among a
fresh batch of Sobol draws, fall back to random until enough observations).

All search state lives in the unit cube [0,1]^d; VectorRescaling maps to and
from real hyperparameter ranges (log-scale λ grids etc.).

The port's own copy of ``photon_ml_tpu/hyperparameter/search.py`` (numpy and
scipy only), equal to it bit for bit under the same seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import numpy as np
from scipy.stats import qmc

from photon_ml_torch.hyperparameter.acquisition import expected_improvement
from photon_ml_torch.hyperparameter.estimators import GaussianProcessEstimator
from photon_ml_torch.hyperparameter.kernels import Kernel, Matern52


class EvaluationFunction(Protocol):
    """Maps a unit-cube candidate vector to an observed (to-minimize) value.

    Reference: photon-lib hyperparameter/EvaluationFunction.scala — the
    client glue (GameEstimatorEvaluationFunction) turns the vector into a
    full GAME training config, runs it, and returns the validation metric.
    """

    def __call__(self, candidate: np.ndarray) -> float: ...


@dataclasses.dataclass
class Observation:
    candidate: np.ndarray
    value: float


@dataclasses.dataclass
class SearchResult:
    best_candidate: np.ndarray
    best_value: float
    observations: list[Observation]


class RandomSearch:
    """Sobol-sequence random search (reference RandomSearch.scala:33-50).

    Seeded with a ``np.random.SeedSequence`` (the search_driver tournament
    path), ALL randomness threads from that one sequence: the Sobol scramble
    and the GP subclass's slice sampler draw from deterministic children of
    it (EI is pure), so a whole search trajectory replays bit-for-bit under
    a fixed seed — no ad-hoc seed arithmetic, no numpy global state
    (tests/test_lane_search.py pins the replay). An int seed keeps the
    historical derivation (Sobol seeded with the int, per-fit estimator
    seeds) so existing tuner trajectories are unchanged.
    """

    #: where the last propose_batch came from ("sobol" | "gp")
    last_proposal_source = "sobol"

    def __init__(self, dim: int, seed: "int | np.random.SeedSequence" = 0):
        self.dim = dim
        self.seed = seed
        if isinstance(seed, np.random.SeedSequence):
            sobol_child, model_child = seed.spawn(2)
            self._sobol = qmc.Sobol(
                d=dim, scramble=True, seed=np.random.default_rng(sobol_child)
            )
            #: one generator threaded through every surrogate-model fit
            self._model_rng = np.random.default_rng(model_child)
        else:
            self._sobol = qmc.Sobol(d=dim, scramble=True, seed=seed)
            self._model_rng = None
        self.observations: list[Observation] = []
        self.prior_observations: list[Observation] = []

    def draw_candidates(self, n: int) -> np.ndarray:
        return self._sobol.random(n)

    def propose_batch(self, n: int) -> np.ndarray:
        """The batch-ask API (search_driver tournaments): n fresh
        candidates; subclasses may rank a pool instead."""
        self.last_proposal_source = "sobol"
        return self.draw_candidates(n)

    def next_candidate(self) -> np.ndarray:
        return self.draw_candidates(1)[0]

    def observe(self, candidate: np.ndarray, value: float) -> None:
        self.observations.append(Observation(np.asarray(candidate, float), float(value)))

    def observe_prior(self, candidate: np.ndarray, value: float) -> None:
        """Seed the search with results from earlier runs (reference
        findWithPriors / observePrior)."""
        self.prior_observations.append(
            Observation(np.asarray(candidate, float), float(value))
        )

    def find(self, evaluation_function: EvaluationFunction, n: int) -> SearchResult:
        for _ in range(n):
            cand = self.next_candidate()
            self.observe(cand, evaluation_function(cand))
        return self._result()

    def _result(self) -> SearchResult:
        all_obs = self.observations + self.prior_observations
        if not all_obs:
            raise ValueError("no observations recorded")
        best = min(all_obs, key=lambda o: o.value)
        return SearchResult(
            best_candidate=best.candidate,
            best_value=best.value,
            observations=list(self.observations),
        )


class GaussianProcessSearch(RandomSearch):
    """Bayesian search: GP surrogate + expected improvement
    (reference GaussianProcessSearch.scala)."""

    def __init__(
        self,
        dim: int,
        seed: int = 0,
        *,
        kernel: Kernel | None = None,
        min_observations: int = 3,
        candidate_pool: int = 250,
        num_kernel_samples: int = 3,
        burn_in: int = 8,
    ):
        super().__init__(dim, seed)
        self.kernel = kernel or Matern52()
        self.min_observations = min_observations
        self.candidate_pool = candidate_pool
        self.num_kernel_samples = num_kernel_samples
        self.burn_in = burn_in

    def _fit_surrogate(self, all_obs: list[Observation]):
        x = np.stack([o.candidate for o in all_obs])
        y = np.array([o.value for o in all_obs])
        estimator = GaussianProcessEstimator(
            kernel=self.kernel,
            num_kernel_samples=self.num_kernel_samples,
            burn_in=self.burn_in,
            # SeedSequence-seeded searches thread ONE generator; int seeds
            # keep the historical per-fit derivation (tuner trajectories
            # must not move under existing seeds)
            seed=(self.seed + len(all_obs)
                  if self._model_rng is None else 0),
            rng=self._model_rng,
        )
        return estimator.fit(x, y), y

    def next_candidate(self) -> np.ndarray:
        all_obs = self.observations + self.prior_observations
        if len(all_obs) < self.min_observations:
            return super().next_candidate()
        model, y = self._fit_surrogate(all_obs)
        pool = self.draw_candidates(self.candidate_pool)
        mean, var = model.predict(pool)
        ei = expected_improvement(mean, var, best_value=float(y.min()))
        return pool[int(np.argmax(ei))]

    def propose_batch(self, n: int) -> np.ndarray:
        """One GP fit, one EI ranking of a fresh Sobol pool, top-n distinct
        candidates — the tournament-round ask (search_driver.py). Falls
        back to Sobol until min_observations are told back."""
        all_obs = self.observations + self.prior_observations
        if len(all_obs) < self.min_observations:
            self.last_proposal_source = "sobol"
            return self.draw_candidates(n)
        model, y = self._fit_surrogate(all_obs)
        pool = self.draw_candidates(max(self.candidate_pool, n))
        mean, var = model.predict(pool)
        ei = expected_improvement(mean, var, best_value=float(y.min()))
        self.last_proposal_source = "gp"
        order = np.argsort(-ei)
        return pool[order[:n]]
