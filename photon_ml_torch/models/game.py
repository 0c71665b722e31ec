"""GAME models: fixed-effect, random-effect, and the composite GameModel.

Counterpart of ``photon_ml_tpu/models/game.py``; reference photon-api
model/FixedEffectModel.scala, model/RandomEffectModel.scala and photon-lib
model/GameModel.scala (map CoordinateId -> DatumScoringModel, score = sum of
sub-scores, GameModel.scala:101-107; type consistency check :163-169).

A random-effect model is one dense [num_entities, dim] table, or for a very
wide shard a compact [num_entities, K] table over each entity's sorted active
columns (a model loaded past ``io.model_io``'s size threshold); scoring is a
gather and a row-wise dot. Entities unseen at training time score 0.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType


class DatumScoringModel:
    """Anything that can score a GameDataset (reference DatumScoringModel)."""

    task: TaskType

    def score_dataset(self, dataset) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedEffectModel(DatumScoringModel):
    """A single GLM applied to one feature shard."""

    glm: GeneralizedLinearModel
    feature_shard_id: str

    @property
    def task(self) -> TaskType:
        return self.glm.task

    def score_dataset(self, dataset) -> torch.Tensor:
        features = dataset.shard_features(self.feature_shard_id)
        means = self.glm.coefficients.means
        if isinstance(features, SparseShard):
            return features.device(means.device).matvec(means)
        return features.to(means.dtype) @ means


@dataclasses.dataclass(frozen=True)
class RandomEffectModel(DatumScoringModel):
    """Per-entity coefficient table for one random-effect type.

    coefficients: [num_entities, dim]; entity i's GLM lives in row i.
    variances: optional [num_entities, dim].
    entity_keys: host-side vocab, position == row index.
    """

    coefficients: torch.Tensor
    entity_keys: np.ndarray
    random_effect_type: str
    feature_shard_id: str
    task: TaskType
    variances: torch.Tensor | None = None
    #: compact mode: coefficients are [E, K] over each entity's sorted active
    #: global columns (active_cols [E, K] int32 on the host, pad =
    #: feature_dim, the true shard width)
    active_cols: np.ndarray | None = None
    feature_dim: int | None = None

    @property
    def num_entities(self) -> int:
        return self.coefficients.shape[0]

    @property
    def dim(self) -> int:
        if self.active_cols is not None:
            return int(self.feature_dim)
        return self.coefficients.shape[1]

    def score_dataset(self, dataset) -> torch.Tensor:
        features = dataset.shard_features(self.feature_shard_id)
        if isinstance(features, SparseShard):
            raise NotImplementedError(
                "scoring a random effect on a sparse shard needs the compact "
                "per-entity tables (ROADMAP.md item 14)"
            )
        entity_idx = dataset.entity_indices(self.random_effect_type)
        if self.active_cols is not None:
            return self._score_compact(features, entity_idx)
        return score_random_effect(self.coefficients, features, entity_idx)

    def _score_compact(self, features: torch.Tensor, entity_idx: torch.Tensor) -> torch.Tensor:
        """Each sample's entity's active columns gathered from the dense
        shard: O(n K), no [E, d] table."""
        dim = int(self.feature_dim)
        if features.shape[1] != dim:
            raise ValueError(
                f"compact random-effect model '{self.random_effect_type}' lives in a "
                f"{dim}-column feature space but the dense shard '{self.feature_shard_id}' "
                f"has {features.shape[1]} columns")
        idx = entity_idx.long()
        safe = torch.clamp(idx, min=0)
        cols = torch.as_tensor(self.active_cols, dtype=torch.long, device=features.device)[safe]
        x = torch.gather(features.to(self.coefficients.dtype), 1, torch.clamp(cols, max=dim - 1))
        scores = torch.sum(x * (cols < dim) * self.coefficients[safe], dim=-1)
        return torch.where(idx >= 0, scores, torch.zeros_like(scores))

    def with_coefficients(self, coefficients: torch.Tensor) -> "RandomEffectModel":
        """New table, dropping any variances (they were computed at the old
        coefficients)."""
        return dataclasses.replace(self, coefficients=coefficients, variances=None)


def score_random_effect(table: torch.Tensor, features: torch.Tensor,
                        entity_idx: torch.Tensor) -> torch.Tensor:
    """scores_i = x_i . table[entity_idx_i], 0 for unseen entities (idx < 0)."""
    if table.shape[0] == 0:
        return torch.zeros(entity_idx.shape, dtype=table.dtype, device=features.device)
    idx = entity_idx.long()
    rows = table[torch.clamp(idx, min=0)]
    scores = torch.sum(features.to(table.dtype) * rows, dim=-1)
    return torch.where(idx >= 0, scores, torch.zeros_like(scores))


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Ordered map coordinate-id -> sub-model; score = sum of sub-scores."""

    models: Mapping[str, DatumScoringModel]

    def __post_init__(self):
        tasks = {m.task for m in self.models.values() if m.task != TaskType.NONE}
        if len(tasks) > 1:
            raise ValueError(f"Inconsistent task types across coordinates: {tasks}")

    @property
    def task(self) -> TaskType:
        for m in self.models.values():
            if m.task != TaskType.NONE:
                return m.task
        return TaskType.NONE

    def get(self, coordinate_id: str) -> DatumScoringModel:
        return self.models[coordinate_id]

    def score_dataset(self, dataset) -> torch.Tensor:
        total = None
        for model in self.models.values():
            s = model.score_dataset(dataset)
            total = s if total is None else total + s
        if total is None:
            raise ValueError("GameModel has no sub-models")
        return total

    def score(self, dataset) -> torch.Tensor:
        """Alias of :meth:`score_dataset`."""
        return self.score_dataset(dataset)

    def updated(self, coordinate_id: str, model: DatumScoringModel) -> "GameModel":
        new = dict(self.models)
        new[coordinate_id] = model
        return GameModel(models=new)
