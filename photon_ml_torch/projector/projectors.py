"""Per-entity dimensionality reduction for random-effect training.

Counterpart of ``photon_ml_tpu/projector/projectors.py``; reference
photon-api projector/ (ProjectorType.scala, IndexMapProjectorRDD.scala:
218-257, ProjectionMatrixBroadcast, IdentityProjector).

- INDEX_MAP: each entity trains on its observed columns. The per-entity
  index map is a gather index baked into the entity bucket at build time
  (``data/game_data.py``), so the lane solves run on ``[e, cap, k]`` blocks,
  k the bucket's widest support, and scatter back into the full
  ``[num_entities, dim]`` table.
- RANDOM: one Gaussian ``[d, k]`` matrix shared by every entity; features
  are sketched as ``x @ P`` and solved coefficients back-projected as
  ``w = P w_k``.

Models always live in original space. The matrix is drawn on the host with
numpy exactly as the JAX package draws it, so both packages hold the same
matrix, bit for bit, for the same ``(d, k, seed)``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ProjectorType(enum.Enum):
    """Reference: projector/ProjectorType.scala."""

    IDENTITY = "IDENTITY"
    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"


@dataclasses.dataclass(frozen=True)
class RandomProjectionMatrix:
    """Gaussian projection shared across entities (reference
    ProjectionMatrixBroadcast). matrix: [d, k] float32, entries N(0, 1/d), so
    E[PᵀP] = I and the warm start Pᵀw approximates the previous projected
    solution without rescaling."""

    matrix: np.ndarray

    @classmethod
    def create(cls, dim: int, projected_dim: int, seed: int = 0) -> "RandomProjectionMatrix":
        if projected_dim >= dim:
            raise ValueError(
                f"random projection needs projected_dim < dim, got {projected_dim} >= {dim}")
        rng = np.random.default_rng(seed)
        m = rng.normal(scale=1.0 / np.sqrt(dim), size=(dim, projected_dim))
        return cls(matrix=m.astype(np.float32))

    @property
    def dim(self) -> int:
        return self.matrix.shape[0]

    @property
    def projected_dim(self) -> int:
        return self.matrix.shape[1]

    def project_features(self, features: np.ndarray) -> np.ndarray:
        return features @ self.matrix

    def back_project(self, coefficients: np.ndarray) -> np.ndarray:
        """[..., k] solved coefficients -> [..., d] original space."""
        return coefficients @ self.matrix.T


def entity_active_columns(features: np.ndarray) -> np.ndarray:
    """Columns with any nonzero value across an entity's samples: the
    entity's observed support (IndexMapProjectorRDD.scala:218-257); column 0
    when it has none."""
    cols = np.nonzero(np.any(features != 0, axis=0))[0]
    if cols.size == 0:
        cols = np.array([0], dtype=np.int64)
    return cols
