"""Matrix-factorization model: latent factors over two entity axes.

Counterpart of ``photon_ml_tpu/models/matrix_factorization.py``. The
reference declares this model family but never implements it: only the wire
format survives (photon-avro-schemas LatentFactorAvro.avsc: effectId +
latentFactor array). A sample scores ``dot(row_factor[rowId],
col_factor[colId])``; both tables are dense ``[num_entities, k]`` tensors,
and scoring is two gathers and a row-wise dot in plain torch (the JAX
package computes it in plain jnp, outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.models.game import DatumScoringModel
from photon_ml_torch.types import TaskType


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationModel(DatumScoringModel):
    """Latent-factor model over a (row entity, col entity) pair.

    row_factors: [num_row_entities, k]
    col_factors: [num_col_entities, k]
    row/col_keys: host-side vocabs, position == row index (as
    ``RandomEffectModel.entity_keys``).
    """

    row_factors: torch.Tensor
    col_factors: torch.Tensor
    row_effect_type: str
    col_effect_type: str
    row_keys: np.ndarray
    col_keys: np.ndarray
    task: TaskType

    @property
    def num_latent_factors(self) -> int:
        return int(self.row_factors.shape[1])

    def score_dataset(self, dataset) -> torch.Tensor:
        return score_matrix_factorization(
            self.row_factors, self.col_factors,
            dataset.entity_indices(self.row_effect_type),
            dataset.entity_indices(self.col_effect_type))

    def with_factors(self, row_factors: torch.Tensor,
                     col_factors: torch.Tensor) -> "MatrixFactorizationModel":
        return dataclasses.replace(self, row_factors=row_factors, col_factors=col_factors)


def score_matrix_factorization(row_factors: torch.Tensor, col_factors: torch.Tensor,
                               row_idx: torch.Tensor, col_idx: torch.Tensor) -> torch.Tensor:
    """scores_i = row_factors[row_idx_i] . col_factors[col_idx_i].

    Samples whose row OR col entity is unseen (idx < 0) score 0, as unseen
    entities of a random effect do; an empty table scores every sample 0.
    """
    if row_factors.shape[0] == 0 or col_factors.shape[0] == 0:
        return torch.zeros(row_idx.shape, dtype=row_factors.dtype, device=row_factors.device)
    r, c = row_idx.long(), col_idx.long()
    rows = row_factors[torch.clamp(r, min=0)]
    cols = col_factors[torch.clamp(c, min=0)]
    scores = torch.sum(rows * cols, dim=-1)
    return torch.where((r >= 0) & (c >= 0), scores, torch.zeros_like(scores))


def init_factors(num_rows: int, num_cols: int, num_latent: int, *, seed: int = 0,
                 scale: float | None = None, dtype: torch.dtype = torch.float32,
                 device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded small-random factors, N(0, 1)·scale with scale 1/sqrt(k).

    Zeros are a saddle point of the bilinear objective (each side's gradient
    is proportional to the other side's factors), so MF must start off zero.
    The draws come from a CPU ``torch.Generator`` seeded with ``seed``, so
    the factors are the same on every device; they differ from the JAX
    package's (its threefry stream), and parity runs carry the initial
    factors across instead. ``device`` follows the port's policy (CUDA
    unless "cpu").
    """
    device = resolve_device(device)
    if scale is None:
        scale = 1.0 / float(np.sqrt(num_latent))
    scale = float(scale)
    gen = torch.Generator().manual_seed(int(seed))
    row = torch.randn((num_rows, num_latent), generator=gen, dtype=torch.float64)
    col = torch.randn((num_cols, num_latent), generator=gen, dtype=torch.float64)
    return ((scale * row).to(dtype=dtype, device=device),
            (scale * col).to(dtype=dtype, device=device))
