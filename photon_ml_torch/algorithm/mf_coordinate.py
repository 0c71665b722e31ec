"""Matrix-factorization coordinate: alternating lane-batched latent-factor solves.

Counterpart of ``photon_ml_tpu/algorithm/mf_coordinate.py``. The reference
promises an MF coordinate (README.md:92-95, LatentFactorAvro.avsc) but never
implemented it; this is the JAX package's design on the port's lanes.

Training is alternating minimization. With the column factors held fixed,
the objective restricted to one row entity is an ordinary GLM over its
samples whose "feature vector" for sample i is ``col_factors[col_idx_i]``:
the local problem of a random-effect entity. So each half-step gathers the
fixed side's factors as ``[e, cap, k]`` features per size bucket, solves
every entity of the bucket in one lane-batched solve
(``coordinates._solve_bucket_entities``) and scatters the results back into
the ``[E, k]`` table. All of it is plain torch: the JAX package's half-step
is plain jnp too, with no Pallas kernel behind it.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import (
    Coordinate,
    CoordinateOptimizationConfig,
    _bucket_offsets,
    _gather_rows,
    _scatter_rows,
    _solve_bucket_entities,
    _solve_config,
)
from photon_ml_torch.data.batch import device_tensor
from photon_ml_torch.data.game_data import (
    GameDataset,
    group_entities_into_buckets,
    pack_bucket_lanes,
)
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel, init_factors
from photon_ml_torch.ops.losses import loss_for_task
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.common import LaneTrace, LaneTraces
from photon_ml_torch.optim.optimizer import OptimizerConfig
from photon_ml_torch.telemetry.program_ledger import ledger_call
from photon_ml_torch.types import TaskType


@dataclasses.dataclass
class MFSideBucket:
    """One size bucket of per-entity sample groups for one MF side.

    There is no feature block: the features are the other side's factor
    rows, gathered at solve time (they change every half-step).

    labels/weights: [e, cap] (weight 0 marks padding)
    entity_rows:    [e]      row in this side's entity vocab
    sample_rows:    [e, cap] global sample row per slot, -1 pad
    """

    labels: torch.Tensor
    weights: torch.Tensor
    entity_rows: torch.Tensor
    sample_rows: torch.Tensor

    @property
    def num_entities(self) -> int:
        return int(self.entity_rows.shape[0])


@dataclasses.dataclass
class MFDataset:
    """Bucketed per-entity views of both MF sides."""

    row_effect_type: str
    col_effect_type: str
    row_buckets: list[MFSideBucket]
    col_buckets: list[MFSideBucket]
    num_row_entities: int
    num_col_entities: int

    def trained_masks(self) -> tuple[np.ndarray, np.ndarray]:
        """Boolean [R] / [C] masks of the entities in any bucket. Vocab
        members with no usable sample are never trained and score 0, as
        unseen random-effect entities do."""
        row = np.zeros(self.num_row_entities, dtype=bool)
        for b in self.row_buckets:
            row[b.entity_rows.cpu().numpy()] = True
        col = np.zeros(self.num_col_entities, dtype=bool)
        for b in self.col_buckets:
            col[b.entity_rows.cpu().numpy()] = True
        return row, col


def _build_side_buckets(entity_idx: np.ndarray, other_idx: np.ndarray, labels: np.ndarray,
                        weights: np.ndarray, unique_ids: np.ndarray, *, bucket_sizes,
                        active_data_upper_bound: int | None, seed: int,
                        device) -> list[MFSideBucket]:
    """Group samples by this side's entity (the random effects' bucketing,
    reservoir caps keyed on stable sample ids). A sample whose other-side
    entity is unseen has no factor to contribute, so it is excluded before
    grouping: it must not crowd usable samples out of the reservoir cap."""
    effective_idx = np.where(other_idx >= 0, entity_idx, -1)
    per_bucket = group_entities_into_buckets(
        effective_idx, unique_ids, bucket_sizes=bucket_sizes,
        active_data_upper_bound=active_data_upper_bound, seed=seed)
    buckets: list[MFSideBucket] = []
    for cap, members in per_bucket.items():
        if not members:
            continue
        e = len(members)
        be, rows_concat, lane, slot = pack_bucket_lanes(members)
        bl = np.zeros((e, cap), dtype=labels.dtype)
        bw = np.zeros((e, cap), dtype=weights.dtype)
        bs = np.full((e, cap), -1, dtype=np.int32)
        bl[lane, slot] = labels[rows_concat]
        bw[lane, slot] = weights[rows_concat] * (other_idx[rows_concat] >= 0)
        bs[lane, slot] = rows_concat
        buckets.append(MFSideBucket(labels=device_tensor(bl, None, device),
                                    weights=device_tensor(bw, None, device),
                                    entity_rows=device_tensor(be, torch.int32, device),
                                    sample_rows=device_tensor(bs, torch.int32, device)))
    return buckets


def build_mf_dataset(dataset: GameDataset, row_effect_type: str, col_effect_type: str, *,
                     bucket_sizes=(8, 32, 128, 512, 2048),
                     active_data_upper_bound: int | None = None, seed: int = 0) -> MFDataset:
    """Both sides' buckets, on the dataset's device (host numpy, built once)."""
    labels = dataset.host_array("labels")
    weights = dataset.host_array("weights")
    unique_ids = np.asarray(dataset.unique_ids)
    row_idx = dataset.host_array(f"entity_idx/{row_effect_type}")
    col_idx = dataset.host_array(f"entity_idx/{col_effect_type}")
    kw = dict(bucket_sizes=bucket_sizes, active_data_upper_bound=active_data_upper_bound,
              seed=seed, device=dataset.device)
    return MFDataset(
        row_effect_type=row_effect_type, col_effect_type=col_effect_type,
        row_buckets=_build_side_buckets(row_idx, col_idx, labels, weights, unique_ids, **kw),
        col_buckets=_build_side_buckets(col_idx, row_idx, labels, weights, unique_ids, **kw),
        num_row_entities=len(dataset.entity_vocabs[row_effect_type]),
        num_col_entities=len(dataset.entity_vocabs[col_effect_type]))


@partial(ledger_call, label="coord/mf_side_solve", static_argnums=(0, 1))
def solve_mf_side_bucket(objective: GLMObjective, opt: OptimizerConfig, labels: torch.Tensor,
                         weights: torch.Tensor, entity_rows: torch.Tensor,
                         sample_rows: torch.Tensor, other_idx_full: torch.Tensor,
                         other_factors: torch.Tensor, full_offsets: torch.Tensor,
                         table: torch.Tensor) -> tuple[torch.Tensor, LaneTrace]:
    """One alternating half-step over one bucket: gather the fixed side's
    factors as ``[e, cap, k]`` features (pad slots and unseen other-side
    entities zero), solve every entity's lane, scatter the solved rows into
    a copy of ``table``. Returns it with the per-lane trace. The entity rows
    of a bucket are distinct, so the scatter is deterministic."""
    safe_rows = torch.clamp(sample_rows.long(), min=0)
    oidx = other_idx_full.long()[safe_rows]                        # [e, cap]
    feats = other_factors[torch.clamp(oidx, min=0)]                # [e, cap, k]
    drop = (sample_rows < 0) | (oidx < 0)
    feats = torch.where(drop.unsqueeze(-1), torch.zeros_like(feats), feats)
    offsets = _bucket_offsets(sample_rows, full_offsets)
    solved, trace = _solve_bucket_entities(objective, opt, feats, labels, weights, offsets,
                                           _gather_rows(table, entity_rows))
    return _scatter_rows(table, entity_rows, solved), trace


@dataclasses.dataclass
class MatrixFactorizationCoordinate(Coordinate):
    """Trains (row_factors, col_factors) on the residual offsets.

    ``num_alternations`` row/col passes per coordinate update; the outer
    coordinate-descent loop supplies further alternations, so small values
    (1-2) suffice.
    """

    coordinate_id: str
    dataset: GameDataset
    mf_dataset: MFDataset
    task: TaskType
    config: CoordinateOptimizationConfig
    num_latent_factors: int
    num_alternations: int = 2
    seed: int = 0

    def initial_model(self) -> MatrixFactorizationModel:
        mf = self.mf_dataset
        row, col = init_factors(mf.num_row_entities, mf.num_col_entities,
                                self.num_latent_factors, seed=self.seed,
                                dtype=self.dataset.labels.dtype, device=self.dataset.device)
        # vocab entities with no training sample are never solved: they keep
        # zero factors, so no random init leaks into their scores
        row_mask, col_mask = (torch.from_numpy(m).to(row.device).unsqueeze(1)
                              for m in mf.trained_masks())
        return MatrixFactorizationModel(
            row_factors=torch.where(row_mask, row, torch.zeros_like(row)),
            col_factors=torch.where(col_mask, col, torch.zeros_like(col)),
            row_effect_type=mf.row_effect_type, col_effect_type=mf.col_effect_type,
            row_keys=self.dataset.entity_vocabs[mf.row_effect_type],
            col_keys=self.dataset.entity_vocabs[mf.col_effect_type], task=self.task)

    def update_model(self, model: MatrixFactorizationModel,
                     extra_offsets: torch.Tensor | None = None):
        if self.config.l1_weight > 0.0:
            raise ValueError(
                "L1 regularization is not supported on latent factors "
                "(use l2_weight; the reference's MF design is L2-only)"
            )
        objective = GLMObjective(loss_for_task(self.task), l2_weight=self.config.l2_weight,
                                 use_kernel=False)
        # the alternating factor solves are small dense lane problems: AUTO
        # resolves to the batched Newton lanes
        opt = _solve_config(self.config, loss=objective.loss, small_dense=True)
        full_offsets = self.dataset.offsets
        if extra_offsets is not None:
            full_offsets = full_offsets + extra_offsets
        mf = self.mf_dataset
        row_idx = self.dataset.entity_idx[mf.row_effect_type]
        col_idx = self.dataset.entity_idx[mf.col_effect_type]
        rows, cols = model.row_factors, model.col_factors
        traces: list[LaneTrace] = []
        for _ in range(self.num_alternations):
            for b in mf.row_buckets:
                rows, trace = solve_mf_side_bucket(objective, opt, b.labels, b.weights,
                                                   b.entity_rows, b.sample_rows, col_idx, cols,
                                                   full_offsets, rows)
                traces.append(trace)
            for b in mf.col_buckets:
                cols, trace = solve_mf_side_bucket(objective, opt, b.labels, b.weights,
                                                   b.entity_rows, b.sample_rows, row_idx, rows,
                                                   full_offsets, cols)
                traces.append(trace)
        return model.with_factors(rows, cols), (LaneTraces(traces) if traces else None)

    def score(self, model: MatrixFactorizationModel) -> torch.Tensor:
        return model.score_dataset(self.dataset)
