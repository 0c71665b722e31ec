"""GAME models: fixed-effect, random-effect, and the composite GameModel.

Counterpart of ``photon_ml_tpu/models/game.py``; reference photon-api
model/FixedEffectModel.scala, model/RandomEffectModel.scala and photon-lib
model/GameModel.scala (map CoordinateId -> DatumScoringModel, score = sum of
sub-scores, GameModel.scala:101-107; type consistency check :163-169).

A random-effect model is one dense [num_entities, dim] table, or for a very
wide shard a compact [num_entities, K] table over each entity's sorted active
columns (a random effect trained on a sparse shard, or a model loaded past
``io.model_io``'s size threshold). On a dense shard scoring is a gather and
a row-wise dot. On a sparse shard a compact model maps each COO entry to its
table slot once (:func:`compact_entry_positions`, host numpy; the device
copy is cached on the shard, :func:`compact_entries`) and scores by a gather-sum over the flattened ``[E, K+1]`` table: on
the card that is the gather kernel of ``ops/sparse_gather.py`` (G1) over the
row-sorted entries, whose sums are in a fixed order, so repeated scorings
are bitwise equal. Entities unseen at training time score 0.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from photon_ml_torch.data.batch import device_tensor
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.ops.sparse_gather import gather_sum, segment_plan
from photon_ml_torch.types import TaskType

#: launches of the gather's row or segment kernel made by compact scoring
#: (the change in ``sparse_gather.launches + segment_launches`` across its
#: gather; those counters include them, the chunk kernel's stay apart)
compact_launches = 0


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
            flat = features.device(means.device)
            return score_layout("sparse", {"w": means}, flat.arrays(), flat.num_samples)
        return score_layout("dense", {"w": means}, {"x": features}, features.shape[0])


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

    @property
    def is_compact(self) -> bool:
        return self.active_cols is not None

    def score_dataset(self, dataset) -> torch.Tensor:
        features = dataset.shard_features(self.feature_shard_id)
        if self.active_cols is not None and isinstance(features, SparseShard):
            entries = compact_entries(
                features, dataset.host_array(f"entity_idx/{self.random_effect_type}"),
                self.active_cols, self.coefficients.device)
            return entries.score(self.coefficients)
        if isinstance(features, SparseShard):
            raise ValueError(
                f"random-effect model '{self.random_effect_type}' holds a dense "
                f"[E, d] table but shard '{self.feature_shard_id}' is sparse: a random "
                "effect on a sparse shard is trained compact (load its model compact: "
                "compact_random_effect_threshold below the shard width)")
        arrays = {"x": features, "idx": dataset.entity_indices(self.random_effect_type)}
        if self.active_cols is not None:
            dim = int(self.feature_dim)
            if features.shape[1] != dim:
                raise ValueError(
                    f"compact random-effect model '{self.random_effect_type}' lives in a "
                    f"{dim}-column feature space but the dense shard "
                    f"'{self.feature_shard_id}' has {features.shape[1]} columns")
            active = torch.as_tensor(self.active_cols, dtype=torch.long, device=features.device)
            return score_layout("compact_dense", {"table": self.coefficients,
                                                  "active_cols": active}, arrays,
                                features.shape[0])
        return score_layout("re", {"table": self.coefficients}, arrays, features.shape[0])

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


def score_random_effect_compact_dense(table: torch.Tensor, active_cols: torch.Tensor,
                                      features: torch.Tensor,
                                      entity_idx: torch.Tensor) -> torch.Tensor:
    """A compact [E, K] table scored on a dense [n, d] shard: each sample's
    entity's active columns (``active_cols``, a long [E, K] tensor on the
    table's device, pad = d) gathered from its row, O(n K), no [E, d]
    table; 0 for unseen entities (idx < 0)."""
    dim = int(features.shape[1])
    idx = entity_idx.long()
    safe = torch.clamp(idx, min=0)
    cols = active_cols[safe]
    x = torch.gather(features.to(table.dtype), 1, torch.clamp(cols, max=dim - 1))
    scores = torch.sum(x * (cols < dim) * table[safe], dim=-1)
    return torch.where(idx >= 0, scores, torch.zeros_like(scores))


def match_active_positions(ent: np.ndarray, cols: np.ndarray, active_cols: np.ndarray,
                           dim: int) -> np.ndarray:
    """Position of each (entity, global column) query in the entity's sorted
    active-column list, or K (the scratch slot) when absent.

    (entity, col) encodes as entity·(dim+1)+col, globally non-decreasing
    over the flattened lists because each row of ``active_cols`` is sorted
    with pads == dim; a binary search finds each query. Pad queries (col >=
    dim) and negative entities resolve to K."""
    e, k = active_cols.shape
    dimp = int(dim) + 1
    ent = np.asarray(ent, dtype=np.int64)
    valid = (ent >= 0) & (np.asarray(cols) < dim)
    ent_safe = np.where(ent >= 0, ent, 0)
    keys = ent_safe * dimp + np.asarray(cols, dtype=np.int64)
    flat = ((np.arange(e, dtype=np.int64) * dimp)[:, None]
            + np.asarray(active_cols, dtype=np.int64)).ravel()
    idx = np.clip(np.searchsorted(flat, keys), 0, max(e * k - 1, 0))
    hit = (flat[idx] == keys) if e * k else np.zeros(len(keys), bool)
    return np.where(hit & valid, idx - ent_safe * k, k).astype(np.int32)


def compact_entry_positions(shard: SparseShard, entity_idx: np.ndarray,
                            active_cols: np.ndarray) -> tuple:
    """Each coalesced COO entry of ``shard`` mapped to its slot in its
    sample's entity's active-column list (host numpy).

    Returns (ent [nnz] int32, pos [nnz] int32, rows [nnz] int32, vals
    [nnz]), row-sorted: entry k of sample i with column j scores
    vals·table[ent, pos]; pos = K (the zero scratch slot) when j is not
    among the entity's active columns or the sample's entity is unseen
    (idx < 0), so such entries contribute 0. :func:`compact_entries` keeps
    their device copy."""
    rows_s, cols_s, vals_s = (np.asarray(a) for a in shard.coalesced())
    ent = np.asarray(entity_idx)[rows_s].astype(np.int64)
    pos = match_active_positions(ent, cols_s, active_cols, shard.feature_dim)
    return (np.where(ent >= 0, ent, 0).astype(np.int32), pos, rows_s.astype(np.int32),
            vals_s)


def _flat_slots(ent: torch.Tensor, pos: torch.Tensor, num_entities: int,
                width: int) -> torch.Tensor:
    """ent·(K+1)+pos as int32, the column ids of the gather over the
    flattened [E, K+1] table; the kernel takes int32 ids, so a table of
    2^31 slots or more raises."""
    if num_entities * (width + 1) >= 2**31:
        raise ValueError(
            f"compact table [{num_entities}, {width}+1] has 2^31 slots or more; the "
            "gather kernel takes int32 column ids")
    return (ent.long() * (width + 1) + pos.long()).to(torch.int32)


def score_random_effect_compact_reference(table: torch.Tensor, ent: torch.Tensor,
                                          pos: torch.Tensor, rows: torch.Tensor,
                                          vals: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`score_random_effect_compact`, on any
    device: a gather of each entry's slot and an ``index_add_`` over the
    row-sorted entries (in order on the CPU), in the promoted dtype of the
    values and the table."""
    dtype = torch.promote_types(vals.dtype, table.dtype)
    out = torch.zeros((n,), dtype=dtype, device=table.device)
    if table.shape[0] == 0 or ent.numel() == 0:
        return out
    table_ext = torch.cat([table, table.new_zeros((table.shape[0], 1))], dim=1).to(dtype)
    contrib = vals.to(dtype) * table_ext[ent.long(), pos.long()]
    return out.index_add_(0, rows.long(), contrib)


def score_random_effect_compact(table: torch.Tensor, ent: torch.Tensor, pos: torch.Tensor,
                                rows: torch.Tensor, vals: torch.Tensor, n: int,
                                plan: tuple | None = None,
                                table_ext: torch.Tensor | None = None) -> torch.Tensor:
    """Scores from a compact [E, K] table: Σ vals·table[ent, pos] over each
    row's entries, O(nnz), nothing of size d_re.

    A CPU table runs :func:`score_random_effect_compact_reference`. A CUDA
    table runs the gather kernel (f32 ``[n]`` out) over the row-sorted
    entries with the flat slot ent·(K+1)+pos as column ids and the
    flattened ``[E, K+1]`` table (its scratch column zero) as ``w``, or
    raises. ``plan`` = (flat slots, row_ptr, chunk plan), built here when
    None (:class:`CompactEntries` keeps it). ``table_ext``: that ``[E, K+1]``
    table where the caller keeps one (the resident scorer builds it when it
    places or swaps a model); built here when None."""
    global compact_launches
    if table.device.type == "cpu":
        return score_random_effect_compact_reference(table, ent, pos, rows, vals, n)
    e, k = table.shape
    if e == 0:
        return torch.zeros((n,), dtype=torch.float32, device=table.device)
    if plan is None:
        plan = (_flat_slots(ent, pos, e, k), *segment_plan(rows, n))
    flat, row_ptr, chunks = plan
    if table_ext is None:
        table_ext = torch.cat([table, table.new_zeros((e, 1))], dim=1)
    before = sparse_gather.launches + sparse_gather.segment_launches
    out = gather_sum(table_ext.reshape(-1), n, tail=(vals, flat, rows, row_ptr), chunks=chunks)
    compact_launches += sparse_gather.launches + sparse_gather.segment_launches - before
    return out


def score_layout(layout: str, params: dict, arrays: dict, n: int) -> torch.Tensor:
    """One coordinate's ``[n]`` scores (no offsets) in one scoring layout:
    the one per-layout program, which the sub-models' ``score_dataset`` and
    the resident serving program (``parallel/scoring.score_resident``) both
    run, so the same inputs score bitwise alike on either path.

    ``layout`` / ``params`` / ``arrays``:

    - "dense" FE: ``w`` / ``x`` [n, d];
    - "sparse" FE: ``w`` / the row-sorted flat entries ``vals``, ``cols``,
      ``rows``, their ``row_ptr`` and chunk plan ``chunks`` (or None);
    - "re": ``table`` [E, d] / ``x``, ``idx`` (entity index, -1 unseen);
    - "compact_dense": ``table`` [E, K], ``active_cols`` (long [E, K]) /
      ``x``, ``idx``;
    - "entries" (a compact effect on a sparse shard): ``table_ext`` [E, K+1]
      / the flat slots as ``cols``, ``rows``, ``vals``, ``row_ptr``,
      ``chunks``;
    - "mf": ``rows``, ``cols`` (the factors) / ``row_idx``, ``col_idx``."""
    if layout == "dense":
        w = params["w"]
        return arrays["x"].to(w.dtype) @ w
    if layout == "sparse":
        return gather_sum(params["w"], n, chunks=arrays["chunks"], tail=(
            arrays["vals"], arrays["cols"], arrays["rows"], arrays["row_ptr"]))
    if layout == "re":
        return score_random_effect(params["table"], arrays["x"], arrays["idx"])
    if layout == "compact_dense":
        return score_random_effect_compact_dense(params["table"], params["active_cols"],
                                                 arrays["x"], arrays["idx"])
    if layout == "entries":
        ext, slots = params["table_ext"], arrays["cols"]
        k1 = int(ext.shape[1])
        if ext.device.type == "cpu":
            slots = slots.long()
            return score_random_effect_compact(ext[:, :k1 - 1], slots // k1, slots % k1,
                                               arrays["rows"], arrays["vals"], n)
        return score_random_effect_compact(
            ext[:, :k1 - 1], None, None, arrays["rows"], arrays["vals"], n,
            plan=(slots, arrays["row_ptr"], arrays["chunks"]), table_ext=ext)
    if layout == "mf":
        from photon_ml_torch.models.matrix_factorization import score_matrix_factorization

        return score_matrix_factorization(params["rows"], params["cols"], arrays["row_idx"],
                                          arrays["col_idx"])
    raise ValueError(f"unknown scoring layout {layout!r}")


@dataclasses.dataclass
class CompactEntries:
    """One shard's entries mapped to compact table slots (the arrays of
    :func:`compact_entry_positions`) on one device, with the gather plan
    per table shape, so repeated scorings upload and plan nothing. It keeps
    the entity map and active columns it was built from (``key``), which
    :func:`compact_entries` matches."""

    key: tuple = dataclasses.field(repr=False)
    ent: torch.Tensor
    pos: torch.Tensor
    rows: torch.Tensor
    vals: torch.Tensor
    num_samples: int
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def plan(self, num_entities: int, width: int) -> tuple:
        """(flat slots, row_ptr, chunk plan) of the gather over an [E, K+1]
        table."""
        if (num_entities, width) not in self._plans:
            self._plans[(num_entities, width)] = (
                _flat_slots(self.ent, self.pos, num_entities, width),
                *segment_plan(self.rows, self.num_samples))
        return self._plans[(num_entities, width)]

    def score(self, table: torch.Tensor) -> torch.Tensor:
        """Scores from the compact ``[E, K]`` table (its ``[E, K+1]`` form
        built here, each call)."""
        slots, row_ptr, chunks = self.plan(*table.shape)
        table_ext = torch.cat([table, table.new_zeros((table.shape[0], 1))], dim=1)
        return score_layout("entries", {"table_ext": table_ext}, {
            "cols": slots, "rows": self.rows, "vals": self.vals, "row_ptr": row_ptr,
            "chunks": chunks}, self.num_samples)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a is b or (a.shape == b.shape and np.array_equal(a, b))


def compact_entries(shard: SparseShard, entity_idx: np.ndarray, active_cols: np.ndarray,
                    device) -> CompactEntries:
    """:func:`compact_entry_positions` on ``device``, cached on the shard
    (one copy per device, as ``SparseShard.device`` keeps its arrays, and
    per entity map and active columns: one shard can sit in datasets with
    different sample-to-entity mappings). A scoring with the arrays it was
    built from finds it by identity; equal copies (a reloaded model) by
    comparison."""
    device = torch.device(device)
    cache = shard.__dict__.setdefault("_compact_entries", [])
    for entries in cache:
        dev, idx, cols = entries.key
        if dev == device and _same(idx, entity_idx) and _same(cols, active_cols):
            return entries
    ent, pos, rows, vals = compact_entry_positions(shard, entity_idx, active_cols)
    entries = CompactEntries(
        key=(device, entity_idx, active_cols),
        ent=device_tensor(ent, torch.int32, device),
        pos=device_tensor(pos, torch.int32, device),
        rows=device_tensor(rows, torch.int32, device),
        vals=device_tensor(vals, shard.dtype, device),
        num_samples=int(shard.num_samples))
    cache.append(entries)
    return entries


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
