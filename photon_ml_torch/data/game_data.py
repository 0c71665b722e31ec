"""GAME dataset: column-oriented GameDatum collection and the bucketed
per-entity training view.

Counterpart of ``photon_ml_tpu/data/game_data.py``; reference photon-api
data/GameDatum.scala, data/FixedEffectDataSet.scala,
data/RandomEffectDataSet.scala (grouping per entity with reservoir caps and
lower bounds).

- One feature block per feature shard (a dense [n, d_shard] tensor, or a
  ``SparseShard`` for a shard too wide to densify), [n]
  labels/offsets/weights, and per random-effect type an [n] entity index.
- Random-effect training data is size-bucketed padded blocks: entities
  bucketed by sample count, each bucket an [entities, cap, d] tensor that
  the lane-batched solvers consume. A projector (``projector/projectors.py``)
  narrows d: INDEX_MAP to each bucket's widest per-entity support (with the
  per-entity column index beside the block), RANDOM to the sketch width; a
  per-entity Pearson filter (``features_to_samples_ratio``) zeroes the
  columns an entity does not keep. On a sparse shard the view is compact:
  each entity's block covers its active columns, gathered from the COO
  entries without ever forming [E, d].
- Scoring always runs over the full sample axis through an entity-indexed
  gather (models/game.py), so samples left out of training (reservoir cap,
  lower bound) are still scored.

The host builders are vectorized numpy and give arrays equal to the JAX
package's, element for element; only the finished arrays move to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch, device_tensor
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch, SparseShard
from photon_ml_torch.device import resolve_device
from photon_ml_torch.ops.normalization import host_factors, host_shifts
from photon_ml_torch.projector.projectors import ProjectorType, RandomProjectionMatrix
from photon_ml_torch.sampling.down_sampler import stable_uniform

_NUMPY_TO_TORCH = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


@dataclasses.dataclass
class GameDataset:
    """Column-oriented GAME data: built once on the host, then resident on
    ``device``.

    feature_shards: shard id -> [n, d_shard] tensor, or a SparseShard
    entity_idx:     RE type -> [n] int32 tensor (row in that type's entity
                    vocab, -1 for entities absent from the vocab)
    entity_vocabs:  RE type -> [num_entities] key array (host)
    ids:            evaluation id columns (e.g. queryId) -> [n] host array
    """

    unique_ids: np.ndarray
    labels: torch.Tensor
    offsets: torch.Tensor
    weights: torch.Tensor
    feature_shards: dict
    entity_idx: dict
    entity_vocabs: dict
    ids: dict = dataclasses.field(default_factory=dict)
    #: host copies kept by build_game_dataset so bucketing never pulls
    #: device tensors back
    host_cache: dict = dataclasses.field(default_factory=dict, compare=False)
    #: per sparse shard, its training batch built once (the layout does not
    #: depend on the offsets)
    _sparse_batches: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def host_array(self, name: str) -> np.ndarray:
        """Host copy of a namespaced array: 'labels'/'weights'/'offsets',
        'shard/<shard_id>', or 'entity_idx/<re_type>'."""
        if name in self.host_cache:
            return self.host_cache[name]
        if name in ("labels", "weights", "offsets"):
            value = getattr(self, name).cpu().numpy()
        elif name.startswith("shard/"):
            shard = self.feature_shards[name[len("shard/"):]]
            if isinstance(shard, SparseShard):
                raise TypeError(
                    f"feature shard '{name[len('shard/'):]}' is sparse "
                    "(giant-d); dense host materialization would defeat it. "
                    "Random-effect coordinates and other dense consumers "
                    "need a dense shard."
                )
            value = shard.float().cpu().numpy() if shard.dtype == torch.bfloat16 \
                else shard.cpu().numpy()
        elif name.startswith("entity_idx/"):
            value = self.entity_idx[name[len("entity_idx/"):]].cpu().numpy()
        else:
            raise KeyError(name)
        self.host_cache[name] = value
        return value

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def shard_features(self, shard_id: str):
        return self.feature_shards[shard_id]

    def entity_indices(self, re_type: str) -> torch.Tensor:
        return self.entity_idx[re_type]

    def fixed_effect_batch(
        self, shard_id: str, extra_offsets: torch.Tensor | None = None
    ) -> LabeledPointBatch | SparseLabeledPointBatch:
        offsets = self.offsets if extra_offsets is None else self.offsets + extra_offsets
        shard = self.feature_shards[shard_id]
        if isinstance(shard, SparseShard):
            base = self._sparse_batches.get(shard_id)
            if base is None:
                base = self._sparse_batches[shard_id] = SparseLabeledPointBatch.from_shard(
                    shard, self.labels, self.offsets, self.weights, device=self.device)
            return base.with_offsets(offsets.to(base.offsets.dtype))
        return LabeledPointBatch(features=shard, labels=self.labels, offsets=offsets,
                                 weights=self.weights)


def pad_game_dataset(dataset: GameDataset, multiple: int) -> tuple[GameDataset, int]:
    """Pad the sample axis with zero-weight rows to a multiple of ``multiple``.

    Padding rows carry weight 0, entity index -1 (scored as 0), offset and
    label 0, zero feature rows and fresh negative unique ids. Sparse shards
    pad by raising ``num_samples``. Entity buckets built from the unpadded
    dataset stay valid. Returns (padded dataset, original sample count); the
    dataset itself when already divisible.
    """
    n = dataset.num_samples
    return _pad_game_dataset_rows(dataset, (-n) % max(1, int(multiple))), n


def pad_game_dataset_to(dataset: GameDataset, length: int) -> tuple[GameDataset, int]:
    """Pad the sample axis with zero-weight rows to exactly ``length`` rows
    (the padding contract of :func:`pad_game_dataset`). Returns (padded
    dataset, original sample count)."""
    n = dataset.num_samples
    if length < n:
        raise ValueError(f"cannot pad a {n}-row dataset down to {length} rows")
    return _pad_game_dataset_rows(dataset, length - n), n


def _pad_game_dataset_rows(dataset: GameDataset, pad: int) -> GameDataset:
    if pad == 0:
        return dataset
    device = dataset.device

    def padded_vec(name: str):
        arr = dataset.host_array(name)
        out = np.concatenate([arr, np.zeros(pad, dtype=arr.dtype)])
        return out, device_tensor(out, None, device)

    labels_h, labels_d = padded_vec("labels")
    offsets_h, offsets_d = padded_vec("offsets")
    weights_h, weights_d = padded_vec("weights")
    shards: dict = {}
    host_cache = {"labels": labels_h, "offsets": offsets_h, "weights": weights_h}
    for k, v in dataset.feature_shards.items():
        if isinstance(v, SparseShard):
            # the coalesced triple survives; the device arrays and the hybrid
            # split hold the old sample count
            shards[k] = dataclasses.replace(v, num_samples=v.num_samples + pad, _device={},
                                            _hybrid_cache=None)
        else:
            arr = dataset.host_array(f"shard/{k}")
            arr = np.concatenate([arr, np.zeros((pad, arr.shape[1]), dtype=arr.dtype)])
            shards[k] = device_tensor(arr, v.dtype, device)
            host_cache[f"shard/{k}"] = arr
    entity_idx: dict = {}
    for t in dataset.entity_idx:
        arr = np.concatenate(
            [dataset.host_array(f"entity_idx/{t}"), np.full(pad, -1, dtype=np.int32)]
        ).astype(np.int32)
        entity_idx[t] = device_tensor(arr, torch.int32, device)
        host_cache[f"entity_idx/{t}"] = arr
    ids = {
        k: np.concatenate([np.asarray(v), np.zeros(pad, np.asarray(v).dtype)])
        for k, v in dataset.ids.items()
    }
    unique_ids = np.concatenate(
        [np.asarray(dataset.unique_ids),
         -(np.arange(pad, dtype=np.int64) + 1 + np.abs(dataset.unique_ids).max(initial=0))]
    )
    return GameDataset(
        unique_ids=unique_ids, labels=labels_d, offsets=offsets_d, weights=weights_d,
        feature_shards=shards, entity_idx=entity_idx, entity_vocabs=dataset.entity_vocabs,
        ids=ids, host_cache=host_cache,
    )


def slice_game_dataset(dataset: GameDataset, lo: int, hi: int) -> GameDataset:
    """The rows ``[lo, hi)`` of a dataset as a new dataset on its device,
    built from its host arrays (entity vocabularies shared, not copied).
    Sparse shards slice their coalesced triples by a ``searchsorted`` range
    (they are row-sorted), rows shifted to the slice's origin. The serving
    layer splits replay data into requests, and an oversized request across
    micro-batches, with it."""
    n = dataset.num_samples
    if not (0 <= lo < hi <= n):
        raise ValueError(f"slice [{lo}, {hi}) out of range for {n} samples")
    device = dataset.device
    host_cache = {name: dataset.host_array(name)[lo:hi]
                  for name in ("labels", "offsets", "weights")}
    shards: dict = {}
    for k, v in dataset.feature_shards.items():
        if isinstance(v, SparseShard):
            rows, cols, vals = (np.asarray(a) for a in v.coalesced())
            a, b = np.searchsorted(rows, [lo, hi])
            part = ((rows[a:b] - lo).astype(rows.dtype), np.array(cols[a:b]),
                    np.array(vals[a:b]))
            # a row range of a coalesced triple is coalesced
            shards[k] = dataclasses.replace(
                v, rows=part[0], cols=part[1], vals=part[2], num_samples=hi - lo, _device={},
                _coalesced=part, _hybrid_cache=None)
        else:
            arr = host_cache[f"shard/{k}"] = dataset.host_array(f"shard/{k}")[lo:hi]
            shards[k] = device_tensor(arr, v.dtype, device)
    for t in dataset.entity_idx:
        host_cache[f"entity_idx/{t}"] = dataset.host_array(f"entity_idx/{t}")[lo:hi]
    return GameDataset(
        unique_ids=np.asarray(dataset.unique_ids)[lo:hi],
        labels=device_tensor(host_cache["labels"], None, device),
        offsets=device_tensor(host_cache["offsets"], None, device),
        weights=device_tensor(host_cache["weights"], None, device),
        feature_shards=shards,
        entity_idx={t: device_tensor(host_cache[f"entity_idx/{t}"], torch.int32, device)
                    for t in dataset.entity_idx},
        entity_vocabs=dataset.entity_vocabs,
        ids={k: np.asarray(v)[lo:hi] for k, v in dataset.ids.items()}, host_cache=host_cache)


def concat_game_datasets(datasets: Sequence[GameDataset]) -> GameDataset:
    """Row-wise concatenation of datasets built against the same schema,
    on the first one's device: shard ids and widths, entity types and
    vocabularies, and id columns must agree (a vocabulary mismatch would
    misalign one part's entity rows, so it is checked). Sparse shards
    concatenate their coalesced triples with rows shifted into the merged
    sample axis, so the result stays row-sorted. The serving micro-batcher
    merges queued requests into one micro-batch with it."""
    datasets = list(datasets)
    if not datasets:
        raise ValueError("concat_game_datasets needs at least one dataset")
    if len(datasets) == 1:
        return datasets[0]
    base = datasets[0]
    for d in datasets[1:]:
        for attr in ("feature_shards", "entity_idx", "ids"):
            if set(getattr(d, attr)) != set(getattr(base, attr)):
                raise ValueError(
                    f"datasets disagree on {attr} keys: "
                    f"{sorted(getattr(base, attr))} vs "
                    f"{sorted(getattr(d, attr))}"
                )
        for t, vocab in base.entity_vocabs.items():
            other = d.entity_vocabs.get(t)
            if other is not vocab and not np.array_equal(np.asarray(other), np.asarray(vocab)):
                raise ValueError(
                    f"datasets disagree on the '{t}' entity vocab "
                    f"({len(np.asarray(vocab))} vs "
                    f"{0 if other is None else len(np.asarray(other))} keys)"
                )
    device = base.device

    def cat(name: str) -> np.ndarray:
        return np.concatenate([d.host_array(name) for d in datasets])

    host_cache = {name: cat(name) for name in ("labels", "offsets", "weights")}
    starts = np.cumsum([0] + [d.num_samples for d in datasets])
    shards: dict = {}
    for k, v in base.feature_shards.items():
        if isinstance(v, SparseShard):
            rows_parts, cols_parts, vals_parts = [], [], []
            for d, start in zip(datasets, starts):
                shard = d.feature_shards[k]
                if not isinstance(shard, SparseShard):
                    raise ValueError(f"shard '{k}' is sparse in one dataset and dense in another")
                if shard.feature_dim != v.feature_dim:
                    raise ValueError(f"shard '{k}' feature_dim mismatch: "
                                     f"{v.feature_dim} vs {shard.feature_dim}")
                r, c, vv = shard.coalesced()
                rows_parts.append(np.asarray(r, np.int64) + int(start))
                cols_parts.append(np.asarray(c))
                vals_parts.append(np.asarray(vv))
            merged = (np.concatenate(rows_parts), np.concatenate(cols_parts),
                      np.concatenate(vals_parts))
            # coalesced parts over disjoint, ascending row ranges
            shards[k] = dataclasses.replace(
                v, rows=merged[0], cols=merged[1], vals=merged[2], num_samples=int(starts[-1]),
                _device={}, _coalesced=merged, _hybrid_cache=None)
        else:
            arr = host_cache[f"shard/{k}"] = cat(f"shard/{k}")
            shards[k] = device_tensor(arr, v.dtype, device)
    for t in base.entity_idx:
        host_cache[f"entity_idx/{t}"] = cat(f"entity_idx/{t}")
    return GameDataset(
        unique_ids=np.concatenate([np.asarray(d.unique_ids) for d in datasets]),
        labels=device_tensor(host_cache["labels"], None, device),
        offsets=device_tensor(host_cache["offsets"], None, device),
        weights=device_tensor(host_cache["weights"], None, device),
        feature_shards=shards,
        entity_idx={t: device_tensor(host_cache[f"entity_idx/{t}"], torch.int32, device)
                    for t in base.entity_idx},
        entity_vocabs=base.entity_vocabs,
        ids={k: np.concatenate([np.asarray(d.ids[k]) for d in datasets]) for k in base.ids},
        host_cache=host_cache)


def sparse_shard_rows(shard: SparseShard, rows: slice) -> SparseShard:
    """The entries of rows ``[rows.start, rows.stop)`` of a sparse shard, as
    a shard of those rows (its layout policy kept)."""
    r, c, v = (np.asarray(a) for a in shard.coalesced())
    lo, hi = np.searchsorted(r, [rows.start, rows.stop])
    return SparseShard(rows=r[lo:hi] - rows.start, cols=c[lo:hi], vals=v[lo:hi],
                       num_samples=rows.stop - rows.start, feature_dim=shard.feature_dim,
                       hybrid_policy=shard.hybrid_policy, ell_width=shard.ell_width)


def game_dataset_rows(dataset: GameDataset, rows: slice, device=None) -> GameDataset:
    """The rows ``[rows.start, rows.stop)`` of a dataset, on ``device``
    (the dataset's by default): a rank's block of the sample axis. Entity
    vocabularies stay whole, so entity indices keep their meaning."""
    device = dataset.device if device is None else torch.device(device)

    def take(t: torch.Tensor) -> torch.Tensor:
        return t[rows].to(device).contiguous()

    host_cache = {k: v[rows] for k, v in dataset.host_cache.items()}
    shards = {k: sparse_shard_rows(v, rows) if isinstance(v, SparseShard) else take(v)
              for k, v in dataset.feature_shards.items()}
    return GameDataset(
        unique_ids=np.asarray(dataset.unique_ids)[rows], labels=take(dataset.labels),
        offsets=take(dataset.offsets), weights=take(dataset.weights), feature_shards=shards,
        entity_idx={k: take(v) for k, v in dataset.entity_idx.items()},
        entity_vocabs=dataset.entity_vocabs,
        ids={k: np.asarray(v)[rows] for k, v in dataset.ids.items()}, host_cache=host_cache)


@dataclasses.dataclass
class EntityBucket:
    """One size-bucket of random-effect training data.

    features:    [e, cap, d]; d is the bucket's width: the shard width for
                 IDENTITY, the bucket's widest active-column count for
                 INDEX_MAP, the projected width for RANDOM
    labels/weights: [e, cap] (weight 0 marks padding)
    entity_rows: [e] int32, row of each entity in the RE type's vocab
    sample_rows: [e, cap] int32, global sample row of each slot, -1 pad
    col_index:   [e, d] int32, INDEX_MAP only: the original column of each
                 projected slot; pad slots hold the shard width (the scratch
                 column)
    """

    features: torch.Tensor
    labels: torch.Tensor
    weights: torch.Tensor
    entity_rows: torch.Tensor
    sample_rows: torch.Tensor
    col_index: torch.Tensor | None = None

    @property
    def num_entities(self) -> int:
        return self.features.shape[0]

    @property
    def capacity(self) -> int:
        return self.features.shape[1]

    def gather_offsets(self, full_offsets: torch.Tensor) -> torch.Tensor:
        """Current residual offsets for every slot: [e, cap]."""
        rows = self.sample_rows.long()
        gathered = full_offsets[torch.clamp(rows, min=0)]
        return torch.where(rows >= 0, gathered, torch.zeros_like(gathered))


#: the entity row of a padding lane: out of range of every table, so its
#: (all-zero-weight) solve is dropped by the scatter
PAD_ENTITY_ROW = np.iinfo(np.int32).max


def pad_lane_fields(fields: dict, multiple: int) -> dict:
    """Bucket tensors (``features`` [e, cap, d], ``labels``/``weights``/
    ``sample_rows`` [e, cap], ``entity_rows`` [e], optional ``col_index``
    [e, k]) with the lane axis padded to a multiple of ``multiple``. Pad
    lanes carry weight 0, sample rows -1 (zero offsets), entity row
    :data:`PAD_ENTITY_ROW` (no table row is written) and zero features."""
    e = int(fields["entity_rows"].shape[0])
    return pad_lanes_to(fields, e + (-e) % max(1, int(multiple)))


def pad_lanes_to(fields: dict, lanes: int) -> dict:
    """:func:`pad_lane_fields` to exactly ``lanes`` lanes."""
    e = int(fields["entity_rows"].shape[0])
    pad = int(lanes) - e
    if pad < 0:
        raise ValueError(f"cannot pad {e} lanes down to {lanes}")
    if not pad:
        return dict(fields)
    fill = {"sample_rows": -1, "entity_rows": int(PAD_ENTITY_ROW)}
    out = {}
    for k, v in fields.items():
        if v is None:
            out[k] = None
            continue
        extra = torch.full((pad,) + tuple(v.shape[1:]), fill.get(k, 0), dtype=v.dtype,
                           device=v.device)
        out[k] = torch.cat([v, extra])
    return out


def pad_bucket_lanes(bucket: "EntityBucket", multiple: int) -> "EntityBucket":
    """:func:`pad_lane_fields` of an EntityBucket."""
    return EntityBucket(**pad_lane_fields(
        {f.name: getattr(bucket, f.name) for f in dataclasses.fields(bucket)}, multiple))


@dataclasses.dataclass
class RandomEffectDataset:
    """Bucketed per-entity training view for one RE coordinate. ``dim`` is
    the shard width and the table is [num_entities, dim] in original space;
    projected buckets carry narrower features. On a sparse shard the view is
    compact: ``active_cols`` [E, K] holds each entity's sorted active global
    columns (pad = dim), the table is [E, K] over them, and the buckets'
    ``col_index`` holds table positions (pad = K)."""

    random_effect_type: str
    feature_shard_id: str
    buckets: list
    num_entities: int  # size of the entity vocab
    dim: int
    projector_type: ProjectorType = ProjectorType.IDENTITY
    projection: RandomProjectionMatrix | None = None
    #: the projected blocks were rewritten to normalized space at build time
    #: (``build_random_effect_dataset(normalization=...)``): the solves then
    #: run on a plain objective while the table conversions keep the context
    pre_normalized: bool = False
    active_cols: np.ndarray | None = None

    @property
    def num_trained_entities(self) -> int:
        return sum(b.num_entities for b in self.buckets)

    @property
    def is_compact(self) -> bool:
        return self.active_cols is not None

    @property
    def table_width(self) -> int:
        """Second axis of the coefficient table: K in compact mode, the
        shard width otherwise."""
        return self.dim if self.active_cols is None else int(self.active_cols.shape[1])

    def active_cols_on(self, device) -> torch.Tensor:
        """``active_cols`` on ``device``, uploaded once per device (the
        compact table conversions of every update read it)."""
        cache = self.__dict__.setdefault("_active_cols_device", {})
        device = torch.device(device)
        if device not in cache:
            cache[device] = torch.as_tensor(self.active_cols, device=device)
        return cache[device]


def _stable_priorities(sample_ids: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic per-sample priorities for reservoir sampling, stable
    under recompute: the splitmix64 keying of the down-samplers."""
    return stable_uniform(sample_ids, seed)


def group_entities_into_buckets(
    entity_idx: np.ndarray,
    unique_ids: np.ndarray,
    *,
    bucket_sizes: Sequence[int],
    active_data_upper_bound: int | None = None,
    active_data_lower_bound: int | None = None,
    seed: int = 0,
) -> dict[int, list[tuple[int, np.ndarray]]]:
    """Group sample rows by entity into size buckets.

    Returns {bucket_capacity: [(entity_row, sample_rows), ...]}. Applies the
    per-entity reservoir cap (stable-id keyed, reference
    RandomEffectDataSet.scala:354-420) and the lower-bound filter (:320-341).
    """
    valid = entity_idx >= 0
    order = np.argsort(entity_idx[valid], kind="stable")
    rows = np.nonzero(valid)[0][order]
    ents = entity_idx[rows]
    per_bucket: dict[int, list[tuple[int, np.ndarray]]] = {c: [] for c in bucket_sizes}
    if len(ents) == 0:
        return per_bucket
    boundaries = np.concatenate(
        [[0], np.nonzero(ents[1:] != ents[:-1])[0] + 1, [len(ents)]]
    )
    max_bucket = max(bucket_sizes)
    for start, end in zip(boundaries[:-1], boundaries[1:]):
        entity = int(ents[start])
        sample_rows = rows[start:end]
        count = len(sample_rows)
        if active_data_lower_bound is not None and count < active_data_lower_bound:
            continue
        # the largest bucket is an implicit cap: sampling (not
        # head-truncation) applies either way, so the kept subset is unbiased
        cap = min(active_data_upper_bound or max_bucket, max_bucket)
        if count > cap:
            # stable reservoir: keep the `cap` samples with smallest priority
            prio = _stable_priorities(unique_ids[sample_rows], seed)
            keep = np.argsort(prio, kind="stable")[:cap]
            sample_rows = sample_rows[np.sort(keep)]
            count = cap
        bucket_cap = next(c for c in bucket_sizes if c >= count)
        per_bucket[bucket_cap].append((entity, sample_rows))
    return per_bucket


def pack_bucket_lanes(
    members: list[tuple[int, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized lane layout for one bucket's members.

    Returns (entity_rows[e], rows_concat[m], lane[m], slot[m]): sample i of
    entity lane l lands at [lane, slot] in the padded [e, cap] blocks.
    """
    e = len(members)
    entity_rows = np.fromiter(
        (ent for ent, _ in members), dtype=np.int32, count=e
    )
    counts = np.fromiter((len(sr) for _, sr in members), dtype=np.intp, count=e)
    rows_concat = np.concatenate([sr for _, sr in members])
    lane = np.repeat(np.arange(e, dtype=np.intp), counts)
    slot = np.arange(len(rows_concat), dtype=np.intp) - np.repeat(
        np.concatenate(([0], np.cumsum(counts[:-1]))), counts
    )
    return entity_rows, rows_concat, lane, slot


#: the bucket fields a compacted lane block carries, in order
LANE_BLOCK_FIELDS = ("features", "labels", "weights", "sample_rows", "col_index")


def compact_lane_blocks(
    blocks: Sequence[Mapping[str, torch.Tensor]],
    picks: Sequence[tuple[int, np.ndarray]],
    *,
    pad_to: int,
    sentinel_row: int,
) -> tuple[dict[str, torch.Tensor], np.ndarray, np.ndarray]:
    """Gather selected lanes of same-(cap, d) bucket blocks into one padded
    block: the lane compaction of the probe/rescue scheduler
    (``algorithm/lane_scheduler.py``), which re-runs only unconverged entity
    solves. One ``index_select`` per field and pick, on the resident bucket
    tensors' device, so no bucket crosses to the host; the values are those
    of the JAX package's numpy compaction bit for bit.

    picks: [(block_index, lane_indices), ...]; every named block shares
        capacity and feature width (the caller groups by (cap, d)).
    pad_to: lane count of the output block (a power of two, so the set of
        block shapes stays bounded across sweeps).
    sentinel_row: ``entity_rows`` of padding lanes, out of range for any
        coefficient table: gathers clamp and scatters drop.

    Returns (fields, src_block, src_lane): the padded fields (weights 0,
    sample_rows -1, entity_rows the sentinel on padding lanes) and the
    source (block, lane) of each real lane, on the host.
    """
    src_block = np.concatenate(
        [np.full(len(lanes), b, dtype=np.int32) for b, lanes in picks])
    src_lane = np.concatenate([np.asarray(lanes, dtype=np.int64) for _, lanes in picks])
    m = len(src_lane)
    if not 0 < m <= pad_to:
        raise ValueError(f"{m} picked lanes do not fit pad_to={pad_to}")
    pad = pad_to - m
    first = blocks[picks[0][0]]
    device = first["entity_rows"].device
    index = [(b, torch.as_tensor(np.asarray(lanes, dtype=np.int64), device=device))
             for b, lanes in picks]
    out: dict[str, torch.Tensor] = {}
    for key in (*LANE_BLOCK_FIELDS, "entity_rows"):
        if first.get(key) is None:
            continue
        parts = [blocks[b][key].index_select(0, idx) for b, idx in index]
        if pad:
            fill = {"sample_rows": -1, "entity_rows": sentinel_row}.get(key, 0)
            ref = parts[0]
            parts.append(torch.full((pad,) + tuple(ref.shape[1:]), fill, dtype=ref.dtype,
                                    device=device))
        out[key] = torch.cat(parts, dim=0)
    out["entity_rows"] = out["entity_rows"].to(torch.int32)
    return out, src_block, src_lane


def _pearson_keep_mask(x: np.ndarray, y: np.ndarray, num_keep: int) -> np.ndarray:
    """Boolean [d] mask of the ``num_keep`` columns of x most correlated
    (|Pearson|) with y, for one entity. Zero-variance nonzero columns (an
    intercept) score +inf and are always kept; all-zero columns rank last
    (reference LocalDataSet.scala:221-280). The grouped form below is the
    builder's; this one is its yardstick."""
    d = x.shape[1]
    if num_keep >= d:
        return np.ones(d, dtype=bool)
    # f64 scores are the defined semantics: f32 inputs rank alike in this
    # and the grouped form
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xc = x - x.mean(axis=0)
    yc = y - y.mean()
    var_x = (xc * xc).sum(axis=0)
    var_y = float(yc @ yc)
    all_zero = ~np.any(x != 0.0, axis=0)
    const_nonzero = (var_x == 0.0) & ~all_zero  # intercept-like
    if var_y == 0.0:
        # constant labels carry no correlation signal: prefer active,
        # high-variance columns
        score = var_x.astype(np.float64)
    else:
        denom = np.sqrt(var_x * var_y)
        with np.errstate(divide="ignore", invalid="ignore"):
            score = np.abs(xc.T @ yc) / denom
        score = np.where(var_x == 0.0, 0.0, score)
    score = np.where(const_nonzero, np.inf, score)
    score = np.where(all_zero, -np.inf, score)
    keep = np.argsort(-_quantize_scores(score), kind="stable")[:num_keep]
    mask = np.zeros(d, dtype=bool)
    mask[keep] = True
    return mask


def _quantize_scores(score: np.ndarray) -> np.ndarray:
    """Selection scores rounded to 9 decimals before ranking: columns whose
    scores are equal in exact arithmetic (|corr| = 1 for every doubly-active
    column of a 2-sample entity) then tie exactly in both forms, whose sums
    differ in the last ulp, and the stable argsort breaks the tie by column."""
    return np.round(score, 9)


def _pearson_keep_masks_grouped(x: np.ndarray, y: np.ndarray, lane: np.ndarray, e: int,
                                ratio: float) -> np.ndarray:
    """Per-entity Pearson selection as grouped reductions over ``lane``:
    [e, d] keep masks, each entity keeping ceil(ratio · its sample count)
    columns (at least one), with :func:`_pearson_keep_mask`'s semantics."""
    d = x.shape[1]
    counts = np.bincount(lane, minlength=e).astype(np.float64)
    num_keep = np.maximum(1, np.ceil(ratio * counts)).astype(np.int64)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    sum_x = np.zeros((e, d))
    np.add.at(sum_x, lane, x)
    mean_x = sum_x / counts[:, None]
    xc = x - mean_x[lane]
    mean_y = np.bincount(lane, weights=y, minlength=e) / counts
    yc = y - mean_y[lane]
    var_x = np.zeros((e, d))
    np.add.at(var_x, lane, xc * xc)
    var_y = np.bincount(lane, weights=yc * yc, minlength=e)
    cov = np.zeros((e, d))
    np.add.at(cov, lane, xc * yc[:, None])
    all_zero = ~_grouped_active_mask(x, lane, e, d)
    const_nonzero = (var_x == 0.0) & ~all_zero
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = np.abs(cov) / np.sqrt(var_x * var_y[:, None])
    score = np.where(var_x == 0.0, 0.0, corr)
    score = np.where((var_y == 0.0)[:, None], var_x, score)
    score = np.where(const_nonzero, np.inf, score)
    score = np.where(all_zero, -np.inf, score)
    order = np.argsort(-_quantize_scores(score), axis=1, kind="stable")
    ranked_keep = np.arange(d)[None, :] < num_keep[:, None]
    keep = np.zeros((e, d), dtype=bool)
    np.put_along_axis(keep, order, ranked_keep, axis=1)
    return keep


def _grouped_active_mask(x: np.ndarray, lane: np.ndarray, e: int, d: int) -> np.ndarray:
    """[e, d] boolean: does entity (lane) have a nonzero in column j."""
    mask = np.zeros((e, d), dtype=bool)
    t_idx, col = np.nonzero(x)
    mask[lane[t_idx], col] = True
    return mask


def _pack_index_projected(x: np.ndarray, lane: np.ndarray, slot: np.ndarray, e: int, cap: int,
                          dim: int) -> tuple[np.ndarray, np.ndarray]:
    """Index-map packing of one bucket: each entity's active columns
    compacted to the left in ascending order, pad slots holding ``dim`` (the
    scratch column); an entity with no active column keeps column 0. Returns
    (features [e, cap, k], col_index [e, k]), k the widest support."""
    any_nonzero = _grouped_active_mask(x, lane, e, dim)
    any_nonzero[~any_nonzero.any(axis=1), 0] = True
    counts = any_nonzero.sum(axis=1)
    bdim = int(counts.max())
    le, ce = np.nonzero(any_nonzero)  # lane-major, column-ascending
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(le)) - starts[le]
    bc = np.full((e, bdim), dim, dtype=np.int32)
    bc[le, pos] = ce
    safe = np.minimum(bc, dim - 1)
    vals = x[np.arange(x.shape[0])[:, None], safe[lane]]  # [T, k]
    vals = vals * (bc[lane] < dim)
    bf = np.zeros((e, cap, bdim), dtype=x.dtype)
    bf[lane, slot] = vals
    return bf, bc


def _normalize_projected_block(bf, bc, bs, normalization, dim):
    """An index-projected [e, cap, k] block rewritten to normalized space,
    x' = (x - shift)·factor over each entity's gathered columns, on valid
    slots only; the scratch column maps to factor 1 and shift 0, so padding
    stays exactly zero."""
    out = bf
    valid = (bs >= 0)[:, :, None]
    shifts = host_shifts(normalization)
    if shifts is not None:
        shift_ext = np.append(shifts.astype(bf.dtype), bf.dtype.type(0))
        out = out - shift_ext[bc][:, None, :] * valid
    factors = host_factors(normalization)
    if factors is not None:
        fac_ext = np.append(factors.astype(bf.dtype), bf.dtype.type(1))
        out = out * fac_ext[bc][:, None, :]
    return out


def build_random_effect_dataset(
    dataset: GameDataset,
    re_type: str,
    shard_id: str,
    *,
    active_data_upper_bound: int | None = None,
    active_data_lower_bound: int | None = None,
    bucket_sizes: Sequence[int] = (8, 32, 128, 512, 2048),
    seed: int = 0,
    projector_type: ProjectorType = ProjectorType.IDENTITY,
    projected_dim: int | None = None,
    features_to_samples_ratio: float | None = None,
    normalization=None,
    lane_multiple: int = 1,
) -> RandomEffectDataset:
    """Group samples by entity into padded, size-bucketed blocks on the
    dataset's device (a dense shard).

    - lane_multiple: each bucket's lane count is padded to a multiple of it
      with lanes that train nothing (:func:`pad_bucket_lanes`), so the
      lanes split evenly over a mesh's data axis.

    - upper bound: per-entity reservoir cap (stable-id keyed sampling).
    - lower bound: entities with fewer samples are left out of training
      (still scored through the gather path).
    - buckets: entities padded to the smallest bucket capacity >= their
      (capped) sample count.
    - projector: INDEX_MAP packs each entity's active columns with their
      column index; RANDOM sketches the shard through one Gaussian
      ``[dim, projected_dim]`` matrix drawn from ``seed``.
    - features_to_samples_ratio: an entity with c samples keeps its
      ceil(ratio·c) columns best correlated (|Pearson|) with the label; the
      others are zeroed in its block, and so leave its INDEX_MAP support
      (reference LocalDataSet.scala:221-280).
    - normalization (INDEX_MAP and RANDOM): the context the blocks are
      rewritten with at build time, x' = (x - shift)·factor; RANDOM
      normalizes before sketching, which is exact.

    Host work is numpy; only the finished bucket tensors go to the device.
    """
    if lane_multiple > 1:
        ds = build_random_effect_dataset(
            dataset, re_type, shard_id, active_data_upper_bound=active_data_upper_bound,
            active_data_lower_bound=active_data_lower_bound, bucket_sizes=bucket_sizes,
            seed=seed, projector_type=projector_type, projected_dim=projected_dim,
            features_to_samples_ratio=features_to_samples_ratio, normalization=normalization)
        return dataclasses.replace(
            ds, buckets=[pad_bucket_lanes(b, lane_multiple) for b in ds.buckets])
    shard = dataset.feature_shards[shard_id]
    if normalization is not None and projector_type == ProjectorType.IDENTITY \
            and not isinstance(shard, SparseShard):
        raise ValueError(
            "build_random_effect_dataset(normalization=...) pre-normalizes "
            "PROJECTED entity blocks (INDEX_MAP/RANDOM/compact); IDENTITY "
            "coordinates normalize through the objective's context"
        )
    if isinstance(shard, SparseShard):
        if normalization is not None and normalization.shifts is not None:
            raise ValueError(
                "sparse (compact) random-effect shards support SCALE-only "
                "normalization; mean shifts (STANDARDIZATION) would densify "
                "the feature space"
            )
        if projector_type not in (ProjectorType.IDENTITY, ProjectorType.INDEX_MAP):
            raise ValueError(
                f"sparse random-effect shard '{shard_id}': only "
                "IDENTITY/INDEX_MAP projectors are supported (the compact "
                "representation IS an index-map projection)"
            )
        if features_to_samples_ratio is not None:
            raise ValueError(
                "features_to_samples_ratio (Pearson selection) is not "
                "supported on sparse random-effect shards"
            )
        return _build_sparse_random_effect_dataset(
            dataset, re_type, shard_id, shard,
            active_data_upper_bound=active_data_upper_bound,
            active_data_lower_bound=active_data_lower_bound,
            bucket_sizes=bucket_sizes, seed=seed, normalization=normalization)
    entity_idx = dataset.host_array(f"entity_idx/{re_type}")
    features = dataset.host_array(f"shard/{shard_id}")
    labels = dataset.host_array("labels")
    weights = dataset.host_array("weights")
    unique_ids = np.asarray(dataset.unique_ids)
    dim = features.shape[1]
    num_entities = len(dataset.entity_vocabs[re_type])
    device = dataset.device

    projection = None
    if projector_type == ProjectorType.RANDOM:
        if projected_dim is None:
            raise ValueError("RANDOM projection requires projected_dim")
        projection = RandomProjectionMatrix.create(dim, projected_dim, seed)
        if normalization is not None:
            # normalize before sketching (exact); the solves then run plain
            shifts = host_shifts(normalization)
            if shifts is not None:
                features = features - shifts.astype(features.dtype)
            factors = host_factors(normalization)
            if factors is not None:
                features = features * factors.astype(features.dtype)
        features = projection.project_features(features).astype(features.dtype)

    per_bucket = group_entities_into_buckets(
        entity_idx,
        unique_ids,
        bucket_sizes=bucket_sizes,
        active_data_upper_bound=active_data_upper_bound,
        active_data_lower_bound=active_data_lower_bound,
        seed=seed,
    )
    if features_to_samples_ratio is not None and projector_type == ProjectorType.RANDOM:
        raise ValueError(
            "features_to_samples_ratio (Pearson selection) operates on "
            "original feature columns and cannot combine with RANDOM "
            "projection; use IDENTITY or INDEX_MAP"
        )
    buckets: list[EntityBucket] = []
    for cap, members in per_bucket.items():
        if not members:
            continue
        e = len(members)
        be, rows_concat, lane, slot = pack_bucket_lanes(members)
        bl = np.zeros((e, cap), dtype=labels.dtype)
        bw = np.zeros((e, cap), dtype=weights.dtype)
        bs = np.full((e, cap), -1, dtype=np.int32)
        bl[lane, slot] = labels[rows_concat]
        bw[lane, slot] = weights[rows_concat]
        bs[lane, slot] = rows_concat
        # one gather of the bucket's samples; the per-entity work below is
        # grouped reductions over `lane`
        x = features[rows_concat]
        if features_to_samples_ratio is not None:
            keep = _pearson_keep_masks_grouped(x, labels[rows_concat], lane, e,
                                               features_to_samples_ratio)
            x = x * keep[lane]
        bc = None
        if projector_type == ProjectorType.INDEX_MAP:
            bf, bc = _pack_index_projected(x, lane, slot, e, cap, dim)
            if normalization is not None:
                bf = _normalize_projected_block(bf, bc, bs, normalization, dim)
        else:
            bf = np.zeros((e, cap, x.shape[1]), dtype=features.dtype)
            bf[lane, slot] = x
        buckets.append(
            EntityBucket(
                features=device_tensor(bf, shard.dtype, device),
                labels=device_tensor(bl, None, device),
                weights=device_tensor(bw, None, device),
                entity_rows=device_tensor(be, torch.int32, device),
                sample_rows=device_tensor(bs, torch.int32, device),
                col_index=None if bc is None else device_tensor(bc, torch.int32, device),
            )
        )
    return RandomEffectDataset(
        random_effect_type=re_type,
        feature_shard_id=shard_id,
        buckets=buckets,
        num_entities=num_entities,
        dim=dim,
        projector_type=projector_type,
        projection=projection,
        pre_normalized=normalization is not None,
    )


def build_random_effect_dataset_partitioned(
    dataset: GameDataset,
    re_type: str,
    shard_id: str,
    *,
    partition,
    exchange,
    active_data_upper_bound: int | None = None,
    active_data_lower_bound: int | None = None,
    bucket_sizes: Sequence[int] = (8, 32, 128, 512, 2048),
    seed: int = 0,
    lane_multiple: int = 1,
    entity_rank_presence: np.ndarray | None = None,
    tag: str | None = None,
) -> RandomEffectDataset:
    """Rank-local random-effect view over a partitioned read.

    ``dataset`` is this rank's padded block from ``io/partitioned_reader.py``
    (entity indices in the global vocab; pad rows carry entity -1 and are
    left out as everywhere). Buckets are built from the local samples only;
    one allgather of per-capacity entity counts agrees the structure:

    - every rank takes the same capacity list and pads each capacity's lanes
      to the common count (pad lanes: weight 0, entity row out of range), so
      the ranks' lane blocks concatenate to one global bucket;
    - ``sample_rows`` shift by the rank's base row, so they index the global
      sample axis, as the step's gathered residual offsets do.

    An entity whose samples span ranks gets one lane a rank, each solving on
    that rank's samples only, and the last lane's solve (in bucket order,
    then rank order) wins the table row; the full read gives it one lane.
    Entity-clustered inputs keep every entity on one rank and match the full
    read; ``entity_rank_presence`` (from the reader) warns when they do not.
    Dense IDENTITY coordinates only."""
    shard = dataset.feature_shards[shard_id]
    if isinstance(shard, SparseShard):
        raise ValueError(
            f"random-effect coordinate '{re_type}': sparse (compact) "
            "shards are not supported by the partitioned path; use the "
            "full reader"
        )
    if entity_rank_presence is not None:
        spanning = int(np.sum(np.asarray(entity_rank_presence) > 1))
        if spanning:
            import logging

            logging.getLogger(__name__).warning(
                "random-effect coordinate '%s': %d entities have samples on multiple ranks; "
                "their per-rank partial solves deviate from the full-read result "
                "(entity-cluster the input for exact parity)", re_type, spanning)

    local = build_random_effect_dataset(
        dataset, re_type, shard_id, active_data_upper_bound=active_data_upper_bound,
        active_data_lower_bound=active_data_lower_bound, bucket_sizes=bucket_sizes, seed=seed)
    by_cap = {b.capacity: b for b in local.buckets}
    gathered = exchange.allgather(f"re_partitioned/{tag or re_type}",
                                  {str(cap): b.num_entities for cap, b in by_cap.items()})
    all_caps = sorted({int(c) for g in gathered for c in g},
                      key=lambda c: (list(bucket_sizes).index(c) if c in bucket_sizes
                                     else len(bucket_sizes), c))
    dim = local.dim
    base_row = partition.base_row
    device = dataset.device
    buckets: list[EntityBucket] = []
    for cap in all_caps:
        e_max = max(int(g.get(str(cap), 0)) for g in gathered)
        e_pad = -(-e_max // max(1, lane_multiple)) * max(1, lane_multiple)
        b = by_cap.get(cap)
        if b is not None:
            fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
        else:
            fields = dict(
                features=torch.zeros((0, cap, dim), dtype=shard.dtype, device=device),
                labels=torch.zeros((0, cap), dtype=dataset.labels.dtype, device=device),
                weights=torch.zeros((0, cap), dtype=dataset.weights.dtype, device=device),
                entity_rows=torch.zeros((0,), dtype=torch.int32, device=device),
                sample_rows=torch.full((0, cap), -1, dtype=torch.int32, device=device),
                col_index=None)
        fields = pad_lanes_to(fields, e_pad)
        rows = fields["sample_rows"]
        fields["sample_rows"] = torch.where(rows >= 0, rows + base_row,
                                            torch.full_like(rows, -1)).to(torch.int32)
        buckets.append(EntityBucket(**fields))
    return RandomEffectDataset(random_effect_type=re_type, feature_shard_id=shard_id,
                               buckets=buckets, num_entities=local.num_entities, dim=dim,
                               projector_type=ProjectorType.IDENTITY)


def _build_sparse_random_effect_dataset(
    dataset: GameDataset,
    re_type: str,
    shard_id: str,
    shard: SparseShard,
    *,
    active_data_upper_bound: int | None,
    active_data_lower_bound: int | None,
    bucket_sizes: Sequence[int],
    seed: int,
    normalization=None,
) -> RandomEffectDataset:
    """Compact per-entity blocks from a sparse shard, never ``[E, dim]``.

    Each entity's active columns are the union of nonzero columns over its
    kept samples (reference IndexMapProjectorRDD.scala:218-257); its block
    is ``[cap, bdim]`` over them and the table ``[E, K]``, K the widest
    support. Bucket ``col_index`` holds table positions (pad = K), so the
    INDEX_MAP bucket solve runs unchanged on an ``[E, K+1]`` table with its
    scratch column. A SCALE context multiplies the entries' values by their
    column's factor before the gather (the blocks are pre-normalized).
    """
    entity_idx = dataset.host_array(f"entity_idx/{re_type}")
    labels = dataset.host_array("labels")
    weights = dataset.host_array("weights")
    unique_ids = np.asarray(dataset.unique_ids)
    n = dataset.num_samples
    dim = int(shard.feature_dim)
    num_entities = len(dataset.entity_vocabs[re_type])
    device = dataset.device

    rows_s, cols_s, vals_s = (np.asarray(a) for a in shard.coalesced())
    factors = None if normalization is None else host_factors(normalization)
    if factors is not None:
        vals_s = vals_s * factors.astype(vals_s.dtype)[cols_s]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_s, minlength=n), out=row_ptr[1:])

    per_bucket = group_entities_into_buckets(
        entity_idx, unique_ids, bucket_sizes=bucket_sizes,
        active_data_upper_bound=active_data_upper_bound,
        active_data_lower_bound=active_data_lower_bound, seed=seed)

    # pass 1: each bucket's entries and its lanes' sorted active columns
    staged = []
    for cap, members in per_bucket.items():
        if not members:
            continue
        e = len(members)
        be, rows_concat, lane, slot = pack_bucket_lanes(members)
        bl = np.zeros((e, cap), dtype=labels.dtype)
        bw = np.zeros((e, cap), dtype=weights.dtype)
        bs = np.full((e, cap), -1, dtype=np.int32)
        bl[lane, slot] = labels[rows_concat]
        bw[lane, slot] = weights[rows_concat]
        bs[lane, slot] = rows_concat

        # the kept samples' entries, sliced from the row pointers
        cnt = row_ptr[rows_concat + 1] - row_ptr[rows_concat]
        total = int(cnt.sum())
        base = np.repeat(row_ptr[rows_concat], cnt)
        eidx = base + np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        ecol = cols_s[eidx].astype(np.int64)
        evals = vals_s[eidx]
        elane = np.repeat(lane, cnt)
        eslot = np.repeat(slot, cnt)

        key = elane * (dim + 1) + ecol
        uniq = np.unique(key)
        ulane, ucol = uniq // (dim + 1), uniq % (dim + 1)
        counts = np.bincount(ulane, minlength=e)
        bdim = max(int(counts.max(initial=0)), 1)
        starts = np.zeros(e + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        bc = np.full((e, bdim), dim, dtype=np.int32)  # pad = dim (global)
        bc[ulane, np.arange(len(uniq)) - starts[ulane]] = ucol
        # each entry's position in its lane's active list
        epos = np.searchsorted(uniq, key) - starts[elane]
        bf = np.zeros((e, cap, bdim), dtype=vals_s.dtype)
        bf[elane, eslot, epos] = evals
        staged.append((e, be, bl, bw, bs, bc, bf, bdim))

    k_width = max((bdim for *_, bdim in staged), default=1)
    active_cols = np.full((num_entities, k_width), dim, dtype=np.int32)
    buckets: list[EntityBucket] = []
    for e, be, bl, bw, bs, bc, bf, bdim in staged:
        active_cols[be, :bdim] = bc
        # an entity lives in one bucket, so its slot p is table position p;
        # pads point at the scratch column K
        local = np.broadcast_to(np.arange(bdim, dtype=np.int32), (e, bdim)).copy()
        local[bc >= dim] = k_width
        buckets.append(EntityBucket(
            features=device_tensor(bf, None, device),
            labels=device_tensor(bl, None, device),
            weights=device_tensor(bw, None, device),
            entity_rows=device_tensor(be, torch.int32, device),
            sample_rows=device_tensor(bs, torch.int32, device),
            col_index=device_tensor(local, torch.int32, device),
        ))
    return RandomEffectDataset(
        random_effect_type=re_type,
        feature_shard_id=shard_id,
        buckets=buckets,
        num_entities=num_entities,
        dim=dim,
        projector_type=ProjectorType.INDEX_MAP,
        pre_normalized=normalization is not None,
        active_cols=active_cols,
    )


def entity_index_of(keys: np.ndarray, vocab: np.ndarray) -> np.ndarray:
    """Row of each key in ``vocab`` ([n] int32), -1 for a key it lacks."""
    if len(vocab) == 0:
        return np.full(len(keys), -1, dtype=np.int32)
    order = np.argsort(vocab, kind="stable")
    sorted_vocab = vocab[order]
    pos = np.minimum(np.searchsorted(sorted_vocab, keys), len(vocab) - 1)
    return np.where(sorted_vocab[pos] == keys, order[pos], -1).astype(np.int32)


def build_game_dataset(
    *,
    labels,
    feature_shards: Mapping[str, object],
    entity_keys: Mapping[str, np.ndarray] | None = None,
    offsets=None,
    weights=None,
    unique_ids=None,
    ids: Mapping[str, np.ndarray] | None = None,
    entity_vocabs: Mapping[str, np.ndarray] | None = None,
    dtype=np.float32,
    shard_dtypes: Mapping[str, torch.dtype] | None = None,
    device=None,
) -> GameDataset:
    """Assemble a GameDataset from host arrays on ``device`` (CUDA unless
    ``device="cpu"``).

    entity_keys: RE type -> [n] per-sample entity key array; vocabs are built
    from the observed keys unless provided (scoring held-out rows needs the
    training vocab). Keys are canonically strings.

    shard_dtypes: per-shard storage dtype (``torch.bfloat16`` rounds that
    shard's block once on the way to the device); the host copy stays
    ``dtype``.
    """
    device = resolve_device(device)
    labels = np.asarray(labels, dtype=dtype)
    n = len(labels)
    offsets = np.zeros(n, dtype) if offsets is None else np.asarray(offsets, dtype)
    weights = np.ones(n, dtype) if weights is None else np.asarray(weights, dtype)
    unique_ids = np.arange(n, dtype=np.int64) if unique_ids is None else np.asarray(unique_ids)

    vocabs: dict[str, np.ndarray] = {}
    entity_idx: dict[str, torch.Tensor] = {}
    host_idx: dict[str, np.ndarray] = {}
    for re_type, keys in (entity_keys or {}).items():
        keys = np.asarray(keys).astype(str)
        if entity_vocabs is not None and re_type in entity_vocabs:
            vocab = np.asarray(entity_vocabs[re_type]).astype(str)
            idx = entity_index_of(keys, vocab)
        else:
            vocab, inverse = np.unique(keys, return_inverse=True)
            idx = inverse.astype(np.int32)
        vocabs[re_type] = vocab
        entity_idx[re_type] = device_tensor(idx, torch.int32, device)
        host_idx[re_type] = idx

    solve = _NUMPY_TO_TORCH[np.dtype(dtype)]
    host_shards = {k: np.asarray(v, dtype=dtype) for k, v in feature_shards.items()
                   if not isinstance(v, SparseShard)}
    device_shards: dict = {}
    for k, v in feature_shards.items():
        if isinstance(v, SparseShard):
            device_shards[k] = v
        else:
            device_shards[k] = device_tensor(host_shards[k], (shard_dtypes or {}).get(k, solve),
                                             device)
    return GameDataset(
        unique_ids=unique_ids,
        labels=device_tensor(labels, solve, device),
        offsets=device_tensor(offsets, solve, device),
        weights=device_tensor(weights, solve, device),
        feature_shards=device_shards,
        entity_idx=entity_idx,
        entity_vocabs=vocabs,
        ids=dict(ids or {}),
        host_cache={"labels": labels, "offsets": offsets, "weights": weights,
                    **{f"shard/{k}": v for k, v in host_shards.items()},
                    **{f"entity_idx/{t}": v for t, v in host_idx.items()}},
    )
