"""Partitioned host ingestion: each rank decodes about 1/P of the input bytes.

Counterpart of ``photon_ml_tpu/io/partitioned_reader.py``; reference
photon-client data/avro/AvroDataReader.scala:125-200 (Spark hands each
executor task a split of the input and only feature-index metadata is
shared). Every rank of a multi-process run calls :func:`read_partitioned`
with the same arguments:

- **Assignment.** The sorted part files split into P contiguous runs of
  near-equal bytes (:func:`assign_contiguous`); an input of fewer files than
  ranks splits by Avro container blocks instead (``avro.scan_block_index``:
  a header decode and a seek a block, no data read). Contiguity keeps the
  concatenation of the ranks' rows in the full read's order.
- **Decode.** Files mode reads the rank's files through ``read_merged`` (the
  port's native columnar decoder); blocks mode decodes the rank's block run
  with the Python codec (``avro.read_container_block_range``).
- **Consistency.** One metadata allgather (the plan's fingerprint, row
  counts, each shard's feature keys, entity ids and counts) makes the index
  maps and entity vocabularies the full read's: ``IndexMap.from_keys`` sorts,
  so the union of the ranks' keys is the full read's map, and local columns
  and entity indices are remapped into it. Sparse shards agree their layout
  the same way (:func:`_resolve_global_sparse_layout`: the hybrid hot head
  from the summed column histograms, the ELL width and the flat overflow's
  length from the summed row-count histograms).
- **Layout.** Each rank pads its rows to the agreed block length with
  zero-weight rows, so the global sample axis is P equal blocks and rank r's
  block is rows ``[r·block_rows, (r+1)·block_rows)``: the rows a rank of the
  data-axis mesh owns.

The exchanges run on the host (``parallel/multihost``), before any device
work. ``num_ranks == 1`` delegates to ``read_merged`` unchanged. The bytes a
rank decoded stand on the result (``bytes_decoded``, ``input_bytes_total``).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import itertools
import json
import logging
import os
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.data.batch import device_tensor
from photon_ml_torch.data.game_data import GameDataset, pad_game_dataset_to
from photon_ml_torch.data.sparse_batch import (
    SparseShard,
    _ell_auto_width_from_hist,
    rank_hot_columns,
)
from photon_ml_torch.device import resolve_device
from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.io.data_reader import (
    UID,
    FeatureShardConfiguration,
    ReadResult,
    build_index_maps,
    read_merged,
    records_to_game_dataset,
)
from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap
from photon_ml_torch.telemetry import io_counters, tracing
from photon_ml_torch.telemetry.layout import record_global_hot_ranking

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """Rank geometry of one partitioned read: the global sample axis is
    ``num_ranks`` blocks of ``block_rows`` rows; rank r's true rows are the
    first ``local_rows[r]`` of block r, the rest zero-weight padding."""

    rank: int
    num_ranks: int
    local_rows: tuple[int, ...]
    block_rows: int

    @property
    def global_rows(self) -> int:
        return self.num_ranks * self.block_rows

    @property
    def total_true_rows(self) -> int:
        return int(sum(self.local_rows))

    @property
    def base_row(self) -> int:
        return self.rank * self.block_rows

    @property
    def local_n(self) -> int:
        return int(self.local_rows[self.rank])

    def true_row_mask(self) -> np.ndarray:
        """[global_rows] bool: True on real rows, False on block padding."""
        mask = np.zeros(self.global_rows, dtype=bool)
        for r, n in enumerate(self.local_rows):
            mask[r * self.block_rows: r * self.block_rows + n] = True
        return mask


@dataclasses.dataclass
class PartitionedReadResult:
    """One rank's slice of a partitioned read.

    result: the rank's dataset (padded to ``partition.block_rows``) with the
        global index maps, entity vocabularies and intercepts.
    entity_rank_presence: RE type -> [num_entities] int, on how many ranks
        each entity has samples. An entity on several ranks makes the
        rank-local random-effect view deviate from the full read's
        (``data/game_data.build_random_effect_dataset_partitioned``);
        entity-clustered inputs keep it at most 1.
    """

    result: ReadResult
    partition: PartitionInfo
    mode: str  # "single" | "files" | "blocks"
    local_files: list[str]
    bytes_decoded: int
    input_bytes_total: int
    entity_rank_presence: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)


def assign_contiguous(weights: Sequence[int], num_ranks: int) -> list[tuple[int, int]]:
    """Split items into ``num_ranks`` contiguous [lo, hi) runs of near-equal
    total weight: boundary r lands where the prefix sum comes closest to r/P
    of the total. Contiguity keeps the concatenation of the ranks' slices in
    the full read's row order."""
    weights = [max(int(w), 0) for w in weights]
    prefix = np.concatenate([[0], np.cumsum(weights, dtype=np.int64)])
    total = int(prefix[-1])
    bounds = [0]
    for r in range(1, num_ranks):
        target = total * r / num_ranks
        idx = int(np.searchsorted(prefix, target, side="left"))
        # the boundary at whichever adjacent prefix sits closer to the target
        if idx > 0 and (
            idx > len(weights)
            or target - prefix[idx - 1] <= prefix[min(idx, len(weights))] - target
        ):
            idx -= 1
        bounds.append(min(max(idx, bounds[-1]), len(weights)))
    bounds.append(len(weights))
    return [(bounds[r], bounds[r + 1]) for r in range(num_ranks)]


def _list_input_files(path, fmt: str) -> list[str]:
    paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
    if fmt == "avro":
        files: list[str] = []
        for p in paths:
            files += avro_io.list_avro_files(p)
        return files
    raise ValueError(
        f"partitioned ingestion supports fmt='avro' (got {fmt!r}); "
        "LibSVM inputs read through the single-process path"
    )


def _local_keys(imap: IndexMap, cfg: FeatureShardConfiguration) -> list[str]:
    """The data feature keys of a locally built map, without the synthetic
    intercept (every rank's map appends it; the global map adds it once)."""
    keys = list(imap)
    if cfg.has_intercept:
        keys = [k for k in keys if k != INTERCEPT_KEY]
    return keys


def _global_columns(local_map: IndexMap, global_map: IndexMap) -> np.ndarray:
    """[local d] global column of each local column."""
    gidx = np.asarray([global_map.get_index(local_map.get_feature_name(j))
                       for j in range(local_map.size)], dtype=np.int64)
    if (gidx < 0).any():
        raise ValueError("local feature key missing from the global map")
    return gidx


def _remap_dense(x: np.ndarray, local_map: IndexMap, global_map: IndexMap) -> np.ndarray:
    out = np.zeros((x.shape[0], global_map.size), dtype=x.dtype)
    if local_map.size:
        out[:, _global_columns(local_map, global_map)] = np.asarray(x)
    return out


def _remap_sparse(shard: SparseShard, local_map: IndexMap,
                  global_map: IndexMap) -> SparseShard:
    gidx = _global_columns(local_map, global_map)
    cols = np.asarray(shard.cols, dtype=np.int64)
    new_cols = gidx[cols] if len(cols) else cols
    return dataclasses.replace(shard, cols=new_cols, feature_dim=global_map.size,
                               _device={}, _coalesced=None, _hybrid_cache=None)


def _schema_lacks_uid(files: list[str]) -> bool:
    """True when the records carry no uid field: the reader then numbers the
    rows, which are rank-local in a partitioned read and shift into the
    global row space. Decided from the first file's schema, so every rank
    agrees. A uid field that is null for some rows keeps local numbers
    there (the exchange cannot see it)."""
    if not files:
        return False
    try:
        schema = avro_io.read_container_schema(files[0])
    except (avro_io.AvroError, OSError):
        return False
    fields = schema.get("fields", []) if isinstance(schema, dict) else []
    return not any(f.get("name") == UID for f in fields)


def _plan_fingerprint(files: list[str], sizes: list[int], mode: str, ranges) -> str:
    blob = json.dumps([[os.path.basename(f) for f in files], sizes, mode, list(ranges)]).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _replace_dataset(ds: GameDataset, **changes) -> GameDataset:
    """``dataclasses.replace`` of a dataset, its cached sparse batches
    dropped (they hold the old layout)."""
    return dataclasses.replace(ds, _sparse_batches={}, **changes)


def _on_device(ds: GameDataset, device: torch.device) -> GameDataset:
    """The dataset's tensors on ``device`` (sparse shards stay host COO)."""
    if ds.device == device:
        return ds

    def put(t):
        return t.to(device)

    return GameDataset(
        unique_ids=ds.unique_ids, labels=put(ds.labels), offsets=put(ds.offsets),
        weights=put(ds.weights),
        feature_shards={k: v if isinstance(v, SparseShard) else put(v)
                        for k, v in ds.feature_shards.items()},
        entity_idx={k: put(v) for k, v in ds.entity_idx.items()},
        entity_vocabs=ds.entity_vocabs, ids=ds.ids, host_cache=dict(ds.host_cache))


def read_partitioned(
    path,
    shard_configs: Mapping[str, FeatureShardConfiguration],
    *,
    exchange=None,
    index_maps: Mapping[str, IndexMap] | None = None,
    random_effect_id_columns: Sequence[str] = (),
    evaluation_id_columns: Sequence[str] = (),
    entity_vocabs: Mapping[str, np.ndarray] | None = None,
    fmt: str = "avro",
    dtype=np.float32,
    pad_multiple: int = 1,
    tag: str = "read",
    on_corrupt: str = "raise",
    device=None,
) -> PartitionedReadResult:
    """Partition-aware ``read_merged``: decode only this rank's slice, on
    ``device`` (CUDA unless "cpu").

    exchange: a ``parallel/multihost.MetadataExchange``. None does not
    partition: the full read on this process. Pass
    ``multihost.default_exchange()`` (or another transport) to partition;
    every rank then calls with the same arguments, since the allgathers are
    collective. ``pad_multiple`` rounds the common block length up (the
    mesh's devices a rank along "data"; 1 in the port). ``tag`` keeps the
    exchanges of several inputs of one run apart. on_corrupt="quarantine"
    (Avro) skips and counts corrupt blocks; in blocks mode the quarantining
    index scan decides the skips, the same on every rank.

    ``num_ranks == 1`` delegates to ``read_merged`` byte for byte.
    """
    device = resolve_device(device)
    if exchange is None:
        from photon_ml_torch.parallel.multihost import SingleProcessExchange

        exchange = SingleProcessExchange()
    rank, num_ranks = exchange.rank, exchange.num_ranks

    if num_ranks == 1:
        result = read_merged(
            path, shard_configs, index_maps=index_maps,
            random_effect_id_columns=random_effect_id_columns,
            evaluation_id_columns=evaluation_id_columns, entity_vocabs=entity_vocabs,
            fmt=fmt, dtype=dtype, on_corrupt=on_corrupt, device=device)
        n = result.dataset.num_samples
        return PartitionedReadResult(result=result, partition=PartitionInfo(0, 1, (n,), n),
                                     mode="single", local_files=[], bytes_decoded=0,
                                     input_bytes_total=0)

    files = _list_input_files(path, fmt)
    sizes = [os.path.getsize(f) for f in files]
    input_total = int(sum(sizes))
    io_counters.set_input_bytes_total(input_total)
    common = dict(index_maps=index_maps, random_effect_id_columns=random_effect_id_columns,
                  evaluation_id_columns=evaluation_id_columns, entity_vocabs=entity_vocabs,
                  dtype=dtype)
    if len(files) >= num_ranks:
        mode = "files"
        ranges = assign_contiguous(sizes, num_ranks)
        lo, hi = ranges[rank]
        local_files = files[lo:hi]
        bytes_decoded = int(sum(sizes[lo:hi]))
        local = _read_local_files(local_files, shard_configs, fmt=fmt, on_corrupt=on_corrupt,
                                  **common)
    else:
        mode = "blocks"
        # every rank scans every file's index (a header and a seek a block)
        # and decodes only its contiguous block run; under quarantine the
        # scan drops corrupt spans the same way on every rank
        indexes = [avro_io.scan_block_index(f, on_corrupt=on_corrupt) for f in files]
        blocks = [(fi, bi, payload) for fi, file_index in enumerate(indexes)
                  for bi, (_, payload, _) in enumerate(file_index)]
        if not blocks:
            raise ValueError(f"no Avro blocks under {path!r}")
        ranges = assign_contiguous([b[2] for b in blocks], num_ranks)
        lo, hi = ranges[rank]
        my_blocks = blocks[lo:hi]
        bytes_decoded = int(sum(b[2] for b in my_blocks))
        local_files = sorted({files[b[0]] for b in my_blocks})
        records = []
        for fi, group in itertools.groupby(my_blocks, key=lambda b: b[0]):
            run = list(group)
            records.extend(avro_io.read_container_block_range(
                files[fi], run[0][1], len(run), index=indexes[fi], on_corrupt=on_corrupt))
        local = _read_local_records(records, shard_configs, **common)
    io_counters.record_bytes_decoded(bytes_decoded)

    # the one metadata allgather: the plan's fingerprint, row counts, feature
    # keys (maps built locally), entity ids and counts (only the counts when
    # the caller gives the vocabularies, as scoring against a model does)
    local_n = local.dataset.num_samples
    payload = {"fingerprint": _plan_fingerprint(files, sizes, mode, ranges), "n": local_n}
    if index_maps is None:
        payload["keys"] = {shard: _local_keys(local.index_maps[shard], cfg)
                           for shard, cfg in shard_configs.items() if not cfg.pre_indexed}
    vocab_counts = {}
    for t in random_effect_id_columns:
        vocab = np.asarray(local.dataset.entity_vocabs[t]).astype(str)
        idx = np.asarray(local.dataset.host_array(f"entity_idx/{t}"))
        counts = (np.bincount(idx[idx >= 0], minlength=len(vocab)) if len(vocab)
                  else np.zeros(0, np.int64))
        if entity_vocabs is not None and t in entity_vocabs:
            vocab_counts[t] = (None, counts.astype(int).tolist())
        else:
            vocab_counts[t] = (vocab.tolist(), counts.astype(int).tolist())
    payload["entities"] = vocab_counts
    with tracing.span("partitioned/metadata_exchange", cat="partitioned", tag=tag,
                      rank=exchange.rank):
        gathered = exchange.allgather(f"partitioned_read/{tag}", payload)

    fingerprints = {g["fingerprint"] for g in gathered}
    if len(fingerprints) != 1:
        raise RuntimeError(f"ranks disagree on the partition plan ({fingerprints}); the "
                           "input listing must be identical on every rank")
    local_rows = tuple(int(g["n"]) for g in gathered)
    if sum(local_rows) == 0:
        raise ValueError(f"no samples decoded from {path!r} on any rank")
    block_rows = -(-max(max(local_rows), 1) // pad_multiple) * pad_multiple

    result = local
    if index_maps is None:
        global_maps: dict[str, IndexMap] = {}
        for shard, cfg in shard_configs.items():
            if cfg.pre_indexed:
                global_maps[shard] = local.index_maps[shard]
                continue
            union: set[str] = set()
            for g in gathered:
                union.update(g["keys"][shard])
            global_maps[shard] = IndexMap.from_keys(union, add_intercept=cfg.has_intercept)
        result = _remap_to_global_maps(local, shard_configs, global_maps)

    presence: dict[str, np.ndarray] = {}
    if random_effect_id_columns:
        result, presence = _remap_to_global_vocabs(result, random_effect_id_columns, gathered,
                                                   provided_vocabs=entity_vocabs)

    # the sparse layout is a global decision: a rank's block never elects
    # its own hot head or ELL width
    result = _resolve_global_sparse_layout(result, exchange, tag, pad_multiple=pad_multiple)

    # uid-less inputs: the reader numbered the rows from 0 on every rank
    if _schema_lacks_uid(files):
        base = int(sum(local_rows[:rank]))
        if base:
            ds = result.dataset
            result = dataclasses.replace(result, dataset=_replace_dataset(
                ds, unique_ids=np.asarray(ds.unique_ids) + base))

    padded, _ = pad_game_dataset_to(result.dataset, block_rows)
    result = ReadResult(dataset=_on_device(padded, device), index_maps=result.index_maps,
                        intercept_indices=result.intercept_indices)
    partition = PartitionInfo(rank, num_ranks, local_rows, block_rows)
    logger.info("partitioned read rank %d/%d (%s mode): %d rows (block %d), %d/%d bytes "
                "decoded", rank, num_ranks, mode, local_n, block_rows, bytes_decoded,
                input_total)
    return PartitionedReadResult(result=result, partition=partition, mode=mode,
                                 local_files=local_files, bytes_decoded=bytes_decoded,
                                 input_bytes_total=input_total, entity_rank_presence=presence)


def _read_local_files(local_files, shard_configs, *, index_maps, random_effect_id_columns,
                      evaluation_id_columns, entity_vocabs, fmt, dtype,
                      on_corrupt="raise") -> ReadResult:
    """A rank's files through ``read_merged``, on the host (the remaps and
    padding run there; the finished block moves to the device once)."""
    if local_files:
        return read_merged(local_files, shard_configs, index_maps=index_maps,
                           random_effect_id_columns=random_effect_id_columns,
                           evaluation_id_columns=evaluation_id_columns,
                           entity_vocabs=entity_vocabs, fmt=fmt, dtype=dtype,
                           on_corrupt=on_corrupt, device="cpu")
    return _read_local_records([], shard_configs, index_maps=index_maps,
                               random_effect_id_columns=random_effect_id_columns,
                               evaluation_id_columns=evaluation_id_columns,
                               entity_vocabs=entity_vocabs, dtype=dtype)


def _read_local_records(records: list, shard_configs, *, index_maps, random_effect_id_columns,
                        evaluation_id_columns, entity_vocabs, dtype) -> ReadResult:
    """Decoded records as a rank's dataset, on the host."""
    maps = index_maps or build_index_maps(records, shard_configs)
    return records_to_game_dataset(records, shard_configs, maps,
                                   random_effect_id_columns=random_effect_id_columns,
                                   evaluation_id_columns=evaluation_id_columns,
                                   entity_vocabs=entity_vocabs, dtype=dtype, device="cpu")


def _remap_to_global_maps(local: ReadResult, shard_configs: Mapping[str, FeatureShardConfiguration],
                          global_maps: Mapping[str, IndexMap]) -> ReadResult:
    """The local dataset's feature columns in the global index space: a
    column scatter per dense shard, a column relabel per sparse shard."""
    ds = local.dataset
    new_shards: dict[str, object] = {}
    host_cache = dict(ds.host_cache)
    intercepts: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        lmap, gmap = local.index_maps[shard], global_maps[shard]
        value = ds.feature_shards[shard]
        if cfg.pre_indexed or lmap is gmap:
            new_shards[shard] = value
        elif isinstance(value, SparseShard):
            new_shards[shard] = _remap_sparse(value, lmap, gmap)
        else:
            remapped = _remap_dense(ds.host_array(f"shard/{shard}"), lmap, gmap)
            new_shards[shard] = device_tensor(remapped, value.dtype, value.device)
            host_cache[f"shard/{shard}"] = remapped
        if cfg.has_intercept:
            ii = gmap.get_index(INTERCEPT_KEY)
            if ii >= 0:
                intercepts[shard] = ii
    return ReadResult(dataset=_replace_dataset(ds, feature_shards=new_shards,
                                               host_cache=host_cache),
                      index_maps=dict(global_maps), intercept_indices=intercepts)


def _pack_i64(a: np.ndarray) -> str:
    """int64 array -> base64 for the JSON payloads: the hot-ranking
    histograms hold one entry per distinct column a rank saw (millions at a
    giant d), too many for a list of Python ints."""
    return base64.b64encode(np.ascontiguousarray(a, dtype="<i8").tobytes()).decode("ascii")


def _unpack_i64(s: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(s), dtype="<i8")


def _resolve_global_sparse_layout(local: ReadResult, exchange, tag: str, *,
                                  pad_multiple: int = 1) -> ReadResult:
    """Every sparse shard's layout decisions made global:

    - **The hybrid hot head** (a shard with a ``hybrid_policy``): each rank
      ships its per-column nonzero histogram (global columns, after the map
      remap) through one allgather; every rank sums them and applies
      ``rank_hot_columns``, so the hot ids, and with them the head's shape
      and column order, are equal on every rank.
    - **The ELL width and the flat overflow's length** (every sparse
      shard): each rank ships its histogram of per-row entry counts (true
      local rows, after the hybrid split); the width is the full read's auto
      rule (``_ell_auto_width_from_hist``) on the summed histogram, with the
      zero-count rows the mesh padding of a full read would append mirrored
      in. Each rank's overflow beyond that width follows from the same
      histograms, so all ranks agree one ``flat_block_nnz`` (the largest,
      rounded up to ``pad_multiple``) with no further exchange.

    Shards are taken in sorted order, so every rank makes the same calls.
    """
    ds = local.dataset
    sparse_shards = {k: v for k, v in ds.feature_shards.items() if isinstance(v, SparseShard)}
    if not sparse_shards:
        return local
    new_shards = dict(ds.feature_shards)
    for name in sorted(sparse_shards):
        shard = sparse_shards[name]
        rows, cols, _ = shard.coalesced()
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        policy = shard.hybrid_policy
        hot = None
        if policy is not None and policy.hot_ids is None:
            uniq, cnt = (np.unique(cols, return_counts=True) if len(cols)
                         else (np.zeros(0, np.int64), np.zeros(0, np.int64)))
            with tracing.span("partitioned/hybrid_hot_exchange", cat="partitioned", shard=name,
                              rank=exchange.rank):
                gathered_hist = exchange.allgather(f"hybrid_hot/{tag}/{name}",
                                                   {"cols": _pack_i64(uniq),
                                                    "counts": _pack_i64(cnt)})
            all_cols = np.concatenate([_unpack_i64(g["cols"]) for g in gathered_hist])
            all_cnts = np.concatenate([_unpack_i64(g["counts"]) for g in gathered_hist])
            # the summed histogram, sorted by id: np.unique over a full read
            guniq, inv = np.unique(all_cols, return_inverse=True)
            gcnt = np.zeros(len(guniq), dtype=np.int64)
            np.add.at(gcnt, inv, all_cnts)
            gnnz = int(gcnt.sum())
            hot = rank_hot_columns(guniq, gcnt, gnnz, policy)
            if len(hot) == 0:
                raise ValueError(f"feature shard '{name}': hybrid=true but no rank decoded "
                                 "any nonzero entry — nothing to rank")
            policy = dataclasses.replace(policy, hot_ids=tuple(int(c) for c in hot))
            record_global_hot_ranking(policy.label, k_hot=len(hot), global_nnz=gnnz,
                                      num_ranks=exchange.num_ranks)
        elif policy is not None:
            hot = np.asarray(policy.hot_ids, dtype=np.int64)

        if hot is not None and len(cols):
            pos = np.searchsorted(hot, cols)
            tail_rows = rows[hot[np.minimum(pos, len(hot) - 1)] != cols]
        else:
            tail_rows = rows
        n_local = int(shard.num_samples)
        counts = (np.bincount(tail_rows, minlength=n_local).astype(np.int64) if n_local
                  else np.zeros(0, np.int64))
        freq = np.bincount(counts) if n_local else np.zeros(1, np.int64)
        with tracing.span("partitioned/ell_width_exchange", cat="partitioned", shard=name,
                          rank=exchange.rank):
            gathered_rows = exchange.allgather(f"ell_width/{tag}/{name}",
                                               {"freq": freq.astype(int).tolist(),
                                                "n": n_local})
        depth = max(len(g["freq"]) for g in gathered_rows)
        gfreq = np.zeros(depth, dtype=np.int64)
        rank_freqs = []
        for g in gathered_rows:
            f = np.zeros(depth, dtype=np.int64)
            f[: len(g["freq"])] = np.asarray(g["freq"], dtype=np.int64)
            rank_freqs.append(f)
            gfreq += f
        gn = int(sum(int(g["n"]) for g in gathered_rows))
        widths = np.arange(depth, dtype=np.int64)
        gnnz = int((gfreq * widths).sum())
        # a full read picks its width after the mesh padding (data axis =
        # pad_multiple · num_ranks) appends zero-count rows
        pad0 = (-gn) % (pad_multiple * exchange.num_ranks)
        if pad0:
            gfreq[0] += pad0
            gn += pad0
        width = _ell_auto_width_from_hist(gfreq, gn, gnnz)
        flat = max(int((f * np.maximum(widths - width, 0)).sum()) for f in rank_freqs)
        if flat:
            flat = -(-flat // pad_multiple) * pad_multiple
        new_shards[name] = dataclasses.replace(shard, hybrid_policy=policy, ell_width=width,
                                               flat_block_nnz=int(flat), _device={},
                                               _hybrid_cache=None)
    return ReadResult(dataset=_replace_dataset(ds, feature_shards=new_shards),
                      index_maps=local.index_maps, intercept_indices=local.intercept_indices)


def _remap_to_global_vocabs(local: ReadResult, re_types: Sequence[str], gathered: list[dict], *,
                            provided_vocabs) -> tuple[ReadResult, dict[str, np.ndarray]]:
    """The union of the ranks' entity vocabularies (the sorted global vocab,
    a full read's ``np.unique`` over all keys), the local entity index
    remapped into it, and on how many ranks each entity has samples."""
    ds = local.dataset
    new_vocabs = dict(ds.entity_vocabs)
    new_idx = dict(ds.entity_idx)
    host_cache = dict(ds.host_cache)
    presence: dict[str, np.ndarray] = {}
    for t in re_types:
        rank_counts = [np.asarray(g["entities"][t][1], dtype=np.int64) for g in gathered]
        if provided_vocabs is not None and t in provided_vocabs:
            # the vocab is shared knowledge: only counts crossed, aligned to it
            global_vocab = np.asarray(provided_vocabs[t]).astype(str)
            remap_needed = False
            pres = np.zeros(len(global_vocab), dtype=np.int64)
            for c in rank_counts:
                pres += (c > 0).astype(np.int64)
        else:
            rank_vocabs = [np.asarray(g["entities"][t][0], dtype=str) for g in gathered]
            global_vocab = np.unique(np.concatenate(
                [v for v in rank_vocabs if len(v)] or [np.zeros(0, str)]))
            remap_needed = True
            pres = np.zeros(len(global_vocab), dtype=np.int64)
            for v, c in zip(rank_vocabs, rank_counts):
                if len(v):
                    pos = np.searchsorted(global_vocab, v)
                    pos = np.minimum(pos, max(len(global_vocab) - 1, 0))
                    hit = (global_vocab[pos] == v if len(global_vocab)
                           else np.zeros(len(v), bool))
                    np.add.at(pres, pos[hit], (c[hit] > 0).astype(np.int64))
        presence[t] = pres
        if remap_needed:
            local_vocab = np.asarray(ds.entity_vocabs[t]).astype(str)
            idx = np.asarray(ds.host_array(f"entity_idx/{t}"))
            if len(local_vocab):
                lookup = np.searchsorted(global_vocab, local_vocab)
                remapped = np.where(idx >= 0, lookup[np.maximum(idx, 0)], -1).astype(np.int32)
            else:
                remapped = idx.astype(np.int32)
            new_idx[t] = device_tensor(remapped, torch.int32, ds.device)
            host_cache[f"entity_idx/{t}"] = remapped
            new_vocabs[t] = global_vocab
    return (ReadResult(dataset=_replace_dataset(ds, entity_idx=new_idx,
                                                entity_vocabs=new_vocabs, host_cache=host_cache),
                       index_maps=local.index_maps, intercept_indices=local.intercept_indices),
            presence)
