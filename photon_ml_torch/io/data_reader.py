"""Avro training data -> GameDataset (the port's reader).

Counterpart of ``photon_ml_tpu/io/data_reader.py`` on its pure-Python path;
reference photon-client data/avro/AvroDataReader.scala (reads Avro records,
merges feature bags into per-shard vectors via index maps, :165-200),
data/DataReader.scala (readMerged) and GameConverters (row -> GameDatum keyed
by unique sample id).

The reader builds every column in numpy on the host, with the reference's
arithmetic step for step (COO triples in float64, the dense block scattered
in the storage dtype, a bfloat16 shard rounded once from the finished f32
block), so a dataset read here equals the JAX package's element for element;
only the finished arrays move to the device (``build_game_dataset``).

Left out (``NotImplementedError``, ROADMAP.md item 14): sparse and
pre-indexed shards, the hybrid layout and LibSVM input. The JAX package's
native C++ decoder is host code the port does not load; a port-owned copy is
queued (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, build_game_dataset
from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap, feature_key
from photon_ml_torch.util.timed import Timed

#: Standard column names (reference data/InputColumnsNames.scala).
UID = "uid"
RESPONSE = "response"
OFFSET = "offset"
WEIGHT = "weight"
META_DATA_MAP = "metadataMap"
RESERVED_COLUMNS = frozenset({UID, RESPONSE, "label", OFFSET, WEIGHT, META_DATA_MAP, "foldId"})


@dataclasses.dataclass(frozen=True)
class FeatureShardConfiguration:
    """Reference photon-client io/FeatureShardConfiguration.scala: which
    feature bags merge into this shard and whether to append an intercept.

    ``dtype`` is the storage type of the dense block, "float32" or
    "bfloat16" (rounded once on the host from the assembled f32 block).
    ``sparse``, ``pre_indexed``/``dimension`` and the ``hybrid*`` fields are
    carried so that a configuration of the JAX package maps over; the port's
    reader does not take them yet (ROADMAP.md item 14)."""

    feature_bags: tuple[str, ...]
    has_intercept: bool = True
    sparse: bool = False
    pre_indexed: bool = False
    dimension: int | None = None
    dtype: str = "float32"
    hybrid: bool = False
    hybrid_hot_cols: int | None = None
    hybrid_coverage: float | None = None

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"feature shard dtype must be 'float32' or 'bfloat16', got {self.dtype!r}")
        if self.dtype == "bfloat16" and self.sparse:
            raise ValueError("dtype=bfloat16 applies to dense feature blocks; sparse "
                             "shards keep f32 values")
        if self.hybrid and not self.sparse:
            raise ValueError("hybrid=true is the dense-head/sparse-tail layout of SPARSE "
                             "shards (sparse=true)")
        if not self.hybrid and (self.hybrid_hot_cols is not None
                                or self.hybrid_coverage is not None):
            raise ValueError("hybrid.hot.cols / hybrid.coverage require hybrid=true")

    def check_ported(self, shard: str) -> None:
        """Raise NotImplementedError for a shard form the port cannot read."""
        if self.sparse or self.pre_indexed or self.hybrid:
            raise NotImplementedError(
                f"feature shard '{shard}': sparse, pre-indexed and hybrid shards are "
                "not read by the port yet: ROADMAP.md item 14")


def read_avro_records(path: str | os.PathLike, *, on_corrupt: str = "raise") -> Iterator[dict]:
    """Iterate training records from an Avro file or directory of part files."""
    return avro_io.read_directory(path, on_corrupt=on_corrupt)


def _record_bags(record: dict) -> dict[str, list[dict]]:
    """Feature bags = record fields holding arrays of feature dicts
    (reference AvroDataReader reads every array-of-FeatureAvro field)."""
    bags = {}
    for key, value in record.items():
        if (
            isinstance(value, list)
            and value
            and isinstance(value[0], dict)
            and "name" in value[0]
            and "value" in value[0]
        ):
            bags[key] = value
        elif isinstance(value, list) and not value and key not in RESERVED_COLUMNS:
            bags[key] = []
    return bags


def build_index_maps(
    records: Iterable[dict],
    shard_configs: Mapping[str, FeatureShardConfiguration],
) -> dict[str, IndexMap]:
    """One pass over the data to collect distinct feature keys per shard
    (reference FeatureIndexingDriver / DefaultIndexMapLoader path)."""
    keys: dict[str, set[str]] = {shard: set() for shard in shard_configs}
    for record in records:
        bags = _record_bags(record)
        for shard, cfg in shard_configs.items():
            for bag in cfg.feature_bags:
                for feat in bags.get(bag, ()):
                    keys[shard].add(feature_key(feat["name"], feat.get("term") or ""))
    return {
        shard: IndexMap.from_keys(keys[shard], add_intercept=cfg.has_intercept)
        for shard, cfg in shard_configs.items()
    }


@dataclasses.dataclass
class ReadResult:
    dataset: GameDataset
    index_maps: dict[str, IndexMap]
    intercept_indices: dict[str, int]


def _scatter_dense(n: int, d: int, row_idx: np.ndarray, col_idx: np.ndarray, vals: np.ndarray,
                   dtype) -> np.ndarray:
    """[n, d] dense block from COO triples; duplicate (row, col) accumulate."""
    x = np.zeros((n, d), dtype=dtype)
    if len(col_idx):
        np.add.at(x, (row_idx.astype(np.intp), col_idx.astype(np.intp)), vals.astype(dtype))
    return x


def _apply_intercept(x: np.ndarray, imap: IndexMap, shard: str,
                     intercept_indices: dict[str, int]) -> None:
    """Set the intercept column to 1 and record its index, if the map has one."""
    ii = imap.get_index(INTERCEPT_KEY)
    if ii >= 0:
        x[:, ii] = 1.0
        intercept_indices[shard] = ii


def _round_to(x: np.ndarray, storage: str) -> np.ndarray:
    """The assembled block as its storage type holds it: a bfloat16 shard
    rounds (to nearest even) once, here, and stays f32 on the host."""
    if storage == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def records_to_game_dataset(
    records: Iterable[dict],
    shard_configs: Mapping[str, FeatureShardConfiguration],
    index_maps: Mapping[str, IndexMap],
    *,
    random_effect_id_columns: Sequence[str] = (),
    evaluation_id_columns: Sequence[str] = (),
    entity_vocabs: Mapping[str, np.ndarray] | None = None,
    dtype=np.float32,
    device=None,
) -> ReadResult:
    """Assemble a GameDataset on ``device`` (CUDA unless "cpu") from record
    dicts.

    Id columns (random-effect types, per-query eval ids) are taken from the
    record's metadataMap first, then from top-level record fields — the
    reference's idTagToValueMap extraction (GameConverters.scala).
    """
    for shard, cfg in shard_configs.items():
        cfg.check_ported(shard)
    labels: list[float] = []
    offsets: list[float] = []
    weights: list[float] = []
    uids: list[int] = []
    rows: dict[str, list[tuple[int, int, float]]] = {s: [] for s in shard_configs}
    id_cols: dict[str, list[str]] = {
        c: [] for c in set(random_effect_id_columns) | set(evaluation_id_columns)
    }

    n = 0
    for record in records:
        label = record.get("label", record.get(RESPONSE))
        if label is None:
            raise ValueError("record has neither 'label' nor 'response'")
        labels.append(float(label))
        offset = record.get(OFFSET)
        offsets.append(0.0 if offset is None else float(offset))
        weight = record.get(WEIGHT)
        weights.append(1.0 if weight is None else float(weight))
        uid = record.get(UID)
        try:
            uids.append(int(uid) if uid is not None else n)
        except ValueError:
            # a non-numeric uid hashes into [2^62, 2^63), disjoint from any
            # non-negative numeric uid below 2^62
            digest = hashlib.blake2b(str(uid).encode(), digest_size=8).digest()
            hashed = int.from_bytes(digest, "little") & ((1 << 62) - 1)
            uids.append(hashed | (1 << 62))

        meta = record.get(META_DATA_MAP) or {}
        for col in id_cols:
            value = meta.get(col, record.get(col))
            id_cols[col].append("" if value is None else str(value))

        bags = _record_bags(record)
        for shard, cfg in shard_configs.items():
            imap = index_maps[shard]
            for bag in cfg.feature_bags:
                for feat in bags.get(bag, ()):
                    j = imap.get_index(feature_key(feat["name"], feat.get("term") or ""))
                    if j >= 0:
                        rows[shard].append((n, j, float(feat["value"])))
        n += 1

    feature_shards: dict[str, np.ndarray] = {}
    intercept_indices: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        triples = np.asarray(rows[shard], dtype=np.float64) if rows[shard] else np.zeros((0, 3))
        x = _scatter_dense(n, imap.size, triples[:, 0], triples[:, 1], triples[:, 2], dtype)
        if cfg.has_intercept:
            _apply_intercept(x, imap, shard, intercept_indices)
        feature_shards[shard] = _round_to(x, cfg.dtype)

    dataset = build_game_dataset(
        labels=np.asarray(labels),
        feature_shards=feature_shards,
        entity_keys={c: np.asarray(id_cols[c]) for c in random_effect_id_columns},
        offsets=np.asarray(offsets),
        weights=np.asarray(weights),
        unique_ids=np.asarray(uids, dtype=np.int64),
        ids={c: np.asarray(id_cols[c]) for c in evaluation_id_columns},
        entity_vocabs=entity_vocabs,
        dtype=dtype,
        shard_dtypes={s: torch.bfloat16 for s, c in shard_configs.items()
                      if c.dtype == "bfloat16"},
        device=device,
    )
    return ReadResult(dataset=dataset, index_maps=dict(index_maps),
                      intercept_indices=intercept_indices)


def read_merged(
    path: str | os.PathLike | Sequence[str | os.PathLike],
    shard_configs: Mapping[str, FeatureShardConfiguration],
    *,
    index_maps: Mapping[str, IndexMap] | None = None,
    random_effect_id_columns: Sequence[str] = (),
    evaluation_id_columns: Sequence[str] = (),
    entity_vocabs: Mapping[str, np.ndarray] | None = None,
    fmt: str = "avro",
    dtype=np.float32,
    on_corrupt: str = "raise",
    device=None,
) -> ReadResult:
    """One-call read: build index maps if needed, then the dataset
    (reference DataReader.readMerged). ``path`` may be a list of paths,
    read in order as one dataset.

    on_corrupt: "raise" (default, strict) or "quarantine": corrupt container
    blocks are skipped and counted (``avro.quarantined_blocks``).
    """
    paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
    if not paths:
        raise ValueError("read_merged needs at least one input path")
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}")
    if fmt != "avro":
        raise NotImplementedError(
            f"input format {fmt!r}: the port reads Avro only; LibSVM input is ROADMAP.md "
            "item 14")
    for shard, cfg in shard_configs.items():
        cfg.check_ported(shard)

    def records():
        return itertools.chain.from_iterable(
            read_avro_records(p, on_corrupt=on_corrupt) for p in paths)

    if index_maps is None:
        # decode once: the index maps and the dataset both scan every record
        with Timed("avro decode"):
            materialized = list(records())
        with Timed("build index maps"):
            index_maps = build_index_maps(materialized, shard_configs)
        source = materialized
    else:
        source = records()
    return records_to_game_dataset(
        source, shard_configs, index_maps,
        random_effect_id_columns=random_effect_id_columns,
        evaluation_id_columns=evaluation_id_columns,
        entity_vocabs=entity_vocabs, dtype=dtype, device=device)
