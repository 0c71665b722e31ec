"""Avro training data -> GameDataset (the port's reader).

Counterpart of ``photon_ml_tpu/io/data_reader.py``;
reference photon-client data/avro/AvroDataReader.scala (reads Avro records,
merges feature bags into per-shard vectors via index maps, :165-200),
data/DataReader.scala (readMerged) and GameConverters (row -> GameDatum keyed
by unique sample id).

The reader builds every column in numpy on the host, with the reference's
arithmetic step for step (COO triples in float64, the dense block scattered
in the storage dtype, a bfloat16 shard rounded once from the finished f32
block), so a dataset read here equals the JAX package's element for element;
only the finished arrays move to the device (``build_game_dataset``).

A sparse shard stays COO triples end to end (a ``SparseShard``, with its
hybrid policy); a pre-indexed shard (LibSVM integer columns) uses column j as
feature j through an ``IdentityIndexMap``. Avro reads through the port's
columnar C++ decoder (``io/avro_native.py``) unless ``PHOTON_NO_NATIVE_AVRO=1``
asks for the Python codec; an input outside the decoder's subset reads with
the Python codec and is counted (``avro_native.fallbacks``). LibSVM parses
with the port's C++ parser (``io/libsvm.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
import os
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.data.game_data import GameDataset, build_game_dataset
from photon_ml_torch.data.sparse_batch import HybridPolicy, SparseShard
from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.io import avro_native as av
from photon_ml_torch.io.index_map import INTERCEPT_KEY, IdentityIndexMap, IndexMap, feature_key
from photon_ml_torch.io.libsvm import concat_libsvm, parse_libsvm
from photon_ml_torch.util.timed import Timed

logger = logging.getLogger(__name__)

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
    ``sparse`` keeps the shard as COO triples (a ``SparseShard``), for
    feature spaces too wide to densify; ``hybrid*`` give it a dense head
    (``data/sparse_batch.HybridPolicy``). ``pre_indexed`` with ``dimension``
    takes LibSVM's integer columns as the feature ids (LibSVM input only)."""

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
        # range checks are HybridPolicy's, so the CLI and programmatic paths agree
        self.hybrid_policy()

    def hybrid_policy(self, label: str = "sparse") -> HybridPolicy | None:
        """The shard's HybridPolicy (None when hybrid is off)."""
        if not self.hybrid:
            return None
        return HybridPolicy(hot_cols=self.hybrid_hot_cols, coverage=self.hybrid_coverage,
                            label=label)


def read_avro_records(path: str | os.PathLike, *, on_corrupt: str = "raise") -> Iterator[dict]:
    """Iterate training records from an Avro file or directory of part files."""
    return avro_io.read_directory(path, on_corrupt=on_corrupt)


def read_libsvm(path: str | os.PathLike, *, zero_based: bool = False) -> Iterator[dict]:
    """Read LibSVM text into TrainingExample-shaped dicts: feature name =
    str(0-based index), term = "", ±1 labels mapped to {0, 1} and any other
    label kept as a regression target."""
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            raw_label = float(parts[0])
            label = (1.0 if raw_label > 0 else 0.0) if raw_label in (-1.0, 1.0) else raw_label
            features = []
            for tok in parts[1:]:
                if tok.startswith("#"):
                    break  # trailing comment
                idx_s, _, val_s = tok.partition(":")
                idx = int(idx_s) - (0 if zero_based else 1)
                if idx < 0:
                    # a 0 index in a 1-based file is an error, as in the CSR parser
                    raise ValueError(f"feature index out of range at line {i + 1}: {tok!r}")
                features.append({"name": str(idx), "term": "", "value": float(val_s)})
            yield {"uid": str(i), "label": label, "features": features, "weight": 1.0,
                   "offset": 0.0, "metadataMap": None}


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


def _assemble_sparse_shard(n: int, imap: IndexMap, cfg: FeatureShardConfiguration,
                           triples: np.ndarray, dtype, shard: str,
                           intercept_indices: dict[str, int]) -> SparseShard:
    """COO shard assembly, never densified: the intercept column becomes n
    explicit (i, intercept, 1.0) entries; duplicate (row, col) pairs add up
    when the shard coalesces."""
    row_idx = triples[:, 0].astype(np.int64)
    col_idx = triples[:, 1].astype(np.int64)
    vals = triples[:, 2].astype(dtype)
    if cfg.has_intercept:
        ii = imap.get_index(INTERCEPT_KEY)
        if ii >= 0:
            row_idx = np.concatenate([row_idx, np.arange(n, dtype=np.int64)])
            col_idx = np.concatenate([col_idx, np.full(n, ii, dtype=np.int64)])
            vals = np.concatenate([vals, np.ones(n, dtype=dtype)])
            intercept_indices[shard] = ii
    return SparseShard(rows=row_idx, cols=col_idx, vals=vals, num_samples=n,
                       feature_dim=imap.size, hybrid_policy=cfg.hybrid_policy(label=shard))


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

    feature_shards: dict[str, object] = {}
    intercept_indices: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        triples = np.asarray(rows[shard], dtype=np.float64) if rows[shard] else np.zeros((0, 3))
        if cfg.sparse:
            feature_shards[shard] = _assemble_sparse_shard(n, imap, cfg, triples, dtype, shard,
                                                           intercept_indices)
            continue
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
        shard_dtypes=_shard_dtypes(shard_configs),
        device=device,
    )
    return ReadResult(dataset=dataset, index_maps=dict(index_maps),
                      intercept_indices=intercept_indices)


def _shard_dtypes(shard_configs: Mapping[str, FeatureShardConfiguration]) -> dict:
    """Per-shard torch storage dtypes (``build_game_dataset(shard_dtypes=)``)."""
    return {s: torch.bfloat16 for s, c in shard_configs.items() if c.dtype == "bfloat16"}


def shard_np_dtypes(
    shard_configs: Mapping[str, FeatureShardConfiguration],
) -> dict[str, object] | None:
    """Per-shard numpy storage dtypes from the shard configs (``ml_dtypes.
    bfloat16`` for a bfloat16 shard), None when every shard keeps the
    reader's dtype. The port's reader stores through :func:`_shard_dtypes`'
    torch dtypes; this is the JAX package's name for the same decision."""
    if not any(c.dtype == "bfloat16" for c in shard_configs.values()):
        return None
    import ml_dtypes

    return {s: ml_dtypes.bfloat16 for s, c in shard_configs.items() if c.dtype == "bfloat16"}


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

    on_corrupt: "raise" (default, strict) or "quarantine" (Avro only):
    corrupt container blocks are skipped and counted
    (``avro.quarantined_blocks``). ``fmt="libsvm"`` reads LibSVM text
    (:func:`_read_merged_libsvm`).
    """
    paths = [path] if isinstance(path, (str, os.PathLike)) else list(path)
    if not paths:
        raise ValueError("read_merged needs at least one input path")
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}")
    if on_corrupt == "quarantine" and fmt != "avro":
        raise ValueError(
            f"on_corrupt={on_corrupt!r} supports fmt='avro' only (LibSVM "
            "text has no block framing to quarantine)")
    pre_idx = [s for s, c in shard_configs.items() if c.pre_indexed]
    if pre_idx and fmt != "libsvm":
        raise ValueError(
            f"pre-indexed shards {pre_idx} require the libsvm input format "
            "(avro features are name-term keyed; index them with feature "
            "maps instead)")
    if fmt == "libsvm":
        return _read_merged_libsvm(
            paths, shard_configs, index_maps=index_maps,
            random_effect_id_columns=random_effect_id_columns,
            evaluation_id_columns=evaluation_id_columns, entity_vocabs=entity_vocabs,
            dtype=dtype, device=device)
    if fmt != "avro":
        raise ValueError(f"unknown format {fmt!r}")
    if os.environ.get("PHOTON_NO_NATIVE_AVRO") != "1":
        try:
            return _read_merged_avro_native(
                paths, shard_configs, index_maps=index_maps,
                random_effect_id_columns=random_effect_id_columns,
                evaluation_id_columns=evaluation_id_columns, entity_vocabs=entity_vocabs,
                dtype=dtype, on_corrupt=on_corrupt, device=device)
        except _AvroNativeFallback as e:
            av.fallbacks += 1
            logger.info("native Avro decode not used (%s); reading with the Python codec", e)

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


class _AvroNativeFallback(Exception):
    """The native Avro path cannot read this input: use the Python codec."""


def _read_merged_avro_native(
    paths: Sequence[str | os.PathLike],
    shard_configs: Mapping[str, FeatureShardConfiguration],
    *,
    index_maps: Mapping[str, IndexMap] | None,
    random_effect_id_columns: Sequence[str],
    evaluation_id_columns: Sequence[str],
    entity_vocabs: Mapping[str, np.ndarray] | None,
    dtype,
    on_corrupt: str = "raise",
    device=None,
) -> ReadResult:
    """Vectorized Avro read over the native columnar decoder
    (``io/avro_native.py``).

    Same semantics as ``records_to_game_dataset`` over the Python decode —
    label/response precedence, offset/weight defaults, uid hashing,
    metadataMap-then-top-level id lookup, per-shard bag merging with the
    one shared duplicate-accumulation rule; held equal by
    tests/test_torch_avro_native.py. Raises :class:`_AvroNativeFallback`
    whenever any input is outside the native subset; a decoder that does not
    build raises its ``RuntimeError``.

    Under ``on_corrupt="quarantine"`` every file is framing-validated
    first (length bounds + sync markers — header decode plus one seek and
    a 16-byte read per block, no payload reads); a file with ANY corrupt
    block falls back to the Python quarantine reader, which owns the
    skip-and-count semantics. Clean files keep the native decode.
    """
    av.load_avro_library()
    with Timed("avro decode"):
        decoded = _decode_native(paths, on_corrupt)
    return _native_dataset(decoded, shard_configs, index_maps=index_maps,
                           random_effect_id_columns=random_effect_id_columns,
                           evaluation_id_columns=evaluation_id_columns,
                           entity_vocabs=entity_vocabs, dtype=dtype, device=device)


def _decode_native(paths, on_corrupt: str):
    """(columns of every part file, the first file's plan)."""
    try:
        files: list[str] = []
        for p in paths:
            files += avro_io.list_avro_files(p)
        if on_corrupt == "quarantine":
            for f in files:
                problems = avro_io.validate_container(f)
                if problems:
                    raise _AvroNativeFallback(
                        f"{f}: {len(problems)} corrupt block span(s); "
                        "quarantining via the Python reader"
                    )
        parts = []
        plan0: "av.AvroPlan | None" = None
        for f in files:
            plan = av.compile_plan(avro_io.read_container_schema(f))
            if plan0 is None:
                plan0 = plan
            elif not plan.same_semantics(plan0):
                # schema evolution between part files: the faithfulness
                # guards are per-plan, so a later part could bypass them
                raise av.AvroNativeUnsupported(
                    f"part file {f} has a different schema"
                )
            parts.append(av.decode_columns(f, plan))
        cols = av.concat_columns(parts)
    except avro_io.AvroError as e:
        # AvroNativeUnsupported, and values the native tables cannot render
        # (e.g. a double metadataMap entry): the Python reader is
        # authoritative for both the data and any error message
        raise _AvroNativeFallback(str(e)) from e
    return cols, plan0


def _native_dataset(decoded, shard_configs, *, index_maps, random_effect_id_columns,
                    evaluation_id_columns, entity_vocabs, dtype, device) -> ReadResult:
    """The GameDataset of natively decoded columns (Python reader semantics)."""
    cols, plan0 = decoded
    n = cols.n

    # requested bags that exist in the schema but were not bag-shaped have
    # uncertain record-level semantics — let the Python path decide
    for cfg in shard_configs.values():
        for bag in cfg.feature_bags:
            if bag in plan0.all_fields and bag not in cols.bags:
                raise _AvroNativeFallback(
                    f"field '{bag}' is not a feature-bag shape"
                )

    def numcol(name, default):
        if name in plan0.all_fields and name not in cols.num:
            # e.g. a string-typed offset: Python parses/raises; a silent
            # default would diverge
            raise _AvroNativeFallback(
                f"field '{name}' has a non-numeric schema shape"
            )
        col = cols.num.get(name)
        if col is None:
            return np.full(n, default, dtype=np.float64)
        null = cols.num_null[name]
        if name in plan0.strnum_fields and np.isnan(col[~null]).any():
            # a non-null NaN under a string union is an unparseable string
            # — Python raises there; let it
            raise _AvroNativeFallback(
                f"field '{name}' has unparseable string values"
            )
        # nulls take the default (Python's `if value is None`); genuine NaN
        # doubles propagate, exactly like float(nan)
        return np.where(null, default, col)

    # Python precedence: label first (whatever its type), then response —
    # a label field the native path could not collect numerically must not
    # silently yield to response
    if "label" in plan0.all_fields and "label" not in cols.num:
        raise _AvroNativeFallback("label field has an uncollectable shape")
    if "label" in cols.num:
        labels = cols.num["label"]
        if cols.num_null["label"].any():
            raise _AvroNativeFallback("null label values")
    elif RESPONSE in cols.num:
        labels = cols.num[RESPONSE]
    elif RESPONSE in plan0.all_fields:
        raise _AvroNativeFallback("response field has an uncollectable shape")
    else:
        raise ValueError("record has neither 'label' nor 'response'")
    if np.isnan(labels).any():
        # null labels error identically on the Python path; non-numeric
        # string labels are its call too
        raise _AvroNativeFallback("null or non-numeric label values")
    offsets = numcol(OFFSET, 0.0)
    weights = numcol(WEIGHT, 1.0)

    # uid -> stable int64 ids (same rules as records_to_game_dataset)
    if UID in cols.num:
        uid_col = cols.num[UID]
        uids = np.where(
            np.isnan(uid_col), np.arange(n, dtype=np.float64), uid_col
        ).astype(np.int64)
    elif UID in cols.str_ids:
        table = cols.str_tables[UID]
        mapped = np.empty(len(table), dtype=np.int64)
        for i, s in enumerate(table):
            try:
                mapped[i] = int(s)
            except ValueError:
                digest = hashlib.blake2b(s.encode(), digest_size=8).digest()
                hashed = int.from_bytes(digest, "little") & ((1 << 62) - 1)
                mapped[i] = hashed | (1 << 62)
        ids = cols.str_ids[UID]
        uids = np.where(
            ids == av.NULL_ID,
            np.arange(n, dtype=np.int64),
            mapped[np.minimum(ids.astype(np.int64), len(table) - 1)]
            if table else 0,
        )
    else:
        uids = np.arange(n, dtype=np.int64)

    # id columns: metadataMap first (key PRESENT wins even with null value),
    # then a top-level field, else ""
    id_cols: dict[str, np.ndarray] = {}
    meta = cols.maps.get(META_DATA_MAP)
    mkeys = cols.map_key_tables.get(META_DATA_MAP, [])
    mvals = np.asarray(
        cols.map_val_tables.get(META_DATA_MAP, []) + [""], dtype=object
    )
    wanted = set(random_effect_id_columns) | set(evaluation_id_columns)
    if wanted and META_DATA_MAP in plan0.all_fields and meta is None:
        raise _AvroNativeFallback(
            "metadataMap has an uncollectable shape but id columns are "
            "requested"
        )
    for col in wanted:
        out = np.full(n, "", dtype=object)
        seen = np.zeros(n, dtype=bool)
        if meta is not None and col in mkeys:
            kid = mkeys.index(col)
            rows, kids, vids = meta
            sel = kids == kid
            rsel = rows[sel].astype(np.int64)
            v = vids[sel].astype(np.int64)
            v = np.where(v == np.int64(av.NULL_ID), len(mvals) - 1, v)
            out[rsel] = mvals[v]
            seen[rsel] = True
        if (
            col not in cols.str_ids and col not in cols.num
            and col in plan0.all_fields and not seen.all()
        ):
            # e.g. an enum-typed id column: Python renders str(value);
            # silently collapsing every entity into "" would be far worse
            raise _AvroNativeFallback(
                f"id column '{col}' has an uncollectable schema shape"
            )
        if col in cols.str_ids:
            table = np.asarray(cols.str_tables[col] + [""], dtype=object)
            ids = cols.str_ids[col].astype(np.int64)
            ids = np.where(ids == np.int64(av.NULL_ID), len(table) - 1, ids)
            fill = ~seen
            out[fill] = table[ids[fill]]
        elif col in cols.num:
            vals = cols.num[col]
            fill = ~seen & ~np.isnan(vals)
            if fill.any() and col in plan0.unfaithful_id_fields:
                # float/bool-typed id columns can't reproduce Python's
                # str() rendering from an f64 column
                raise _AvroNativeFallback(
                    f"id column '{col}' has a float/bool-typed schema"
                )
            # pure int columns render like Python ints (vectorized)
            out[fill] = vals[fill].astype(np.int64).astype(str)
        id_cols[col] = out.astype(str)

    # feature bags -> per-shard triples through the index maps
    if index_maps is None:
        with Timed("build index maps"):
            built: dict[str, IndexMap] = {}
            for shard, cfg in shard_configs.items():
                keys: set[str] = set()
                for bag in cfg.feature_bags:
                    keys.update(cols.bag_tables.get(bag, []))
                built[shard] = IndexMap.from_keys(keys, add_intercept=cfg.has_intercept)
            index_maps = built

    feature_shards: dict[str, object] = {}
    intercept_indices: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        rows_l, cols_l, vals_l = [], [], []
        for bag in cfg.feature_bags:
            if bag not in cols.bags:
                continue
            br, bk, bv = cols.bags[bag]
            table = cols.bag_tables[bag]
            idx = np.asarray(
                [imap.get_index(k) for k in table], dtype=np.int64
            )
            j = idx[bk.astype(np.int64)] if len(table) else np.zeros(0, np.int64)
            keep = j >= 0
            rows_l.append(br.astype(np.int64)[keep])
            cols_l.append(j[keep])
            vals_l.append(bv[keep])
        if rows_l:
            triples = np.stack(
                [
                    np.concatenate(rows_l).astype(np.float64),
                    np.concatenate(cols_l).astype(np.float64),
                    np.concatenate(vals_l),
                ],
                axis=1,
            )
        else:
            triples = np.zeros((0, 3))
        if cfg.sparse:
            feature_shards[shard] = _assemble_sparse_shard(
                n, imap, cfg, triples, dtype, shard, intercept_indices
            )
            continue
        x = _scatter_dense(
            n, imap.size, triples[:, 0], triples[:, 1], triples[:, 2], dtype
        )
        if cfg.has_intercept:
            _apply_intercept(x, imap, shard, intercept_indices)
        feature_shards[shard] = _round_to(x, cfg.dtype)

    dataset = build_game_dataset(
        labels=labels,
        feature_shards=feature_shards,
        entity_keys={
            c: id_cols[c] for c in random_effect_id_columns
        },
        offsets=offsets,
        weights=weights,
        unique_ids=uids,
        ids={c: id_cols[c] for c in evaluation_id_columns},
        entity_vocabs=entity_vocabs,
        dtype=dtype,
        shard_dtypes=_shard_dtypes(shard_configs),
        device=device,
    )
    return ReadResult(dataset=dataset, index_maps=dict(index_maps),
                      intercept_indices=intercept_indices)


def _libsvm_files(paths: Sequence[str | os.PathLike]) -> list:
    """Each path, a directory expanded to its sorted regular files (the
    part-file convention of the Avro path)."""
    def expand(p):
        if os.path.isdir(p):
            return [os.path.join(p, f) for f in sorted(os.listdir(p))
                    if not f.startswith(("_", ".")) and os.path.isfile(os.path.join(p, f))]
        return [p]

    files = [f for p in paths for f in expand(p)]
    if not files:
        raise ValueError(f"no LibSVM files found under {list(paths)}")
    return files


def _libsvm_index_maps(shard_configs: Mapping[str, FeatureShardConfiguration],
                       distinct: np.ndarray) -> dict[str, IndexMap]:
    """Index maps of a LibSVM read: an ``IdentityIndexMap`` of the declared
    dimension for a pre-indexed shard, else the distinct indices' names."""
    index_maps: dict[str, IndexMap] = {}
    for shard, cfg in shard_configs.items():
        if cfg.pre_indexed:
            if cfg.dimension is None:
                raise ValueError(f"pre-indexed shard '{shard}' needs a dimension")
            if cfg.dimension > np.iinfo(np.int32).max:
                # the gather kernels take int32 column ids
                raise ValueError(
                    f"pre-indexed shard '{shard}': dimension {cfg.dimension} exceeds "
                    "int32; the port's sparse kernels take int32 column ids")
            if cfg.has_intercept:
                raise ValueError(
                    f"pre-indexed shard '{shard}': intercept=false required (an "
                    "appended intercept would change the declared dimension; include "
                    "it in the data)")
            index_maps[shard] = IdentityIndexMap(cfg.dimension)
        else:
            index_maps[shard] = IndexMap.from_keys(
                {feature_key(str(int(j)), "") for j in distinct}
                if "features" in cfg.feature_bags else set(),
                add_intercept=cfg.has_intercept)
    return index_maps


def _read_merged_libsvm(
    paths: Sequence[str | os.PathLike],
    shard_configs: Mapping[str, FeatureShardConfiguration],
    *,
    index_maps: Mapping[str, IndexMap] | None,
    random_effect_id_columns: Sequence[str],
    evaluation_id_columns: Sequence[str],
    entity_vocabs: Mapping[str, np.ndarray] | None,
    dtype,
    device=None,
) -> ReadResult:
    """Vectorized LibSVM read with the record path's semantics: feature name
    = str(0-based index), term = "", one bag called "features"; LibSVM
    carries no id or metadata columns, so every id is "". A pre-indexed shard
    takes the columns as they are against its dimension: sparse, it keeps
    the COO triples; dense, it is scattered. Any other shard maps columns
    through its index map and is assembled dense."""
    with Timed("libsvm parse"):
        data = concat_libsvm([parse_libsvm(p) for p in _libsvm_files(paths)])
    n = data.num_rows
    distinct = np.unique(data.cols) if data.nnz else np.asarray([], dtype=np.uint32)
    if index_maps is None:
        index_maps = _libsvm_index_maps(shard_configs, distinct)

    row_idx = data.row_ids()
    feature_shards: dict[str, object] = {}
    intercept_indices: dict[str, int] = {}
    for shard, cfg in shard_configs.items():
        imap = index_maps[shard]
        if cfg.pre_indexed and "features" in cfg.feature_bags:
            dim = int(imap.size)
            oob = int((data.cols >= dim).sum()) if data.nnz else 0
            if oob:
                raise ValueError(
                    f"pre-indexed shard '{shard}': {oob} entries have column >= "
                    f"dimension {dim}")
            if cfg.sparse:
                feature_shards[shard] = SparseShard(
                    rows=row_idx.astype(np.int64), cols=data.cols.astype(np.int64),
                    vals=data.vals.astype(dtype), num_samples=n, feature_dim=dim,
                    hybrid_policy=cfg.hybrid_policy(label=shard))
            else:
                feature_shards[shard] = _round_to(
                    _scatter_dense(n, dim, row_idx, data.cols.astype(np.int64), data.vals,
                                   dtype), cfg.dtype)
            continue
        if "features" in cfg.feature_bags and data.nnz:
            # a column j maps through the index map of its name; searchsorted
            # over the distinct indices keeps memory O(distinct)
            mapped_distinct = np.asarray(
                [imap.get_index(feature_key(str(int(j)), "")) for j in distinct],
                dtype=np.int64)
            mapped = mapped_distinct[np.searchsorted(distinct, data.cols)]
            keep = mapped >= 0
            x = _scatter_dense(n, imap.size, row_idx[keep], mapped[keep], data.vals[keep],
                               dtype)
        else:
            x = np.zeros((n, imap.size), dtype=dtype)
        if cfg.has_intercept:
            _apply_intercept(x, imap, shard, intercept_indices)
        feature_shards[shard] = _round_to(x, cfg.dtype)

    empty_ids = np.full(n, "", dtype=object)
    dataset = build_game_dataset(
        labels=data.mapped_labels(),
        feature_shards=feature_shards,
        entity_keys={c: empty_ids for c in random_effect_id_columns},
        offsets=np.zeros(n),
        weights=np.ones(n),
        unique_ids=np.arange(n, dtype=np.int64),
        ids={c: empty_ids for c in evaluation_id_columns},
        entity_vocabs=entity_vocabs,
        dtype=dtype,
        shard_dtypes=_shard_dtypes(shard_configs),
        device=device,
    )
    return ReadResult(dataset=dataset, index_maps=dict(index_maps),
                      intercept_indices=intercept_indices)
