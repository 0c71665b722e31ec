"""Feature index maps: (name, term) -> dense column index (the port's copy).

Counterpart of ``photon_ml_tpu/io/index_map.py``; reference photon-api
index/IndexMap.scala, DefaultIndexMap(Loader), and the client's Constants
(DELIMITER="\\u0001", INTERCEPT_NAME="(INTERCEPT)", reference photon-lib
Constants.scala:31-42).

The index map is host metadata; it never reaches the device. Persistence is
a sorted key file + JSON metadata, the format the JAX package writes; a
stores directory may also hold partitioned off-heap stores
(``io/offheap_index_map.py``, ``<shard>.photonix.json``) and the
reference's PalDB partitions (``io/paldb.py``), which ``load_directory``
reads too.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Mapping

DELIMITER = ""
INTERCEPT_NAME = "(INTERCEPT)"
INTERCEPT_TERM = ""


def feature_key(name: str, term: str = "") -> str:
    """Reference Utils.getFeatureKey: name + DELIMITER + term."""
    return f"{name}{DELIMITER}{term}"


def split_feature_key(key: str) -> tuple[str, str]:
    name, _, term = key.partition(DELIMITER)
    return name, term


INTERCEPT_KEY = feature_key(INTERCEPT_NAME, INTERCEPT_TERM)



class IndexMap(Mapping[str, int]):
    """Immutable feature-key -> index map with reverse lookup.

    Reference IndexMap: getIndex / getFeatureName + the map contract.
    """

    def __init__(self, key_to_index: dict[str, int]):
        self._forward = dict(key_to_index)
        self._reverse: dict[int, str] | None = None

    # Mapping protocol -------------------------------------------------------
    def __getitem__(self, key: str) -> int:
        return self._forward[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._forward)

    def __len__(self) -> int:
        return len(self._forward)

    # Reference API ----------------------------------------------------------
    def get_index(self, key: str) -> int:
        """-1 when absent (reference IndexMap.NULL_KEY semantics)."""
        return self._forward.get(key, -1)

    def get_feature_name(self, index: int) -> str | None:
        if self._reverse is None:
            self._reverse = {v: k for k, v in self._forward.items()}
        return self._reverse.get(index)

    @property
    def size(self) -> int:
        return len(self._forward)

    @property
    def has_intercept(self) -> bool:
        return INTERCEPT_KEY in self._forward

    @property
    def intercept_index(self) -> int | None:
        idx = self._forward.get(INTERCEPT_KEY)
        return idx

    # Construction -----------------------------------------------------------
    @classmethod
    def from_keys(cls, keys: Iterable[str], *, add_intercept: bool = False) -> "IndexMap":
        """Build from distinct feature keys, sorted for determinism
        (reference DefaultIndexMapLoader sorts distinct keys)."""
        distinct = sorted(set(keys))
        mapping = {k: i for i, k in enumerate(distinct)}
        if add_intercept and INTERCEPT_KEY not in mapping:
            mapping[INTERCEPT_KEY] = len(mapping)
        return cls(mapping)

    @classmethod
    def from_name_terms(cls, pairs: Iterable[tuple[str, str]], *,
                        add_intercept: bool = False) -> "IndexMap":
        """:meth:`from_keys` over (name, term) pairs."""
        return cls.from_keys((feature_key(n, t) for n, t in pairs), add_intercept=add_intercept)

    # Persistence ------------------------------------------------------------
    @staticmethod
    def list_directory(directory: str | os.PathLike) -> set[str]:
        """Shard names present in a stores directory, from filenames alone —
        no store is opened (cheap existence/coverage validation)."""
        from photon_ml_torch.io.offheap_index_map import META_SUFFIX
        from photon_ml_torch.io.paldb import PARTITION_RE

        shards: set[str] = set()
        for fname in os.listdir(str(directory)):
            if fname.endswith(".keys"):
                shards.add(fname[: -len(".keys")])
            elif fname.endswith(".identity.json"):
                shards.add(fname[: -len(".identity.json")])
            elif fname.endswith(META_SUFFIX):
                shards.add(fname[: -len(META_SUFFIX)])
            elif m := PARTITION_RE.match(fname):
                shards.add(m.group("ns"))
        return shards

    @staticmethod
    def load_directory(directory: str | os.PathLike) -> dict[str, "IndexMap"]:
        """Load every index map in a directory: plain ``<shard>.keys`` files,
        ``<shard>.identity.json`` markers, partitioned off-heap stores
        (``<shard>.photonix.json``, an ``OffHeapIndexMap``) and reference
        PalDB stores (``paldb-partition-<shard>-<i>.dat``, read into an
        ``IndexMap``). Returns shard id -> Mapping."""
        from photon_ml_torch.io.offheap_index_map import META_SUFFIX, OffHeapIndexMap
        from photon_ml_torch.io.paldb import PARTITION_RE, load_paldb_index_map

        maps: dict[str, IndexMap] = {}
        directory = str(directory)
        for fname in sorted(os.listdir(directory)):
            if fname.endswith(".identity.json"):
                shard = fname[: -len(".identity.json")]
                if shard not in maps:
                    with open(os.path.join(directory, fname)) as f:
                        meta = json.load(f)
                    maps[shard] = IdentityIndexMap(
                        meta["dim"], intercept_index=meta.get("intercept_index")
                    )
            elif fname.endswith(".keys"):
                shard = fname[: -len(".keys")]
                if shard not in maps:
                    maps[shard] = IndexMap.load(directory, shard)
            elif fname.endswith(META_SUFFIX):
                shard = fname[: -len(META_SUFFIX)]
                if shard not in maps:
                    maps[shard] = OffHeapIndexMap(directory, shard)
            elif m := PARTITION_RE.match(fname):
                shard = m.group("ns")
                if shard not in maps:
                    maps[shard] = load_paldb_index_map(directory, shard)
        return maps

    def save(self, directory: str | os.PathLike, name: str = "index") -> str:
        """Write ``<name>.keys`` (one key per line, index order) +
        ``<name>.meta.json``. Keys may contain the \\u0001 delimiter; lines
        are the unit, so keys must not contain newlines."""
        os.makedirs(directory, exist_ok=True)
        ordered = sorted(self._forward.items(), key=lambda kv: kv[1])
        expected = list(range(len(ordered)))
        if [i for _, i in ordered] != expected:
            raise ValueError("index map indices must be dense 0..n-1 to save")
        keys_path = os.path.join(directory, f"{name}.keys")
        with open(keys_path, "w", encoding="utf-8") as f:
            for k, _ in ordered:
                f.write(k + "\n")
        with open(os.path.join(directory, f"{name}.meta.json"), "w") as f:
            json.dump({"size": len(ordered), "format": "photon-ml-tpu/index/v1"}, f)
        return keys_path

    @classmethod
    def load(cls, directory: str | os.PathLike, name: str = "index") -> "IndexMap":
        keys_path = os.path.join(directory, f"{name}.keys")
        with open(keys_path, encoding="utf-8") as f:
            mapping = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return cls(mapping)


class IdentityIndexMap(IndexMap):
    """An O(1) virtual map for PRE-INDEXED feature spaces: key "<j>" (term
    empty, with or without the delimiter) maps to integer j for
    0 <= j < dim; nothing is materialized (reference
    IdentityIndexMapLoader, used when data carries numeric feature ids).

    This is how a literal d=10⁹ coordinate flows through the product path
    (config -> reader -> estimator): the reference sizes its feature space
    by name-term maps (off-heap PalDB at production scale), which caps any
    in-test dimension at the number of DISTINCT OBSERVED names; pre-indexed
    data (LibSVM integer columns, hashing-trick features) needs no such
    materialization. Iteration is refused above a size guard — callers that
    enumerate entries (feature-stats writers) must special-case this type.
    """

    _ITER_GUARD = 1 << 20

    def __init__(self, dim: int, *, intercept_index: int | None = None):
        # deliberately NOT calling super().__init__: no dict exists
        self._dim = int(dim)
        self._intercept = intercept_index

    def __getitem__(self, key: str) -> int:
        idx = self.get_index(key)
        if idx < 0:
            raise KeyError(key)
        return idx

    def __iter__(self):
        if self._dim > self._ITER_GUARD:
            raise RuntimeError(
                f"refusing to enumerate a {self._dim}-entry IdentityIndexMap "
                "(pre-indexed giant-d space); handle this map by index"
            )
        return (feature_key(str(i), "") for i in range(self._dim))

    def __len__(self) -> int:
        return self._dim

    def get_index(self, key: str) -> int:
        if self._intercept is not None and key == INTERCEPT_KEY:
            return self._intercept
        name, term = split_feature_key(key)
        if term:
            return -1
        try:
            j = int(name)
        except ValueError:
            return -1
        return j if 0 <= j < self._dim else -1

    def get_feature_name(self, index: int) -> str | None:
        if self._intercept is not None and index == self._intercept:
            return INTERCEPT_KEY
        if 0 <= index < self._dim:
            return feature_key(str(index), "")
        return None

    @property
    def size(self) -> int:
        return self._dim

    @property
    def has_intercept(self) -> bool:
        return self._intercept is not None

    @property
    def intercept_index(self) -> int | None:
        return self._intercept

    def save(self, directory: str | os.PathLike, name: str = "index") -> str:
        """Persist as a tiny ``<name>.identity.json`` marker (dim only) —
        no key material exists to write."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{name}.identity.json")
        with open(path, "w") as f:
            json.dump({
                "dim": self._dim, "intercept_index": self._intercept,
                "format": "photon-ml-tpu/identity-index/v1",
            }, f)
        return path
