"""Off-heap (memory-mapped) feature index maps (the port's copy).

Counterpart of ``photon_ml_tpu/io/offheap_index_map.py``; reference
photon-api index/PalDBIndexMap.scala:26-56 and PalDBIndexMapBuilder, which
keep huge feature vocabularies out of the JVM heap in partitioned PalDB
stores. Here a native C++ mmap hash store (``native/offheap_store.cpp``,
built with ``g++`` at first use by ``photon_ml_torch.build.load_host``)
serves lookups with no Python object per key. A key's partition is
FNV-1a(key) % P and each partition stores the global index of its keys
beside it (``.idx``), so no offset arithmetic is needed.

The files are the JAX package's format byte for byte. A failed native build
raises with the compiler's output; the pure-Python mmap reader (``_PyStore``)
runs only when the caller asks for it (``force_python=True``).
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
from typing import Iterator, Mapping

import numpy as np

from photon_ml_torch.build import load_host
from photon_ml_torch.io.index_map import INTERCEPT_KEY, IndexMap

_MAGIC = b"PHOTONIX"
_HEADER = struct.Struct("<8sQQQQ")

#: file suffix of a store's metadata: ``<name>.photonix.json``
META_SUFFIX = ".photonix.json"


def _fnv1a(data: bytes) -> int:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


def _configure(lib: ctypes.CDLL) -> None:
    lib.om_build.restype = ctypes.c_int64
    lib.om_build.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
    lib.om_open.restype = ctypes.c_void_p
    lib.om_open.argtypes = [ctypes.c_char_p]
    lib.om_close.restype = None
    lib.om_close.argtypes = [ctypes.c_void_p]
    lib.om_size.restype = ctypes.c_int64
    lib.om_size.argtypes = [ctypes.c_void_p]
    lib.om_get.restype = ctypes.c_int64
    lib.om_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.om_key_at.restype = ctypes.c_int64
    lib.om_key_at.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                              ctypes.c_uint64]


def _library() -> ctypes.CDLL:
    return load_host("offheap_store", _configure)


class _PyStore:
    """Pure-Python reader of one photonix file (``force_python=True``)."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n, table_size, _blob = _HEADER.unpack_from(self._mm, 0)
        if magic != _MAGIC or version != 1:
            raise ValueError(f"{path} is not a photonix store")
        self.n = n
        self.table_size = table_size
        self._off_base = _HEADER.size
        self._table_base = self._off_base + 8 * (n + 1)
        self._blob_base = self._table_base + 8 * table_size

    def _offset(self, i: int) -> int:
        return struct.unpack_from("<Q", self._mm, self._off_base + 8 * i)[0]

    def _key_bytes(self, idx: int) -> bytes:
        start, end = self._offset(idx), self._offset(idx + 1)
        return self._mm[self._blob_base + start: self._blob_base + end]

    def get(self, key: bytes) -> int:
        mask = self.table_size - 1
        slot = _fnv1a(key) & mask
        while True:
            entry = struct.unpack_from("<Q", self._mm, self._table_base + 8 * slot)[0]
            if entry == 0:
                return -1
            idx = entry - 1
            if self._key_bytes(idx) == key:
                return idx
            slot = (slot + 1) & mask

    def key_at(self, idx: int) -> bytes | None:
        if 0 <= idx < self.n:
            return self._key_bytes(idx)
        return None

    def close(self):
        self._mm.close()
        self._f.close()


class _NativeStore:
    """ctypes wrapper over the C++ store."""

    def __init__(self, path: str):
        self._lib = _library()
        self._handle = self._lib.om_open(path.encode())
        if not self._handle:
            raise ValueError(f"cannot open photonix store at {path}")
        self.n = self._lib.om_size(self._handle)
        self._buf = ctypes.create_string_buffer(4096)

    def get(self, key: bytes) -> int:
        return self._lib.om_get(self._handle, key, len(key))

    def key_at(self, idx: int) -> bytes | None:
        length = self._lib.om_key_at(self._handle, idx, self._buf, len(self._buf))
        if length < 0:
            return None
        if length > len(self._buf):
            self._buf = ctypes.create_string_buffer(length)
            self._lib.om_key_at(self._handle, idx, self._buf, len(self._buf))
        return self._buf.raw[:length]

    def close(self):
        if self._handle:
            self._lib.om_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def build_offheap_store(directory: str | os.PathLike, index_map: Mapping[str, int], *,
                        num_partitions: int = 1, name: str = "index") -> list[str]:
    """Write an index map as ``num_partitions`` photonix files
    (``<name>.part-<p>.photonix`` with its ``.idx`` of global indices) and
    ``<name>.photonix.json``; returns the store paths. Keys go to partition
    FNV-1a(key) % P in global-index order."""
    if num_partitions < 1:
        raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
    os.makedirs(directory, exist_ok=True)
    ordered = sorted(index_map.items(), key=lambda kv: kv[1])
    if [i for _, i in ordered] != list(range(len(ordered))):
        raise ValueError("index map must be dense 0..n-1")
    partitions: list[list[tuple[bytes, int]]] = [[] for _ in range(num_partitions)]
    for key, idx in ordered:
        kb = key.encode("utf-8")
        partitions[_fnv1a(kb) % num_partitions].append((kb, idx))
    lib = _library()
    paths = []
    for p, members in enumerate(partitions):
        blob = b"".join(kb for kb, _ in members)
        offsets = np.zeros(len(members) + 1, dtype=np.uint64)
        np.cumsum([len(kb) for kb, _ in members], out=offsets[1:])
        path = os.path.join(str(directory), f"{name}.part-{p:05d}.photonix")
        off_arr = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        rc = lib.om_build(path.encode(), blob, off_arr, len(members))
        if rc != 0:
            raise RuntimeError(f"om_build failed with code {rc} for {path}")
        with open(path + ".idx", "wb") as f:
            f.write(np.asarray([idx for _, idx in members], dtype="<u8").tobytes())
        paths.append(path)
    with open(os.path.join(str(directory), f"{name}{META_SUFFIX}"), "w") as f:
        json.dump({"num_partitions": num_partitions, "size": len(ordered), "name": name}, f)
    return paths


class OffHeapIndexMap(Mapping[str, int]):
    """Index-map reader over partitioned photonix stores: ``get_index``,
    ``get_feature_name``, ``size`` and the intercept lookups of
    ``io.index_map.IndexMap`` by O(1) mmap probes, no Python object per key."""

    def __init__(self, directory: str | os.PathLike, name: str = "index", *,
                 force_python: bool = False):
        with open(os.path.join(str(directory), f"{name}{META_SUFFIX}")) as f:
            meta = json.load(f)
        self._size = meta["size"]
        self._num_partitions = meta["num_partitions"]
        self._stores = []
        #: per partition, the global index of each local slot (uint64)
        self._globals: list[np.ndarray] = []
        #: reverse index (global -> partition, local slot), built on first use
        self._rev_part: np.ndarray | None = None
        self._rev_local: np.ndarray | None = None
        store_cls = _PyStore if force_python else _NativeStore
        for p in range(self._num_partitions):
            path = os.path.join(str(directory), f"{name}.part-{p:05d}.photonix")
            self._stores.append(store_cls(path))
            with open(path + ".idx", "rb") as f:
                self._globals.append(np.frombuffer(f.read(), dtype="<u8"))

    # Reference API ----------------------------------------------------------
    def get_index(self, key: str) -> int:
        kb = key.encode("utf-8")
        p = _fnv1a(kb) % self._num_partitions
        local = self._stores[p].get(kb)
        return -1 if local < 0 else int(self._globals[p][local])

    def get_feature_name(self, index: int) -> str | None:
        if not 0 <= index < self._size:
            return None
        if self._rev_part is None:
            self._rev_part = np.zeros(self._size, dtype=np.int32)
            self._rev_local = np.zeros(self._size, dtype=np.int64)
            for p, globals_arr in enumerate(self._globals):
                g = globals_arr.astype(np.int64)
                self._rev_part[g] = p
                self._rev_local[g] = np.arange(len(g), dtype=np.int64)
        p = int(self._rev_part[index])
        kb = self._stores[p].key_at(int(self._rev_local[index]))
        return None if kb is None else kb.decode("utf-8")

    @property
    def size(self) -> int:
        return self._size

    @property
    def has_intercept(self) -> bool:
        return self.get_index(INTERCEPT_KEY) >= 0

    @property
    def intercept_index(self) -> int | None:
        idx = self.get_index(INTERCEPT_KEY)
        return None if idx < 0 else idx

    def close(self) -> None:
        for store in self._stores:
            store.close()

    # Mapping protocol -------------------------------------------------------
    def __getitem__(self, key: str) -> int:
        idx = self.get_index(key)
        if idx < 0:
            raise KeyError(key)
        return idx

    def __len__(self) -> int:
        return self._size

    def __iter__(self) -> Iterator[str]:
        for index in range(self._size):
            name = self.get_feature_name(index)
            if name is not None:
                yield name

    @classmethod
    def build(cls, directory: str | os.PathLike, index_map: Mapping[str, int] | IndexMap, *,
              num_partitions: int = 1, name: str = "index") -> "OffHeapIndexMap":
        build_offheap_store(directory, index_map, num_partitions=num_partitions, name=name)
        return cls(directory, name)
