"""Read-only parser for PalDB stores (the reference's off-heap index maps;
the port's copy of ``photon_ml_tpu/io/paldb.py``).

Reference parity: photon-api index/PalDBIndexMap.scala:26-56 — production
Photon-ML feature index maps are hash-partitioned PalDB stores
(``paldb-partition-<namespace>-<i>.dat``), each holding BOTH directions:
``name\\u0001term -> int`` (local index) and ``int -> name\\u0001term``.
Global index = local index + offset, where partition i's offset is the
number of features in partitions < i (PalDBIndexMap.load:82-99).

PalDB itself is LinkedIn's JVM read-only key-value store. This module
implements a from-scratch reader for its V1 binary format so a migrating
user's existing stores load directly — no JVM required. Format (reverse-
engineered from the public fixtures; all integers big-endian):

    header:
      writeUTF("PALDB_V1")              2-byte length + bytes
      long   creation timestamp
      int    key count (both directions, so 2x the feature count)
      int    distinct serialized-key-length count
      int    max serialized-key length
      per distinct key length:
        int  key length   int key count   int slot count
        int  slot size    int index offset (into index section)
        long data offset  (into data section)
      long   index section start (absolute file offset)
      long   data section start  (absolute file offset)
    index section: per key length, an open-addressing hash table of
      fixed-size slots [serialized key | LongPacker data offset]; offset 0
      (and all-zero slots) = empty. Offsets are 1-based into the group's
      data region.
    data section: per group, a leading 0x00 guard byte then value blobs
      [LongPacker size | serialized value].

Value/key serialization (MapDB-style type bytes; every rule below is
verified against the 15k-feature GameIntegTest fixtures, which exercise
multi-byte varints):
    int 0..8   -> single byte 0x05 + value
    int 9..254 -> 0x0e, unsigned byte
    int 255+   -> 0x10, LongPacker varint
    string     -> 0x67, LongPacker BYTE count, then that many UTF-8 bytes
                  (all fixture keys are ASCII, where byte count == char
                  count; non-ASCII names are untested territory)
(The strings are full feature keys, name + "\\u0001" + term, so they map
1:1 onto io/index_map.feature_key.) LongPacker varints are 7 bits per
byte, least-significant group first, 0x80 = continuation.

Loading scans every slot once and materializes a plain dict — exactly what
a migration wants; no JVM hash probing is reproduced.
"""

from __future__ import annotations

import os
import re
import struct
from dataclasses import dataclass

from photon_ml_torch.io.index_map import IndexMap

_MAGIC = b"PALDB_V1"
_INT_SMALL_BASE = 0x05  # ints 0..8 inline
_INT_SMALL_MAX = 8
_INT_BYTE = 0x0E  # unsigned byte follows (ints 9..254)
_INT_PACKED = 0x10  # LongPacker varint follows (ints 255+)
_STRING = 0x67

PARTITION_RE = re.compile(r"^paldb-partition-(?P<ns>.+)-(?P<idx>\d+)\.dat$")


def _unpack_longpacker(buf: bytes, pos: int) -> tuple[int, int]:
    """PalDB LongPacker varint: 7 bits per byte, LEAST-significant group
    first, 0x80 = continuation (protobuf-style; verified against multi-byte
    offsets in the reference GameIntegTest stores). Returns (value, pos)."""
    value = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, pos
        shift += 7


def _deserialize(buf: bytes, pos: int, end: int):
    """One serialized key/value in [pos, end); returns the Python value."""
    t = buf[pos]
    if _INT_SMALL_BASE <= t <= _INT_SMALL_BASE + _INT_SMALL_MAX:
        return t - _INT_SMALL_BASE
    if t == _INT_BYTE:
        if pos + 1 >= end:
            raise ValueError(
                f"corrupt PalDB blob at offset {pos}: INT_BYTE payload "
                "overruns its region"
            )
        return buf[pos + 1]
    if t == _INT_PACKED:
        value, p = _unpack_longpacker(buf, pos + 1)
        if p > end:
            raise ValueError(
                f"corrupt PalDB blob at offset {pos}: packed int of "
                f"{p - pos - 1} bytes overruns its {end - pos}-byte region"
            )
        return value
    if t == _STRING:
        n, p = _unpack_longpacker(buf, pos + 1)
        if p + n > end:
            raise ValueError(
                f"corrupt PalDB blob at offset {pos}: string of {n} bytes "
                f"overruns its {end - pos}-byte region"
            )
        return buf[p : p + n].decode("utf-8")
    raise ValueError(
        f"unsupported PalDB serialization type byte 0x{t:02x} at offset "
        f"{pos} (photon index stores hold only ints and strings; rebuild "
        "the map with feature_indexing_driver if the store uses an "
        "encoding these fixtures never exercised)"
    )


@dataclass
class PalDBPartition:
    """Parsed contents of one paldb-partition-*.dat file."""

    name_to_local: dict[str, int]
    local_to_name: dict[int, str]

    @property
    def size(self) -> int:
        return len(self.name_to_local)


def read_partition(path: str | os.PathLike) -> PalDBPartition:
    """Parse one PalDB store file into its two direction maps."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    n = struct.unpack_from(">H", buf, pos)[0]
    pos += 2
    if buf[pos : pos + n] != _MAGIC:
        raise ValueError(
            f"{path}: not a PalDB V1 store (magic {buf[pos:pos+n]!r})"
        )
    pos += n + 8  # magic + timestamp
    key_count, length_count, _max_len = struct.unpack_from(">iii", buf, pos)
    pos += 12
    groups = []
    for _ in range(length_count):
        key_len, cnt, slots, slot_size, index_off = struct.unpack_from(
            ">iiiii", buf, pos
        )
        pos += 20
        (data_off,) = struct.unpack_from(">q", buf, pos)
        pos += 8
        groups.append((key_len, cnt, slots, slot_size, index_off, data_off))
    index_start, data_start = struct.unpack_from(">qq", buf, pos)

    name_to_local: dict[str, int] = {}
    local_to_name: dict[int, str] = {}
    found = 0
    for key_len, cnt, slots, slot_size, index_off, data_off in groups:
        base = index_start + index_off
        for s in range(slots):
            slot_pos = base + s * slot_size
            slot = buf[slot_pos : slot_pos + slot_size]
            if not any(slot):
                continue
            offset, _ = _unpack_longpacker(slot, key_len)
            if offset == 0:
                continue
            key = _deserialize(slot, 0, key_len)
            blob_pos = data_start + data_off + offset
            size, p = _unpack_longpacker(buf, blob_pos)
            value = _deserialize(buf, p, p + size)
            found += 1
            if isinstance(key, str):
                name_to_local[key] = int(value)
            else:
                local_to_name[int(key)] = str(value)
    if found != key_count:
        raise ValueError(
            f"{path}: slot scan found {found} entries, header says {key_count}"
        )
    if len(name_to_local) != len(local_to_name):
        raise ValueError(
            f"{path}: direction maps disagree "
            f"({len(name_to_local)} names vs {len(local_to_name)} indices)"
        )
    for name, local in name_to_local.items():
        if local_to_name.get(local) != name:
            raise ValueError(
                f"{path}: inconsistent store — '{name}' -> {local} but "
                f"{local} -> {local_to_name.get(local)!r}"
            )
    return PalDBPartition(name_to_local=name_to_local, local_to_name=local_to_name)


def discover_stores(directory: str | os.PathLike) -> dict[str, dict[int, str]]:
    """namespace -> {partition index: file path}, for every PalDB store in
    the directory (reference partitionFilename naming).

    Partition-set validation happens per namespace at LOAD time, not here —
    one unrelated broken store must not block loading a healthy one."""
    directory = str(directory)
    found: dict[str, dict[int, str]] = {}
    for fname in os.listdir(directory):
        m = PARTITION_RE.match(fname)
        if m:
            found.setdefault(m.group("ns"), {})[int(m.group("idx"))] = os.path.join(
                directory, fname
            )
    return found


def load_paldb_index_map(
    directory: str | os.PathLike, namespace: str
) -> IndexMap:
    """Load a partitioned PalDB index store as a plain IndexMap.

    Global index = partition-local index + offset, offsets being the
    cumulative feature counts of preceding partitions — the reference's
    offset arithmetic (PalDBIndexMap.load:82-99, getIndex:145-155).
    """
    stores = discover_stores(directory)
    if namespace not in stores:
        raise FileNotFoundError(
            f"no PalDB store for namespace '{namespace}' in {directory} "
            f"(found: {sorted(stores) or 'none'})"
        )
    parts = stores[namespace]
    if set(parts) != set(range(len(parts))):
        raise ValueError(
            f"PalDB store '{namespace}' in {directory} has partitions "
            f"{sorted(parts)}; expected contiguous 0..{len(parts) - 1}"
        )
    mapping: dict[str, int] = {}
    offset = 0
    for path in (parts[i] for i in range(len(parts))):
        part = read_partition(path)
        for name, local in part.name_to_local.items():
            mapping[name] = local + offset
        offset += part.size
    if sorted(mapping.values()) != list(range(len(mapping))):
        # gapped partition-local indices would silently alias two features
        # onto one global column under the offset arithmetic
        raise ValueError(
            f"PalDB store '{namespace}' in {directory} yields non-contiguous "
            "global indices — partition-local indices are gapped or "
            "duplicated (corrupt or truncated store)"
        )
    return IndexMap(mapping)
