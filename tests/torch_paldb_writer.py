"""A test-only writer of PalDB V1 index stores, the format read by
``photon_ml_tpu/io/paldb.py`` and ``photon_ml_torch/io/paldb.py`` (the header
layout and serializer type tags documented at the top of either module).

Each partition holds both directions of its features, ``name\\u0001term ->
local index`` and ``local index -> name\\u0001term``; a feature's global
index is its local index plus the sizes of the partitions before it.
"""

from __future__ import annotations

import os
import struct


def _longpacker(value: int) -> bytes:
    """7 bits a byte, least-significant group first, 0x80 = continuation."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize(value) -> bytes:
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return b"\x67" + _longpacker(len(raw)) + raw
    if 0 <= value <= 8:
        return bytes([0x05 + value])
    if value <= 254:
        return bytes([0x0E, value])
    return b"\x10" + _longpacker(value)


def write_partition(path: str | os.PathLike, names: list[str], *, timestamp: int = 0) -> None:
    """One store file whose features are ``names`` at local indices 0..n-1."""
    pairs = [(serialize(name), serialize(i)) for i, name in enumerate(names)]
    pairs += [(serialize(i), serialize(name)) for i, name in enumerate(names)]
    groups: dict[int, list[tuple[bytes, bytes]]] = {}
    for key, value in pairs:
        groups.setdefault(len(key), []).append((key, value))
    index = bytearray()
    data = bytearray()
    meta = []
    for key_len in sorted(groups):
        members = groups[key_len]
        blob = bytearray(b"\x00")  # the group's leading guard byte
        offsets = []
        for _, value in members:
            offsets.append(len(blob))
            blob += _longpacker(len(value)) + value
        slot_size = key_len + max(len(_longpacker(o)) for o in offsets)
        slots = max(2 * len(members), 1)
        table = bytearray(slots * slot_size)
        for (key, _), offset in zip(members, offsets):
            s = int.from_bytes(key, "big") % slots
            while any(table[s * slot_size:(s + 1) * slot_size]):
                s = (s + 1) % slots
            entry = key + _longpacker(offset)
            table[s * slot_size: s * slot_size + len(entry)] = entry
        meta.append((key_len, len(members), slots, slot_size, len(index), len(data)))
        index += table
        data += blob
    magic = b"PALDB_V1"
    header = bytearray(struct.pack(">H", len(magic)) + magic + struct.pack(">q", timestamp))
    header += struct.pack(">iii", len(pairs), len(groups), max(groups, default=0))
    for key_len, count, slots, slot_size, index_off, data_off in meta:
        header += struct.pack(">iiiii", key_len, count, slots, slot_size, index_off)
        header += struct.pack(">q", data_off)
    index_start = len(header) + 16
    header += struct.pack(">qq", index_start, index_start + len(index))
    with open(path, "wb") as f:
        f.write(bytes(header) + bytes(index) + bytes(data))


def write_store(directory: str | os.PathLike, namespace: str,
                partitions: list[list[str]]) -> list[str]:
    """``paldb-partition-<namespace>-<i>.dat`` for each partition's names."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, names in enumerate(partitions):
        path = os.path.join(str(directory), f"paldb-partition-{namespace}-{i}.dat")
        write_partition(path, names)
        paths.append(path)
    return paths
