"""Minimal, dependency-free Apache Avro implementation (the port's own copy).

Counterpart of ``photon_ml_tpu/io/avro.py``: the same codec, byte for byte
(block sizes, the default sync marker, the codecs), so a file written by
either package reads in the other and the same records give the same file.
Quarantined blocks are counted in this module (``quarantined_blocks``).

The environment ships no Avro library (no fastavro / no avro-python3), and
the reference's entire data contract is Avro (photon-avro-schemas/*.avsc,
photon-client data/avro/AvroDataReader.scala, AvroUtils.scala). This module
implements the parts of the Avro 1.x specification the framework needs:

- binary encoding: zig-zag varint long/int, IEEE float/double, length-
  prefixed bytes/string, arrays, maps, unions, records, enums, fixed;
- object container files: magic ``Obj\\x01``, file-metadata map with
  ``avro.schema`` / ``avro.codec``, 16-byte sync marker, data blocks of
  (record count, byte size, payload, sync); codecs ``null`` and ``deflate``.

Records are plain Python dicts; schemas are the JSON-derived dict form.
This is a from-scratch implementation of the public Avro spec — no code
from the reference (which uses the Java Avro library via Spark).

Corrupt-input quarantine (``on_corrupt="quarantine"``): the container
readers can validate every block's framing (length bounds + trailing sync
marker) and full decode, SKIP corrupt blocks — resynchronizing on the next
16-byte sync marker, the recovery the Avro spec designed the marker for —
and count the quarantined spans (``quarantined_blocks`` below). Strict
raise stays the default.
"""

from __future__ import annotations

import io as _io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Iterable, Iterator


#: spans skipped by ``on_corrupt="quarantine"`` reads in this process:
#: (path, block index, start byte, end byte, reason)
quarantined_blocks: list[tuple] = []


def _record_quarantined_block(path: str, block_index: int, start: int, end: int,
                              reason: str) -> None:
    from photon_ml_torch.telemetry import resilience_counters

    quarantined_blocks.append((path, block_index, start, end, reason))
    resilience_counters.record_quarantined_block(path, block_index, start, end, reason)

MAGIC = b"Obj\x01"
DEFAULT_SYNC = bytes(range(16))

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes", "string"}


class AvroError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Schema handling
# ---------------------------------------------------------------------------


class SchemaRegistry:
    """Resolves named-type references within one schema document."""

    def __init__(self):
        self.named: dict[str, dict] = {}

    def register(self, schema: dict):
        name = schema.get("name")
        if name:
            ns = schema.get("namespace")
            full = f"{ns}.{name}" if ns and "." not in name else name
            self.named[full] = schema
            self.named[name] = schema

    def resolve(self, schema: Any) -> Any:
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            if schema not in self.named:
                raise AvroError(f"unknown named type {schema!r}")
            return self.named[schema]
        return schema


def parse_schema(schema: Any) -> tuple[Any, SchemaRegistry]:
    """Parse a schema (dict / JSON string), collecting named types."""
    if isinstance(schema, str) and (schema.startswith("{") or schema.startswith("[")):
        schema = json.loads(schema)
    registry = SchemaRegistry()

    def walk(s: Any):
        if isinstance(s, dict):
            t = s.get("type")
            if t in ("record", "enum", "fixed"):
                registry.register(s)
            if t == "record":
                for f in s["fields"]:
                    walk(f["type"])
            elif t == "array":
                walk(s["items"])
            elif t == "map":
                walk(s["values"])
            elif isinstance(t, (dict, list)):
                walk(t)
        elif isinstance(s, list):
            for branch in s:
                walk(branch)

    walk(schema)
    return schema, registry


def _schema_type(schema: Any) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    t = schema["type"]
    if isinstance(t, (dict, list)):
        return _schema_type(t)
    return t


# ---------------------------------------------------------------------------
# Binary encoding
# ---------------------------------------------------------------------------


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(out: BinaryIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


def read_long(inp: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        raw = inp.read(1)
        if not raw:
            raise EOFError("unexpected end of Avro data")
        b = raw[0]
        acc |= (b & 0x7F) << shift
        if not (b & 0x80):
            return _zigzag_decode(acc)
        shift += 7
        if shift > 70:
            raise AvroError("varint too long")


class BinaryEncoder:
    def __init__(self, out: BinaryIO, registry: SchemaRegistry):
        self.out = out
        self.registry = registry

    def write(self, schema: Any, datum: Any) -> None:
        schema = self.registry.resolve(schema)
        t = _schema_type(schema)
        out = self.out
        if t == "null":
            if datum is not None:
                raise AvroError(f"expected null, got {datum!r}")
        elif t == "boolean":
            out.write(b"\x01" if datum else b"\x00")
        elif t in ("int", "long"):
            write_long(out, int(datum))
        elif t == "float":
            out.write(struct.pack("<f", float(datum)))
        elif t == "double":
            out.write(struct.pack("<d", float(datum)))
        elif t == "bytes":
            write_long(out, len(datum))
            out.write(datum)
        elif t == "string":
            raw = datum.encode("utf-8") if isinstance(datum, str) else bytes(datum)
            write_long(out, len(raw))
            out.write(raw)
        elif t == "fixed":
            if len(datum) != schema["size"]:
                raise AvroError("fixed size mismatch")
            out.write(datum)
        elif t == "enum":
            write_long(out, schema["symbols"].index(datum))
        elif t == "array":
            if datum:
                write_long(out, len(datum))
                for item in datum:
                    self.write(schema["items"], item)
            write_long(out, 0)
        elif t == "map":
            if datum:
                write_long(out, len(datum))
                for k, v in datum.items():
                    self.write("string", k)
                    self.write(schema["values"], v)
            write_long(out, 0)
        elif t == "union":
            idx = self._union_branch(schema, datum)
            write_long(out, idx)
            self.write(schema[idx], datum)
        elif t == "record":
            for field in schema["fields"]:
                name = field["name"]
                if name in datum:
                    value = datum[name]
                elif "default" in field:
                    value = field["default"]
                else:
                    raise AvroError(f"missing field {name!r} for {schema['name']}")
                self.write(field["type"], value)
        else:
            raise AvroError(f"unsupported schema type {t!r}")

    def _union_branch(self, union: list, datum: Any) -> int:
        for i, branch in enumerate(union):
            bt = _schema_type(self.registry.resolve(branch))
            if datum is None and bt == "null":
                return i
            if datum is not None and bt != "null":
                if bt == "boolean" and not isinstance(datum, bool):
                    continue
                if bt in ("int", "long") and not isinstance(datum, int):
                    continue
                if bt in ("float", "double") and not isinstance(datum, (int, float)):
                    continue
                if bt in ("string", "enum") and not isinstance(datum, str):
                    continue
                if bt in ("bytes", "fixed") and not isinstance(datum, (bytes, bytearray)):
                    continue
                if bt == "array" and not isinstance(datum, (list, tuple)):
                    continue
                if bt in ("map", "record") and not isinstance(datum, dict):
                    continue
                return i
        raise AvroError(f"datum {datum!r} matches no union branch {union}")


class BinaryDecoder:
    def __init__(self, inp: BinaryIO, registry: SchemaRegistry):
        self.inp = inp
        self.registry = registry

    def read(self, schema: Any) -> Any:
        schema = self.registry.resolve(schema)
        t = _schema_type(schema)
        inp = self.inp
        if t == "null":
            return None
        if t == "boolean":
            return inp.read(1) == b"\x01"
        if t in ("int", "long"):
            return read_long(inp)
        if t == "float":
            return struct.unpack("<f", inp.read(4))[0]
        if t == "double":
            return struct.unpack("<d", inp.read(8))[0]
        if t == "bytes":
            return inp.read(read_long(inp))
        if t == "string":
            return inp.read(read_long(inp)).decode("utf-8")
        if t == "fixed":
            return inp.read(schema["size"])
        if t == "enum":
            return schema["symbols"][read_long(inp)]
        if t == "array":
            items = []
            while True:
                count = read_long(inp)
                if count == 0:
                    return items
                if count < 0:  # block with byte size
                    count = -count
                    read_long(inp)
                for _ in range(count):
                    items.append(self.read(schema["items"]))
        if t == "map":
            result: dict[str, Any] = {}
            while True:
                count = read_long(inp)
                if count == 0:
                    return result
                if count < 0:
                    count = -count
                    read_long(inp)
                for _ in range(count):
                    key = self.read("string")
                    result[key] = self.read(schema["values"])
        if t == "union":
            return self.read(schema[read_long(inp)])
        if t == "record":
            return {f["name"]: self.read(f["type"]) for f in schema["fields"]}
        raise AvroError(f"unsupported schema type {t!r}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------

_META_SCHEMA = {"type": "map", "values": "bytes"}


def write_container(
    path: str | os.PathLike,
    schema: Any,
    records: Iterable[dict],
    *,
    codec: str = "deflate",
    block_records: int = 4096,
    sync: bytes = DEFAULT_SYNC,
) -> int:
    """Write an Avro object container file; returns the record count."""
    schema, registry = parse_schema(schema)
    meta_registry = SchemaRegistry()
    count = 0
    with open(path, "wb") as out:
        out.write(MAGIC)
        meta_enc = BinaryEncoder(out, meta_registry)
        meta_enc.write(
            _META_SCHEMA,
            {
                "avro.schema": json.dumps(schema).encode("utf-8"),
                "avro.codec": codec.encode("utf-8"),
            },
        )
        out.write(sync)

        buf = _io.BytesIO()
        enc = BinaryEncoder(buf, registry)
        in_block = 0

        def flush():
            nonlocal in_block
            if in_block == 0:
                return
            payload = buf.getvalue()
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate per spec
            elif codec != "null":
                raise AvroError(f"unsupported codec {codec!r}")
            write_long(out, in_block)
            write_long(out, len(payload))
            out.write(payload)
            out.write(sync)
            buf.seek(0)
            buf.truncate()
            in_block = 0

        for record in records:
            enc.write(schema, record)
            in_block += 1
            count += 1
            if in_block >= block_records:
                flush()
        flush()
    return count


def write_container_blocks(
    path: str | os.PathLike,
    schema: Any,
    blocks: "Iterable[tuple[int, bytes]]",
    *,
    codec: str = "deflate",
    sync: bytes = DEFAULT_SYNC,
) -> int:
    """Container framing over PRE-ENCODED record blocks ((count, payload)
    pairs of already-Avro-binary records) — the fast-writer entry point
    (vectorized encoders build payloads as numpy byte buffers; this adds
    the standard header/codec/sync framing)."""
    schema, _ = parse_schema(schema)
    count = 0
    with open(path, "wb") as out:
        out.write(MAGIC)
        BinaryEncoder(out, SchemaRegistry()).write(
            _META_SCHEMA,
            {
                "avro.schema": json.dumps(schema).encode("utf-8"),
                "avro.codec": codec.encode("utf-8"),
            },
        )
        out.write(sync)
        for n_records, payload in blocks:
            if n_records == 0:
                continue
            if codec == "deflate":
                # level 1: these payloads are mostly f64 noise where higher
                # levels buy little and cost ~3x the CPU
                payload = zlib.compress(payload, 1)[2:-4]  # raw deflate
            elif codec != "null":
                raise AvroError(f"unsupported codec {codec!r}")
            write_long(out, n_records)
            write_long(out, len(payload))
            out.write(payload)
            out.write(sync)
            count += n_records
    return count


def _check_on_corrupt(on_corrupt: str) -> None:
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(
            f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}"
        )


def read_container(
    path: str | os.PathLike, *, on_corrupt: str = "raise"
) -> Iterator[dict]:
    """Iterate records of an Avro object container file.

    on_corrupt: "raise" (default — strict, byte-identical to the original
    reader) or "quarantine" (skip corrupt blocks, resync on the sync
    marker, count+journal each skipped span; a block either decodes fully
    or contributes nothing)."""
    _check_on_corrupt(on_corrupt)
    if on_corrupt == "quarantine":
        yield from _read_container_quarantine(path)
        return
    with open(path, "rb") as inp:
        if inp.read(4) != MAGIC:
            raise AvroError(f"{path}: not an Avro container file")
        meta = BinaryDecoder(inp, SchemaRegistry()).read(_META_SCHEMA)
        schema, registry = parse_schema(meta["avro.schema"].decode("utf-8"))
        codec = meta.get("avro.codec", b"null").decode("utf-8")
        sync = inp.read(16)
        while True:
            try:
                n_records = read_long(inp)
            except EOFError:
                return
            size = read_long(inp)
            payload = inp.read(size)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif codec != "null":
                raise AvroError(f"unsupported codec {codec!r}")
            dec = BinaryDecoder(_io.BytesIO(payload), registry)
            for _ in range(n_records):
                yield dec.read(schema)
            if inp.read(16) != sync:
                raise AvroError(f"{path}: sync marker mismatch")


#: framing sanity bound: one block's record count / payload size can never
#: exceed the file size (a corrupt varint otherwise "allocates" petabytes)
def _plausible(n: int, limit: int) -> bool:
    return 0 <= n <= limit


def _resync(inp: BinaryIO, sync: bytes, start: int) -> int | None:
    """Scan forward from ``start`` for the next occurrence of the 16-byte
    sync marker; return the offset just AFTER it (the next block's start),
    or None when no further marker exists. Chunked with a 15-byte overlap
    so markers spanning chunk boundaries are found."""
    chunk = 1 << 16
    inp.seek(start)
    tail = b""
    while True:
        pos = inp.tell()
        data = inp.read(chunk)
        if not data:
            return None
        buf = tail + data
        hit = buf.find(sync)
        if hit >= 0:
            return pos - len(tail) + hit + 16
        tail = buf[-15:]


def _read_header(inp: BinaryIO, path) -> tuple[Any, SchemaRegistry, str, bytes]:
    """(schema, registry, codec, sync) of an open container, or AvroError.
    Header corruption is not quarantinable — without the schema and sync
    marker nothing downstream can be decoded or resynced."""
    if inp.read(4) != MAGIC:
        raise AvroError(f"{path}: not an Avro container file")
    meta = BinaryDecoder(inp, SchemaRegistry()).read(_META_SCHEMA)
    schema, registry = parse_schema(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    sync = inp.read(16)
    if len(sync) != 16:
        raise AvroError(f"{path}: truncated container header")
    return schema, registry, codec, sync


def _read_container_quarantine(path: str | os.PathLike) -> Iterator[dict]:
    """The skip-and-count reader behind ``on_corrupt='quarantine'``.

    Per block: validate count/size bounds, read the full payload, verify
    the trailing sync marker, decompress, decode ALL records — and only
    then yield them. Any failure quarantines the whole block (partial
    blocks never leak half-decoded records), records the byte span via
    quarantined_blocks, and resyncs on the next sync marker."""
    file_size = os.path.getsize(path)
    with open(path, "rb") as inp:
        schema, registry, codec, sync = _read_header(inp, path)
        if codec not in ("null", "deflate"):
            raise AvroError(f"{path}: unsupported codec {codec!r}")
        block_index = 0
        while True:
            block_start = inp.tell()
            if block_start >= file_size:
                return
            records: list[dict] = []
            try:
                n_records = read_long(inp)
                size = read_long(inp)
                if not _plausible(n_records, file_size) or not _plausible(
                    size, file_size - inp.tell()
                ):
                    raise AvroError(
                        f"implausible block framing (count={n_records}, "
                        f"size={size})"
                    )
                payload = inp.read(size)
                if len(payload) != size:
                    raise AvroError("truncated block payload")
                trailer = inp.read(16)
                if trailer != sync:
                    raise AvroError("sync marker mismatch")
                if codec == "deflate":
                    payload = zlib.decompress(payload, -15)
                buf = _io.BytesIO(payload)
                dec = BinaryDecoder(buf, registry)
                for _ in range(n_records):
                    records.append(dec.read(schema))
                if buf.read(1):
                    raise AvroError("trailing bytes after last record")
            # clean EOF returns before the try (block_start >= file_size),
            # so an EOFError here is corruption — a truncated tail or a
            # payload whose decode ran off its end — never end-of-data
            except (AvroError, EOFError, zlib.error, struct.error,
                    ValueError, IndexError, KeyError,
                    UnicodeDecodeError) as e:
                nxt = _resync(inp, sync, block_start + 1)
                end = file_size if nxt is None else nxt
                _record_quarantined_block(
                    str(path), block_index, block_start, end,
                    f"{type(e).__name__}: {e}",
                )
                block_index += 1
                if nxt is None:
                    return
                inp.seek(nxt)
                continue
            block_index += 1
            yield from records


def validate_container(
    path: str | os.PathLike,
) -> list[tuple[int, int, int, str]]:
    """Framing-only corruption scan: [(block_index, byte_start, byte_end,
    reason), ...] — empty means every block's length bounds and trailing
    sync marker check out. Cost is the header decode + one seek and a
    16-byte read per block (never a payload read), so the native decode
    path can gate on it cheaply before trusting a file
    (io/data_reader._read_merged_avro_native under quarantine)."""
    problems: list[tuple[int, int, int, str]] = []
    file_size = os.path.getsize(path)
    with open(path, "rb") as inp:
        _, _, codec, sync = _read_header(inp, path)
        if codec not in ("null", "deflate"):
            raise AvroError(f"{path}: unsupported codec {codec!r}")
        block_index = 0
        while True:
            block_start = inp.tell()
            if block_start >= file_size:
                return problems
            try:
                n_records = read_long(inp)
                size = read_long(inp)
                if not _plausible(n_records, file_size) or not _plausible(
                    size, file_size - inp.tell()
                ):
                    raise AvroError(
                        f"implausible block framing (count={n_records}, "
                        f"size={size})"
                    )
                inp.seek(size, os.SEEK_CUR)
                trailer = inp.read(16)
                if trailer != sync:
                    raise AvroError("sync marker mismatch")
            except EOFError:
                if block_start >= file_size:
                    return problems
                problems.append(
                    (block_index, block_start, file_size,
                     "truncated final block")
                )
                return problems
            except AvroError as e:
                nxt = _resync(inp, sync, block_start + 1)
                end = file_size if nxt is None else nxt
                problems.append((block_index, block_start, end, str(e)))
                block_index += 1
                if nxt is None:
                    return problems
                inp.seek(nxt)
                continue
            block_index += 1


def scan_block_index(
    path: str | os.PathLike, *, on_corrupt: str = "raise"
) -> list[tuple[int, int, int]]:
    """The container's block index: [(record_count, payload_bytes,
    payload_offset), ...] — scanned by SEEKING past every payload, so the
    cost is header decode + one seek per block, not a data read. This is
    what makes block-level partitioned ingestion cheap to plan.

    on_corrupt="quarantine" additionally VALIDATES each block's framing
    (length bounds + trailing sync marker — a 16-byte read per block) and
    drops corrupt spans from the index, counting each in
    ``quarantined_blocks``; the default scan stays the seek-only fast path."""
    _check_on_corrupt(on_corrupt)
    if on_corrupt == "quarantine":
        return _scan_block_index_quarantine(path)
    blocks: list[tuple[int, int, int]] = []
    with open(path, "rb") as inp:
        if inp.read(4) != MAGIC:
            raise AvroError(f"{path}: not an Avro container file")
        BinaryDecoder(inp, SchemaRegistry()).read(_META_SCHEMA)
        inp.read(16)  # sync
        while True:
            try:
                n_records = read_long(inp)
            except EOFError:
                return blocks
            size = read_long(inp)
            blocks.append((n_records, size, inp.tell()))
            inp.seek(size + 16, os.SEEK_CUR)  # payload + sync


def _scan_block_index_quarantine(
    path: str | os.PathLike,
) -> list[tuple[int, int, int]]:
    """Framing-validated block index: corrupt spans are skipped and counted
    here, so a reader of the listed blocks only ever decodes framing-intact
    ones."""
    file_size = os.path.getsize(path)
    blocks: list[tuple[int, int, int]] = []
    with open(path, "rb") as inp:
        _, _, codec, sync = _read_header(inp, path)
        if codec not in ("null", "deflate"):
            raise AvroError(f"{path}: unsupported codec {codec!r}")
        block_index = 0
        while True:
            block_start = inp.tell()
            if block_start >= file_size:
                return blocks
            try:
                n_records = read_long(inp)
                size = read_long(inp)
                if not _plausible(n_records, file_size) or not _plausible(
                    size, file_size - inp.tell()
                ):
                    raise AvroError(
                        f"implausible block framing (count={n_records}, "
                        f"size={size})"
                    )
                payload_offset = inp.tell()
                inp.seek(size, os.SEEK_CUR)
                if inp.read(16) != sync:
                    raise AvroError("sync marker mismatch")
            except EOFError:
                if block_start >= file_size:
                    return blocks
                _record_quarantined_block(
                    str(path), block_index, block_start, file_size,
                    "truncated final block",
                )
                return blocks
            except AvroError as e:
                nxt = _resync(inp, sync, block_start + 1)
                end = file_size if nxt is None else nxt
                _record_quarantined_block(
                    str(path), block_index, block_start, end, str(e)
                )
                block_index += 1
                if nxt is None:
                    return blocks
                inp.seek(nxt)
                continue
            blocks.append((n_records, size, payload_offset))
            block_index += 1


def read_container_block_range(
    path: str | os.PathLike, start_block: int, num_blocks: int,
    index: "list[tuple[int, int, int]] | None" = None,
    *, on_corrupt: str = "raise",
) -> Iterator[dict]:
    """The records of blocks [start_block, start_block + num_blocks) only:
    a rank's block assignment in the partitioned reader's blocks mode. Seeks
    straight to each selected payload through the block index (``index``
    from a prior :func:`scan_block_index` skips the re-scan).

    on_corrupt="quarantine": a block whose payload fails to decompress or
    decode is skipped and counted (``quarantined_blocks``) instead of
    raising; framing corruption is the quarantining index scan's to skip, so
    pass an index scanned in the same mode."""
    _check_on_corrupt(on_corrupt)
    if num_blocks <= 0:
        return
    if index is None:
        index = scan_block_index(path, on_corrupt=on_corrupt)
    selected = index[start_block:start_block + num_blocks]
    if len(selected) != num_blocks:
        raise AvroError(
            f"{path}: block range [{start_block}, "
            f"{start_block + num_blocks}) exceeds {len(index)} blocks"
        )
    with open(path, "rb") as inp:
        inp.seek(4)
        meta = BinaryDecoder(inp, SchemaRegistry()).read(_META_SCHEMA)
        schema, registry = parse_schema(meta["avro.schema"].decode("utf-8"))
        codec = meta.get("avro.codec", b"null").decode("utf-8")
        for bi, (n_records, size, offset) in enumerate(selected):
            inp.seek(offset)
            payload = inp.read(size)
            if on_corrupt == "quarantine":
                records: list[dict] = []
                try:
                    if len(payload) != size:
                        raise AvroError("truncated block payload")
                    if codec == "deflate":
                        payload = zlib.decompress(payload, -15)
                    elif codec != "null":
                        raise AvroError(f"unsupported codec {codec!r}")
                    buf = _io.BytesIO(payload)
                    dec = BinaryDecoder(buf, registry)
                    for _ in range(n_records):
                        records.append(dec.read(schema))
                    if buf.read(1):
                        raise AvroError("trailing bytes after last record")
                except (AvroError, EOFError, zlib.error, struct.error,
                        ValueError, IndexError, KeyError,
                        UnicodeDecodeError) as e:
                    _record_quarantined_block(
                        str(path), start_block + bi, offset, offset + size,
                        f"{type(e).__name__}: {e}",
                    )
                    continue
                yield from records
                continue
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif codec != "null":
                raise AvroError(f"unsupported codec {codec!r}")
            dec = BinaryDecoder(_io.BytesIO(payload), registry)
            for _ in range(n_records):
                yield dec.read(schema)


def read_container_schema(path: str | os.PathLike) -> dict:
    with open(path, "rb") as inp:
        if inp.read(4) != MAGIC:
            raise AvroError(f"{path}: not an Avro container file")
        meta = BinaryDecoder(inp, SchemaRegistry()).read(_META_SCHEMA)
        return json.loads(meta["avro.schema"].decode("utf-8"))


def list_avro_files(path: str | os.PathLike) -> list[str]:
    """The ``*.avro`` part files of a directory (sorted, Spark/OS markers
    skipped), or the path itself when it is a file — the ONE part-file
    listing rule shared by every reader."""
    p = str(path)
    if os.path.isfile(p):
        return [p]
    names = sorted(
        f for f in os.listdir(p)
        if f.endswith(".avro") and not f.startswith(("_", "."))
    )
    if not names:
        raise AvroError(f"no .avro files under {p}")
    return [os.path.join(p, name) for name in names]


def read_directory(
    path: str | os.PathLike, *, on_corrupt: str = "raise"
) -> Iterator[dict]:
    """Read every ``*.avro`` file under a directory (the reference reads
    HDFS directories of part files, AvroUtils.scala readAvroFiles)."""
    for name in list_avro_files(path):
        yield from read_container(name, on_corrupt=on_corrupt)
