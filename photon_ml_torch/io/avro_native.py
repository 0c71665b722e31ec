"""Columnar Avro decode via the native C++ decoder (the port's copy).

Counterpart of ``photon_ml_tpu/io/avro_native.py``. The pure-Python reader
(io/avro.py) decodes records one dict at a time, a bottleneck for
production-scale ingestion (the reference reads Avro through JVM-compiled
decoders inside Spark executors, photon-client
data/avro/AvroDataReader.scala). This module compiles the container's
writer schema into a PLAN (a prefix-serialized op tree), hands it to
``photon_ml_torch/native/avro_decoder.cpp`` (built by
``photon_ml_torch.build.load_host``), and gets back columns:

    numeric top-level fields -> float64 arrays (NaN for null branches)
    string  top-level fields -> interned uint32 ids + a unique-string table
    feature bags             -> (row, key_id, value) + "name\\x01term" table
    string maps              -> (row, key_id, value_id) + two tables

Strings are interned in C++; Python only materializes the UNIQUE tables.
Schema shapes outside the supported subset raise
:class:`AvroNativeUnsupported`, and the reader falls back to the Python
codec for that read and counts it in :data:`fallbacks`; a decoder that does
not build raises. Both paths are held equal by tests/test_torch_avro_native.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np

from photon_ml_torch.build import load_host
from photon_ml_torch.io.avro import AvroError, parse_schema, read_container_schema

#: reads that left the native decoder for the Python codec in this process
#: (a schema or value outside the native subset, or a corrupt block under
#: quarantine); ``io/data_reader.read_merged`` counts them
fallbacks = 0

# op codes — must match native/avro_decoder.cpp
OP_RECORD, OP_UNION, OP_ARRAY, OP_MAP = 1, 2, 3, 4
OP_NULL, OP_BOOL, OP_INT, OP_LONG = 5, 6, 7, 8
OP_FLOAT, OP_DOUBLE, OP_STRING, OP_BYTES, OP_FIXED = 9, 10, 11, 12, 13
OP_COL_DOUBLE, OP_COL_FLOAT, OP_COL_INT, OP_COL_LONG, OP_COL_BOOL = (
    20, 21, 22, 23, 24,
)
OP_COL_NULLNUM, OP_COL_STR, OP_COL_NULLSTR = 25, 26, 27
OP_MAP_COLLECT, OP_MAPVAL_STR, OP_MAPVAL_NULL = 28, 29, 30
OP_BAG, OP_BAG_NAME, OP_BAG_TERM, OP_BAG_TERM_NULL, OP_BAG_VALUE = (
    31, 32, 33, 34, 35,
)
OP_COL_STRNUM, OP_COL_LONGSTR, OP_COL_BOOLSTR = 36, 37, 38
OP_MAPVAL_LONGSTR, OP_MAPVAL_BOOLSTR, OP_MAPVAL_BAD = 39, 40, 41

NULL_ID = 0xFFFFFFFF


def _configure(lib: ctypes.CDLL) -> None:
    lib.avdec_open.restype = ctypes.c_void_p
    lib.avdec_open.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.avdec_num_records.restype = ctypes.c_int64
    lib.avdec_num_records.argtypes = [ctypes.c_void_p]
    u32p = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint32))
    f64p = ctypes.POINTER(ctypes.POINTER(ctypes.c_double))
    chp = ctypes.POINTER(ctypes.c_char_p)
    u64pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.avdec_numcol.restype = ctypes.c_int64
    lib.avdec_numcol.argtypes = [ctypes.c_void_p, ctypes.c_int64, f64p,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.avdec_strcol.restype = ctypes.c_int64
    lib.avdec_strcol.argtypes = [ctypes.c_void_p, ctypes.c_int64, u32p, chp, u64pp, u64p]
    lib.avdec_bag.restype = ctypes.c_int64
    lib.avdec_bag.argtypes = [ctypes.c_void_p, ctypes.c_int64, u32p, u32p, f64p, chp, u64pp,
                              u64p]
    lib.avdec_map.restype = ctypes.c_int64
    lib.avdec_map.argtypes = [ctypes.c_void_p, ctypes.c_int64, u32p, u32p, u32p,
                              chp, u64pp, u64p, chp, u64pp, u64p]
    lib.avdec_free.restype = None
    lib.avdec_free.argtypes = [ctypes.c_void_p]


def load_avro_library() -> ctypes.CDLL:
    """The decoder library, built on first use (raises if it does not build)."""
    return load_host("avro_decoder", _configure)

_NUM_KINDS = {"double": 0, "float": 1, "int": 2, "long": 2, "boolean": 3}
_SKIP_OPS = {
    "null": OP_NULL, "boolean": OP_BOOL, "int": OP_INT, "long": OP_LONG,
    "float": OP_FLOAT, "double": OP_DOUBLE, "string": OP_STRING,
    "bytes": OP_BYTES,
}


class AvroNativeUnsupported(AvroError):
    """Schema shape outside the native decoder's subset — use the Python
    reader instead."""


@dataclasses.dataclass
class AvroPlan:
    ops: np.ndarray  # int64 prefix tree
    num_fields: dict[str, int]  # field name -> numeric slot
    str_fields: dict[str, int]
    bag_fields: dict[str, int]
    map_fields: dict[str, int]
    #: every top-level field name (callers detect "requested bag exists in
    #: the schema but was NOT bag-shaped" and fall back)
    all_fields: frozenset[str] = frozenset()
    #: numeric fields whose schema admits float/double/boolean values —
    #: their f64 columns cannot reproduce Python's str() rendering, so they
    #: must not serve as id-column fallbacks (callers fall back instead)
    unfaithful_id_fields: frozenset[str] = frozenset()
    #: numeric fields with a string branch (OP_COL_STRNUM): a NaN may mean
    #: "unparseable string" (where Python raises) rather than null — callers
    #: must fall back on NaN instead of applying defaults
    strnum_fields: frozenset[str] = frozenset()
    #: numeric fields with a null branch: their NaNs are (usually) the null
    #: sentinel, but a genuine NaN double is indistinguishable — callers
    #: fall back when NaNs appear so Python applies its exact semantics
    nullable_num_fields: frozenset[str] = frozenset()

    def same_semantics(self, other: "AvroPlan") -> bool:
        return (
            np.array_equal(self.ops, other.ops)
            and self.num_fields == other.num_fields
            and self.str_fields == other.str_fields
            and self.bag_fields == other.bag_fields
            and self.map_fields == other.map_fields
            and self.all_fields == other.all_fields
            and self.unfaithful_id_fields == other.unfaithful_id_fields
            and self.strnum_fields == other.strnum_fields
            and self.nullable_num_fields == other.nullable_num_fields
        )


def _tname(schema) -> str:
    if isinstance(schema, str):
        return schema
    if isinstance(schema, list):
        return "union"
    return schema.get("type", "")


def _compile_skip(schema, registry, out: list[int], depth: int = 0) -> None:
    """Ops that decode-and-discard an arbitrary (supported) type."""
    if depth > 16:
        raise AvroNativeUnsupported("schema nesting too deep")
    schema = registry.resolve(schema)
    t = _tname(schema)
    if t in _SKIP_OPS:
        out.append(_SKIP_OPS[t])
    elif isinstance(schema, list):
        out.append(OP_UNION)
        out.append(len(schema))
        for branch in schema:
            _compile_skip(branch, registry, out, depth + 1)
    elif t == "record":
        out.append(OP_RECORD)
        out.append(len(schema["fields"]))
        for f in schema["fields"]:
            _compile_skip(f["type"], registry, out, depth + 1)
    elif t == "array":
        out.append(OP_ARRAY)
        _compile_skip(schema["items"], registry, out, depth + 1)
    elif t == "map":
        out.append(OP_MAP)
        _compile_skip(schema["values"], registry, out, depth + 1)
    elif t == "enum":
        out.append(OP_INT)
    elif t == "fixed":
        out.append(OP_FIXED)
        out.append(int(schema["size"]))
    else:
        raise AvroNativeUnsupported(f"cannot skip schema type {t!r}")


def _nullable(schema) -> tuple[bool, int, object]:
    """(is 2-union with null, null branch index, the other branch)."""
    if isinstance(schema, list) and len(schema) == 2:
        names = [_tname(b) for b in schema]
        if "null" in names:
            ni = names.index("null")
            return True, ni, schema[1 - ni]
    return False, -1, None


def _compile_bag_item(item, registry, out: list[int]) -> bool:
    """Emit the OP_BAG item-record node if `item` looks like a feature
    record (name [+term] + numeric value); False if not bag-shaped."""
    item = registry.resolve(item)
    if _tname(item) != "record":
        return False
    fields = item["fields"]
    names = {f["name"] for f in fields}
    if "name" not in names or "value" not in names:
        return False
    probe: list[int] = []
    probe.append(OP_RECORD)
    probe.append(len(fields))
    for f in fields:
        ft = registry.resolve(f["type"])
        nullable, ni, inner = _nullable(ft)
        if f["name"] == "name":
            if _tname(ft) != "string":
                return False
            probe.append(OP_BAG_NAME)
        elif f["name"] == "term":
            if _tname(ft) == "string":
                probe.append(OP_BAG_TERM)
            elif nullable and _tname(registry.resolve(inner)) == "string":
                probe.append(OP_UNION)
                probe.append(2)
                for b in range(2):
                    probe.append(OP_BAG_TERM_NULL if b == ni else OP_BAG_TERM)
            else:
                return False
        elif f["name"] == "value":
            t = _tname(ft)
            if t in _NUM_KINDS:
                probe.append(OP_BAG_VALUE)
                probe.append(_NUM_KINDS[t])
            elif nullable and _tname(registry.resolve(inner)) in _NUM_KINDS:
                # nullable value: null contributes 0.0 (python float(None)
                # would raise; refuse instead of diverging)
                return False
            else:
                return False
        else:
            _compile_skip(ft, registry, probe)
    out.extend(probe)
    return True


def compile_plan(schema: dict) -> AvroPlan:
    """Compile a top-level record schema into the decoder plan."""
    top, registry = parse_schema(schema)
    top = registry.resolve(top)
    if _tname(top) != "record":
        raise AvroNativeUnsupported("top-level schema is not a record")
    ops: list[int] = [OP_RECORD, len(top["fields"])]
    num_fields: dict[str, int] = {}
    str_fields: dict[str, int] = {}
    bag_fields: dict[str, int] = {}
    map_fields: dict[str, int] = {}

    unfaithful: set[str] = set()
    strnum_fields: set[str] = set()
    nullable_num: set[str] = set()

    def scalar_branches(ft) -> list | None:
        """The union branch list when every branch is a scalar (or the
        1-element list for a bare scalar); None otherwise. ``bytes`` is
        excluded: Python renders bytes via repr (b'...'), which the native
        tables cannot reproduce — such fields stay skip-only."""
        branches = ft if isinstance(ft, list) else [ft]
        names = [_tname(registry.resolve(b)) for b in branches]
        ok = {"null", "boolean", "int", "long", "float", "double", "string"}
        if all(nm in ok for nm in names):
            return [registry.resolve(b) for b in branches]
        return None

    # rendering op per branch type, numeric-column vs string-column modes
    NUM_BRANCH = {
        "double": OP_COL_DOUBLE, "float": OP_COL_FLOAT, "int": OP_COL_INT,
        "long": OP_COL_LONG, "boolean": OP_COL_BOOL, "null": OP_COL_NULLNUM,
        # numeric strings parse (python float(label) does the same); junk
        # strings become NaN and callers fall back
        "string": OP_COL_STRNUM,
    }
    STR_BRANCH = {
        "string": OP_COL_STR, "null": OP_COL_NULLSTR,
        "int": OP_COL_LONGSTR, "long": OP_COL_LONGSTR,
        "boolean": OP_COL_BOOLSTR,
    }

    for f in top["fields"]:
        name = f["name"]
        ft = registry.resolve(f["type"])
        t = _tname(ft)
        nullable, ni, inner = _nullable(ft)
        inner_res = registry.resolve(inner) if nullable else None
        scalars = scalar_branches(ft)
        if scalars is not None:
            names = [_tname(b) for b in scalars]
            # floats force a numeric column (f64 is what Python's float()
            # produces anyway); otherwise a string or LONG branch makes it a
            # string column — longs render as exact decimals in C++ (an f64
            # column would corrupt snowflake-scale ids past 2^53, where the
            # Python reader is exact)
            if any(nm in ("float", "double") for nm in names):
                slot = len(num_fields)
                num_fields[name] = slot
                table = NUM_BRANCH
                unfaithful.add(name)
                if "string" in names:
                    strnum_fields.add(name)
                if "null" in names:
                    nullable_num.add(name)
            elif any(nm in ("string", "long") for nm in names):
                slot = len(str_fields)
                str_fields[name] = slot
                table = STR_BRANCH
            else:  # null / boolean / int only — exact in f64
                slot = len(num_fields)
                num_fields[name] = slot
                table = NUM_BRANCH
                if "boolean" in names:
                    unfaithful.add(name)
                if "null" in names:
                    nullable_num.add(name)
            # a union stays a union on the wire even with ONE branch (the
            # branch-index varint is still encoded — seen in the
            # reference's own bad-weights fixtures, label: ["double"])
            if isinstance(ft, list):
                ops += [OP_UNION, len(scalars)]
                for nm in names:
                    ops += [table[nm], slot]
            else:
                ops += [table[names[0]], slot]
        elif t == "array" or (nullable and _tname(inner_res) == "array"):
            arr = ft if t == "array" else inner_res
            probe: list[int] = []
            slot = len(bag_fields)
            probe += [OP_BAG, slot]
            if _compile_bag_item(arr["items"], registry, probe):
                bag_fields[name] = slot
                if nullable:
                    ops += [OP_UNION, 2]
                    for b in range(2):
                        if b == ni:
                            ops.append(OP_NULL)
                        else:
                            ops += probe
                else:
                    ops += probe
            else:
                # not a feature bag: decode-and-discard
                sk: list[int] = []
                _compile_skip(f["type"], registry, sk)
                ops += sk
        elif t == "map" or (nullable and _tname(inner_res) == "map"):
            mp = ft if t == "map" else inner_res
            values = registry.resolve(mp["values"])
            MV = {
                "string": OP_MAPVAL_STR,
                "null": OP_MAPVAL_NULL,
                "int": OP_MAPVAL_LONGSTR, "long": OP_MAPVAL_LONGSTR,
                "boolean": OP_MAPVAL_BOOLSTR,
                # float/double values can't reproduce Python's str()
                # rendering — decoded files that actually CONTAIN one fail
                # at runtime and the caller falls back
                "float": OP_MAPVAL_BAD, "double": OP_MAPVAL_BAD,
            }
            vbranches = values if isinstance(values, list) else [values]
            vnames = [_tname(registry.resolve(b)) for b in vbranches]
            collect: list[int] | None = None
            if all(nm in MV for nm in vnames):
                if isinstance(values, list):  # unions of ANY arity keep
                    collect = [OP_UNION, len(vbranches)]  # their branch index
                    for nm in vnames:
                        collect.append(MV[nm])
                else:
                    collect = [MV[vnames[0]]]
            if collect is not None:
                slot = len(map_fields)
                map_fields[name] = slot
                body = [OP_MAP_COLLECT, slot] + collect
            else:
                body = []
                _compile_skip(mp, registry, body)
            if nullable:
                ops += [OP_UNION, 2]
                for b in range(2):
                    if b == ni:
                        ops.append(OP_NULL)
                    else:
                        ops += body
            else:
                ops += body
        else:
            sk = []
            _compile_skip(f["type"], registry, sk)
            ops += sk

    return AvroPlan(
        ops=np.asarray(ops, dtype=np.int64),
        num_fields=num_fields,
        str_fields=str_fields,
        bag_fields=bag_fields,
        map_fields=map_fields,
        all_fields=frozenset(f["name"] for f in top["fields"]),
        unfaithful_id_fields=frozenset(unfaithful),
        strnum_fields=frozenset(strnum_fields),
        nullable_num_fields=frozenset(nullable_num),
    )


def _table(blob: bytes, offsets: np.ndarray) -> list[str]:
    try:
        return [
            blob[offsets[i]:offsets[i + 1]].decode("utf-8")
            for i in range(len(offsets) - 1)
        ]
    except UnicodeDecodeError as e:
        # the Python reader raises on invalid UTF-8 — it is authoritative
        raise AvroNativeUnsupported(f"invalid UTF-8 in string table: {e}")


@dataclasses.dataclass
class AvroColumns:
    """Columnar decode of one container file (or a concatenation)."""

    n: int
    num: dict[str, np.ndarray]  # field -> [n] float64
    num_null: dict[str, np.ndarray]  # field -> [n] bool, True where null
    str_ids: dict[str, np.ndarray]  # field -> [n] uint32 (NULL_ID = null)
    str_tables: dict[str, list[str]]
    bags: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]  # rows, keys, vals
    bag_tables: dict[str, list[str]]  # "name\x01term" keys
    maps: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]  # rows, kid, vid
    map_key_tables: dict[str, list[str]]
    map_val_tables: dict[str, list[str]]


def decode_columns(path: str | os.PathLike, plan: AvroPlan | None = None) -> AvroColumns:
    """Decode one container file through the native decoder."""
    if plan is None:
        plan = compile_plan(read_container_schema(path))
    lib = load_avro_library()
    err = ctypes.create_string_buffer(512)
    ops = np.ascontiguousarray(plan.ops, dtype=np.int64)
    handle = lib.avdec_open(
        os.fsencode(str(path)),
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ops),
        len(plan.num_fields), len(plan.str_fields),
        len(plan.bag_fields), len(plan.map_fields),
        err, ctypes.c_uint64(len(err)),
    )
    if not handle:
        raise AvroError(f"{path}: native decode failed: {err.value.decode()}")
    try:
        n = int(lib.avdec_num_records(handle))

        def np_copy(ptr, count, dtype):
            if count == 0 or not ptr:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)

        num, num_null = {}, {}
        for name, slot in plan.num_fields.items():
            dp = ctypes.POINTER(ctypes.c_double)()
            mp = ctypes.POINTER(ctypes.c_uint8)()
            cnt = lib.avdec_numcol(handle, slot, ctypes.byref(dp),
                                   ctypes.byref(mp))
            col = np_copy(dp, cnt, np.float64)
            if cnt != n:
                raise AvroError(f"{path}: field '{name}' count {cnt} != {n}")
            num[name] = col
            num_null[name] = np_copy(mp, cnt, np.uint8).astype(bool)
        str_ids, str_tables = {}, {}
        for name, slot in plan.str_fields.items():
            ip = ctypes.POINTER(ctypes.c_uint32)()
            bp = ctypes.c_char_p()
            op = ctypes.POINTER(ctypes.c_uint64)()
            tn = ctypes.c_uint64()
            cnt = lib.avdec_strcol(
                handle, slot, ctypes.byref(ip), ctypes.byref(bp),
                ctypes.byref(op), ctypes.byref(tn),
            )
            if cnt != n:
                raise AvroError(f"{path}: field '{name}' count {cnt} != {n}")
            offs = np_copy(op, tn.value + 1, np.uint64)
            blob = ctypes.string_at(bp, int(offs[-1])) if tn.value else b""
            str_ids[name] = np_copy(ip, cnt, np.uint32)
            str_tables[name] = _table(blob, offs)
        bags, bag_tables = {}, {}
        for name, slot in plan.bag_fields.items():
            rp = ctypes.POINTER(ctypes.c_uint32)()
            kp = ctypes.POINTER(ctypes.c_uint32)()
            vp = ctypes.POINTER(ctypes.c_double)()
            bp = ctypes.c_char_p()
            op = ctypes.POINTER(ctypes.c_uint64)()
            tn = ctypes.c_uint64()
            cnt = lib.avdec_bag(
                handle, slot, ctypes.byref(rp), ctypes.byref(kp),
                ctypes.byref(vp), ctypes.byref(bp), ctypes.byref(op),
                ctypes.byref(tn),
            )
            offs = np_copy(op, tn.value + 1, np.uint64)
            blob = ctypes.string_at(bp, int(offs[-1])) if tn.value else b""
            bags[name] = (
                np_copy(rp, cnt, np.uint32),
                np_copy(kp, cnt, np.uint32),
                np_copy(vp, cnt, np.float64),
            )
            bag_tables[name] = _table(blob, offs)
        maps, mk_tables, mv_tables = {}, {}, {}
        for name, slot in plan.map_fields.items():
            rp = ctypes.POINTER(ctypes.c_uint32)()
            kp = ctypes.POINTER(ctypes.c_uint32)()
            vp = ctypes.POINTER(ctypes.c_uint32)()
            kb = ctypes.c_char_p()
            ko = ctypes.POINTER(ctypes.c_uint64)()
            kn = ctypes.c_uint64()
            vb = ctypes.c_char_p()
            vo = ctypes.POINTER(ctypes.c_uint64)()
            vn = ctypes.c_uint64()
            cnt = lib.avdec_map(
                handle, slot, ctypes.byref(rp), ctypes.byref(kp),
                ctypes.byref(vp), ctypes.byref(kb), ctypes.byref(ko),
                ctypes.byref(kn), ctypes.byref(vb), ctypes.byref(vo),
                ctypes.byref(vn),
            )
            koffs = np_copy(ko, kn.value + 1, np.uint64)
            voffs = np_copy(vo, vn.value + 1, np.uint64)
            maps[name] = (
                np_copy(rp, cnt, np.uint32),
                np_copy(kp, cnt, np.uint32),
                np_copy(vp, cnt, np.uint32),
            )
            mk_tables[name] = _table(
                ctypes.string_at(kb, int(koffs[-1])) if kn.value else b"", koffs
            )
            mv_tables[name] = _table(
                ctypes.string_at(vb, int(voffs[-1])) if vn.value else b"", voffs
            )
        return AvroColumns(
            n=n, num=num, num_null=num_null, str_ids=str_ids,
            str_tables=str_tables, bags=bags, bag_tables=bag_tables,
            maps=maps, map_key_tables=mk_tables, map_val_tables=mv_tables,
        )
    finally:
        lib.avdec_free(handle)


def concat_columns(parts: list[AvroColumns]) -> AvroColumns:
    """Concatenate per-file columns, re-interning tables globally."""
    if len(parts) == 1:
        return parts[0]
    n = sum(p.n for p in parts)
    field_sets = [
        set(parts[0].num), set(parts[0].str_ids), set(parts[0].bags),
        set(parts[0].maps),
    ]
    for p in parts[1:]:
        if [set(p.num), set(p.str_ids), set(p.bags), set(p.maps)] != field_sets:
            raise AvroNativeUnsupported(
                "part files disagree on schema fields"
            )

    def merge_tables(tables: list[list[str]]):
        global_ids: dict[str, int] = {}
        remaps = []
        for t in tables:
            remap = np.zeros(len(t) + 1, dtype=np.uint32)
            for i, s in enumerate(t):
                remap[i] = global_ids.setdefault(s, len(global_ids))
            remaps.append(remap)
        return list(global_ids), remaps

    num = {
        k: np.concatenate([p.num[k] for p in parts]) for k in parts[0].num
    }
    num_null = {
        k: np.concatenate([p.num_null[k] for p in parts])
        for k in parts[0].num_null
    }
    str_ids, str_tables = {}, {}
    for k in parts[0].str_ids:
        table, remaps = merge_tables([p.str_tables[k] for p in parts])
        cols = []
        for p, remap in zip(parts, remaps):
            ids = p.str_ids[k]
            out = np.where(ids == NULL_ID, NULL_ID, remap[np.minimum(ids, len(remap) - 1)])
            cols.append(out.astype(np.uint32))
        str_ids[k] = np.concatenate(cols)
        str_tables[k] = table
    bags, bag_tables = {}, {}
    row_offsets = np.cumsum([0] + [p.n for p in parts])
    for k in parts[0].bags:
        table, remaps = merge_tables([p.bag_tables[k] for p in parts])
        rows, keys, vals = [], [], []
        for p, remap, off in zip(parts, remaps, row_offsets):
            r, kk, v = p.bags[k]
            rows.append(r.astype(np.int64) + off)
            keys.append(remap[kk])
            vals.append(v)
        bags[k] = (
            np.concatenate(rows), np.concatenate(keys), np.concatenate(vals)
        )
        bag_tables[k] = table
    maps, mk_tables, mv_tables = {}, {}, {}
    for k in parts[0].maps:
        ktable, kremaps = merge_tables([p.map_key_tables[k] for p in parts])
        vtable, vremaps = merge_tables([p.map_val_tables[k] for p in parts])
        rows, kids, vids = [], [], []
        for p, kr, vr, off in zip(parts, kremaps, vremaps, row_offsets):
            r, ki, vi = p.maps[k]
            rows.append(r.astype(np.int64) + off)
            kids.append(kr[ki])
            vids.append(
                np.where(vi == NULL_ID, NULL_ID,
                         vr[np.minimum(vi, len(vr) - 1)]).astype(np.uint32)
            )
        maps[k] = (
            np.concatenate(rows), np.concatenate(kids), np.concatenate(vids)
        )
        mk_tables[k] = ktable
        mv_tables[k] = vtable
    return AvroColumns(
        n=n, num=num, num_null=num_null, str_ids=str_ids,
        str_tables=str_tables, bags=bags, bag_tables=bag_tables, maps=maps,
        map_key_tables=mk_tables, map_val_tables=mv_tables,
    )


__all__ = [
    "AvroColumns", "AvroNativeUnsupported", "AvroPlan", "compile_plan", "concat_columns",
    "decode_columns", "load_avro_library", "NULL_ID",
]
