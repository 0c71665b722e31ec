"""The port's native columnar Avro decoder (``photon_ml_torch/native/
avro_decoder.cpp`` through ``photon_ml_torch/io/avro_native.py``) on the CPU.

Every case of ``tests/test_avro_native.py``, and more: the port's native
read, the port's Python read (``PHOTON_NO_NATIVE_AVRO=1``) and the JAX
package's reader give equal datasets on the same files (dense, sparse,
hybrid and bf16 shards; nullable and map fields; deflate blocks; several
part files; prebuilt index maps); a schema outside the native subset reads
with the Python codec and is counted in ``avro_native.fallbacks``; corrupt
blocks under quarantine are skipped as the Python reader skips them; the
framing scans ``validate_container`` and ``scan_block_index`` equal the JAX
package's; and a decoder that does not build raises."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.data.sparse_batch import SparseShard as JSparseShard
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import data_reader as jreader
from photon_ml_torch import build
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io import avro_native as av
from photon_ml_torch.io import data_reader as treader
from photon_ml_torch.io import photon_schemas as schemas

SCHEMA = {
    "name": "NativeAvroTestRecord",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["string", "null"]},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": schemas.FEATURE_AVRO}},
        {"name": "otherBag", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "weight", "type": ["double", "null"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "intField", "type": "int"},
        {"name": "ignored",
         "type": {"type": "record", "name": "Nested", "fields": [
             {"name": "a", "type": "string"},
             {"name": "b", "type": {"type": "array", "items": "long"}},
         ]}},
        {"name": "metadataMap",
         "type": [{"type": "map", "values": ["string", "null"]}, "null"],
         "default": None},
    ],
}


def _records(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        feats = [{"name": f"f{int(j)}", "term": ["", "t1", "t2"][int(j) % 3],
                  "value": float(rng.normal())}
                 for j in rng.integers(0, 40, size=rng.integers(0, 6))]
        other = [{"name": f"o{int(j)}", "term": "", "value": float(rng.normal())}
                 for j in rng.integers(0, 10, size=2)]
        meta = None
        if i % 7 != 0:
            meta = {"userId": f"u{i % 9}", "queryId": f"q{i % 4}"}
            if i % 5 == 0:
                meta["nullv"] = None
        out.append({
            "uid": None if i % 11 == 0 else (str(i) if i % 3 else f"uid-{i}"),
            "label": float(rng.normal()),
            "features": feats,
            "otherBag": other,
            "weight": None if i % 6 == 0 else float(rng.uniform(0.5, 2)),
            "offset": None if i % 4 == 0 else float(rng.normal()),
            "intField": int(i),
            "ignored": {"a": "x" * (i % 3), "b": [int(i), 2]},
            "metadataMap": meta,
        })
    return out


@pytest.fixture(scope="module")
def avro_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("native_avro")
    recs = _records(300, 0)
    # two part files: the string tables are re-interned across parts
    tavro.write_container(base / "part-00000.avro", SCHEMA, recs[:170])
    tavro.write_container(base / "part-00001.avro", SCHEMA, recs[170:])
    return base


def _cfgs(module, **g):
    return {"g": module.FeatureShardConfiguration(feature_bags=("features",),
                                                  has_intercept=True, **g),
            "o": module.FeatureShardConfiguration(feature_bags=("otherBag", "features"),
                                                  has_intercept=False)}


def _three(path, monkeypatch, cfgs=None, jcfgs=None, **kw):
    """(port native, port Python, JAX) reads of ``path``; the port's native
    read must not fall back."""
    before = av.fallbacks
    native = treader.read_merged(path, cfgs or _cfgs(treader), device="cpu", **kw)
    assert av.fallbacks == before
    with monkeypatch.context() as m:
        m.setenv("PHOTON_NO_NATIVE_AVRO", "1")
        python = treader.read_merged(path, cfgs or _cfgs(treader), device="cpu", **kw)
    jkw = dict(kw)
    if "index_maps" in jkw:  # the JAX reader's own maps of the same data
        jkw["index_maps"] = jreader.read_merged(path, jcfgs or _cfgs(jreader)).index_maps
    ref = jreader.read_merged(path, jcfgs or _cfgs(jreader), **jkw)
    return native, python, ref


def _dense(shard, n, d):
    out = np.zeros((n, d))
    np.add.at(out, (np.asarray(shard.rows), np.asarray(shard.cols)),
              np.asarray(shard.vals, dtype=np.float64))
    return out


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(np.float32) if str(a.dtype) == "bfloat16" else a)


def _assert_equal(got, ref):
    """Every array of the two reads equal: labels, offsets, weights, uids,
    index maps, shards (a sparse shard's entries summed per cell: entry
    order may differ), entity vocabs and indices, id columns, intercepts."""
    dg, dr = got.dataset, ref.dataset
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(_host(getattr(dg, name)), _host(getattr(dr, name)))
    np.testing.assert_array_equal(dg.unique_ids, dr.unique_ids)
    assert {k: list(v) for k, v in got.index_maps.items()} == \
        {k: list(v) for k, v in ref.index_maps.items()}
    for k, v in dr.feature_shards.items():
        g = dg.feature_shards[k]
        if isinstance(v, (SparseShard, JSparseShard)):
            assert isinstance(g, SparseShard)
            shape = (v.num_samples, v.feature_dim)
            assert (g.num_samples, g.feature_dim) == shape
            np.testing.assert_array_equal(_dense(g, *shape), _dense(v, *shape))
        else:
            assert g.dtype == (torch.bfloat16 if str(v.dtype) == "bfloat16" else g.dtype)
            np.testing.assert_array_equal(_host(g), _host(v))
    assert set(dg.entity_vocabs) == set(dr.entity_vocabs)
    for t in dr.entity_vocabs:
        np.testing.assert_array_equal(dg.entity_vocabs[t], dr.entity_vocabs[t])
        np.testing.assert_array_equal(_host(dg.entity_idx[t]), _host(dr.entity_idx[t]))
    assert set(dg.ids) == set(dr.ids)
    for c, v in dr.ids.items():
        np.testing.assert_array_equal(dg.ids[c], v)
    assert got.intercept_indices == ref.intercept_indices


def _check(path, monkeypatch, **kw):
    native, python, ref = _three(path, monkeypatch, **kw)
    _assert_equal(native, python)
    _assert_equal(native, ref)
    return native


def test_dense_with_ids_nulls_and_maps(avro_dir, monkeypatch):
    got = _check(avro_dir, monkeypatch, random_effect_id_columns=("userId",),
                 evaluation_id_columns=("queryId",))
    assert got.dataset.num_samples == 300
    assert "" in set(got.dataset.entity_vocabs["userId"])  # rows without a metadataMap


@pytest.mark.parametrize("layout", ["sparse", "hybrid", "bf16"])
def test_sparse_hybrid_and_bf16_shards(avro_dir, monkeypatch, layout):
    g = {"sparse": dict(sparse=True), "hybrid": dict(sparse=True, hybrid=True, hybrid_hot_cols=4),
         "bf16": dict(dtype="bfloat16")}[layout]
    got = _check(avro_dir, monkeypatch, cfgs=_cfgs(treader, **g), jcfgs=_cfgs(jreader, **g),
                 random_effect_id_columns=("userId",))
    if layout == "hybrid":
        assert got.dataset.feature_shards["g"].hybrid_policy.hot_cols == 4


def test_prebuilt_index_maps(avro_dir, monkeypatch):
    base = treader.read_merged(avro_dir, _cfgs(treader), device="cpu")
    _check(avro_dir, monkeypatch, index_maps=base.index_maps)


def test_deflate_codec_and_single_file(tmp_path, monkeypatch):
    path = tmp_path / "z.avro"
    tavro.write_container(path, SCHEMA, _records(50, 3), codec="deflate", block_records=7)
    _check(tmp_path, monkeypatch, random_effect_id_columns=("userId",))
    _check(path, monkeypatch)


def test_several_paths_read_as_one(avro_dir, tmp_path, monkeypatch):
    tavro.write_container(tmp_path / "extra.avro", SCHEMA, _records(40, 9), codec="null")
    got = _check([avro_dir, tmp_path / "extra.avro"], monkeypatch,
                 random_effect_id_columns=("userId",))
    assert got.dataset.num_samples == 340


def test_single_branch_union():
    """A 1-branch union keeps its wire branch index."""
    schema = {"name": "OneUnion", "type": "record",
              "fields": [{"name": "label", "type": ["double"]}, {"name": "uid", "type": ["string"]}]}
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/u1.avro"
        tavro.write_container(path, schema, [{"label": 2.5, "uid": "a"},
                                             {"label": -1.0, "uid": "bb"}])
        cols = av.decode_columns(path)
    np.testing.assert_allclose(cols.num["label"], [2.5, -1.0])
    assert cols.str_tables["uid"] == ["a", "bb"]


def test_nullable_fields_take_the_native_path(avro_dir):
    """Null offsets, weights and uids are the common case: they decode
    natively (a null mask), with no fallback."""
    out = treader._read_merged_avro_native(
        [str(avro_dir)], _cfgs(treader), index_maps=None, random_effect_id_columns=("userId",),
        evaluation_id_columns=(), entity_vocabs=None, dtype=np.float32, device="cpu")
    assert out.dataset.num_samples == 300


def test_a_schema_outside_the_subset_falls_back_and_is_counted(tmp_path, monkeypatch):
    """An enum-typed id column has no native column: the read takes the
    Python codec, counts one fallback and equals the other readers."""
    schema = {"name": "EnumIds", "type": "record", "fields": [
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": schemas.FEATURE_AVRO}},
        {"name": "userId", "type": {"type": "enum", "name": "U", "symbols": ["a", "b", "c"]}}]}
    rng = np.random.default_rng(4)
    recs = [{"label": float(rng.normal()), "userId": "abc"[i % 3],
             "features": [{"name": f"f{i % 5}", "term": "", "value": 1.0}]} for i in range(30)]
    tavro.write_container(tmp_path / "e.avro", schema, recs)
    cfgs = {"g": treader.FeatureShardConfiguration(feature_bags=("features",))}
    jcfgs = {"g": jreader.FeatureShardConfiguration(feature_bags=("features",))}
    before = av.fallbacks
    got = treader.read_merged(tmp_path, cfgs, random_effect_id_columns=("userId",), device="cpu")
    assert av.fallbacks == before + 1
    _assert_equal(got, jreader.read_merged(tmp_path, jcfgs, random_effect_id_columns=("userId",)))
    assert list(got.dataset.entity_vocabs["userId"]) == ["a", "b", "c"]


@pytest.mark.parametrize("damage", ["payload", "sync"])
def test_corrupt_block_under_quarantine(tmp_path, monkeypatch, damage):
    """A damaged block (its payload, or its sync marker, which the framing
    scan catches first) is skipped as the Python quarantine reader skips it:
    the read falls back and counts, and equals the port's Python read and
    the JAX reader's; a strict read raises as the JAX reader's does."""
    path = tmp_path / "c.avro"
    tavro.write_container(path, SCHEMA, _records(60, 5), codec="null", block_records=20)
    blocks = tavro.scan_block_index(path)
    assert blocks == javro.scan_block_index(path) and len(blocks) == 3
    data = bytearray(path.read_bytes())
    # the first record's union index (the payload's first bytes), or the
    # block's trailing sync marker
    at = blocks[1][2] if damage == "payload" else blocks[1][2] + blocks[1][1]
    data[at:at + 8] = b"\xff" * 8
    path.write_bytes(bytes(data))
    problems = tavro.validate_container(path)
    assert problems == javro.validate_container(path)
    assert len(problems) == (1 if damage == "sync" else 0)
    assert tavro.scan_block_index(path, on_corrupt="quarantine") == \
        javro.scan_block_index(path, on_corrupt="quarantine")
    before, skipped = av.fallbacks, len(tavro.quarantined_blocks)
    got = treader.read_merged(path, _cfgs(treader), on_corrupt="quarantine",
                              random_effect_id_columns=("userId",), device="cpu")
    assert av.fallbacks == before + 1
    assert len(tavro.quarantined_blocks) > skipped
    assert 0 < got.dataset.num_samples < 60
    with monkeypatch.context() as m:
        m.setenv("PHOTON_NO_NATIVE_AVRO", "1")
        _assert_equal(got, treader.read_merged(path, _cfgs(treader), on_corrupt="quarantine",
                                               random_effect_id_columns=("userId",),
                                               device="cpu"))
    _assert_equal(got, jreader.read_merged(path, _cfgs(jreader), on_corrupt="quarantine",
                                           random_effect_id_columns=("userId",)))
    # a strict read raises what the JAX reader raises
    with pytest.raises(Exception) as ref:
        jreader.read_merged(path, _cfgs(jreader))
    with pytest.raises(Exception) as got_error:
        treader.read_merged(path, _cfgs(treader), device="cpu")
    assert type(got_error.value).__name__ == ref.type.__name__  # each package's AvroError


def test_framing_scans_of_a_clean_file_match(avro_dir):
    for f in sorted(avro_dir.iterdir()):
        assert tavro.validate_container(f) == [] == javro.validate_container(f)
        assert tavro.scan_block_index(f) == javro.scan_block_index(f)
    with pytest.raises(ValueError, match="on_corrupt"):
        tavro.scan_block_index(f, on_corrupt="skip")


def test_plan_compiler():
    plan = av.compile_plan(SCHEMA)
    assert set(plan.bag_fields) == {"features", "otherBag"}
    assert "metadataMap" in plan.map_fields
    assert "intField" in plan.num_fields and "uid" in plan.str_fields
    assert "ignored" in plan.all_fields
    # a 3-way union is skippable, not collectible: it still decodes
    weird = av.compile_plan({"name": "Weird", "type": "record", "fields": [
        {"name": "label", "type": "double"},
        {"name": "u3", "type": ["null", "string", "double"]}]})
    assert "u3" not in weird.str_fields
    from photon_ml_tpu.io import avro_native as jav

    for schema in (SCHEMA,):
        j = jav.compile_plan(schema)
        assert np.array_equal(plan.ops, j.ops) and plan.bag_fields == j.bag_fields
        assert plan.num_fields == j.num_fields and plan.str_fields == j.str_fields


def test_columns_shape(avro_dir):
    cols = av.decode_columns(sorted(avro_dir.iterdir())[0])
    assert cols.n == 170 and cols.num["label"].shape == (170,)
    rows, keys, vals = cols.bags["features"]
    assert rows.shape == keys.shape == vals.shape
    assert all("\x01" in k for k in cols.bag_tables["features"])


def test_a_failed_build_raises(avro_dir, tmp_path, monkeypatch):
    """A decoder source that does not compile raises RuntimeError with the
    compiler's output from ``read_merged``: no quiet fallback to the Python
    codec, no fallback counted."""
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "avro_decoder.cpp").write_text("int broken(\n")
    monkeypatch.setattr(build, "NATIVE", broken)
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_HOST_LOADED", {})
    before = av.fallbacks
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*avro_decoder.cpp"):
        treader.read_merged(avro_dir, _cfgs(treader), device="cpu")
    assert av.fallbacks == before
    # the Python codec is there when it is asked for
    monkeypatch.setenv("PHOTON_NO_NATIVE_AVRO", "1")
    assert treader.read_merged(avro_dir, _cfgs(treader), device="cpu").dataset.num_samples == 300


def test_zlib_linked_by_name_when_the_link_flag_fails(tmp_path, monkeypatch):
    """Where ``-lz`` finds no development link, the decoder links zlib by
    the library name ``ctypes.util.find_library`` gives."""
    import ctypes.util

    calls = []
    real_run = build.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        if "-lz" in cmd:
            return build.subprocess.CompletedProcess(cmd, 1, "", "cannot find -lz")
        return real_run(cmd, **kw)

    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_HOST_LOADED", {})
    zlib = ctypes.util.find_library("z")
    if zlib is None:
        pytest.skip("no zlib on this machine")
    lib = av.load_avro_library()
    assert lib is not None and len(calls) == 2 and f"-l:{zlib}" in calls[1]
