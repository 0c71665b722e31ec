"""The port's sparse, hybrid and pre-indexed readers and its LibSVM input,
held against the JAX package on the CPU.

Avro records are written with the JAX package's writer and read by both
packages (the JAX reader on its pure-Python path, ``PHOTON_NO_NATIVE_AVRO=1``):
the same COO triples, coalesced triples, index maps, intercepts and hybrid
policies. LibSVM text written here is read by both: the same records, CSR
arrays, datasets and errors.
"""

import os

import numpy as np
import pytest

from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import data_reader as jreader
from photon_ml_tpu.io import libsvm_native as jlibsvm
from photon_ml_tpu.io import photon_schemas as jschemas
from photon_ml_torch.data.sparse_batch import SparseShard as TShard
from photon_ml_torch.io import data_reader as treader
from photon_ml_torch.io import index_map as tindex
from photon_ml_torch.io import libsvm as tlibsvm

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

SCHEMA = {
    "name": "BagsTrainingExampleAvro", "type": "record",
    "fields": [
        {"name": "uid", "type": ["string", "null"]},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": jschemas.FEATURE_AVRO}},
        {"name": "extra", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "weight", "type": ["double", "null"], "default": None},
        {"name": "offset", "type": ["double", "null"], "default": None},
        {"name": "metadataMap", "type": [{"type": "map", "values": "string"}, "null"],
         "default": None},
    ],
}


def bag_records(n: int, seed: int, d: int = 5000) -> list[dict]:
    """Name-term bags over a power-law column space (repeated features in a
    row add up), a second bag sharing some names, user ids."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        cols = ((rng.random(rng.integers(1, 12)) ** 6 * d).astype(np.int64) * 7919) % d
        extra = rng.integers(0, 40, size=rng.integers(0, 3))
        records.append({
            "uid": str(1000 + i), "label": float(rng.normal()),
            "features": [{"name": "w", "term": str(c), "value": float(rng.normal())}
                         for c in cols],
            "extra": [{"name": "w" if j % 2 else "x", "term": str(j), "value": 1.0}
                      for j in extra],
            "weight": float(rng.uniform(0.5, 1.5)), "offset": float(0.1 * rng.normal()),
            "metadataMap": {"userId": f"u{rng.integers(0, 30)}"}})
    return records


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    base = tmp_path_factory.mktemp("bags")
    for split, parts, seed in (("train", 2, 1), ("test", 1, 2)):
        os.makedirs(base / split)
        for p in range(parts):
            javro.write_container(str(base / split / f"part-{p:05d}.avro"), SCHEMA,
                                  bag_records(300, seed * 10 + p))
    return base


AVRO_CONFIGS = {
    "sparse": {"global": dict(feature_bags=("features",), sparse=True)},
    "sparse-two-bags-no-intercept": {"global": dict(feature_bags=("features", "extra"),
                                                    sparse=True, has_intercept=False)},
    "hybrid-hot-cols": {"global": dict(feature_bags=("features",), sparse=True, hybrid=True,
                                       hybrid_hot_cols=8)},
    "hybrid-coverage": {"global": dict(feature_bags=("features",), sparse=True, hybrid=True,
                                       hybrid_coverage=0.4)},
    "sparse-beside-dense": {"global": dict(feature_bags=("features",), sparse=True),
                            "side": dict(feature_bags=("extra",), has_intercept=False)},
}


def _configs(module, spec):
    return {s: module.FeatureShardConfiguration(**kw) for s, kw in spec.items()}


def _assert_datasets_equal(jds, tds):
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(tds.host_array(name), np.asarray(jds.host_array(name)))
    np.testing.assert_array_equal(tds.unique_ids, np.asarray(jds.unique_ids))
    assert set(tds.feature_shards) == set(jds.feature_shards)
    for sid, j in jds.feature_shards.items():
        t = tds.feature_shards[sid]
        if isinstance(t, TShard):
            assert (t.num_samples, t.feature_dim) == (j.num_samples, j.feature_dim), sid
            for a, b in zip((t.rows, t.cols, t.vals), (j.rows, j.cols, j.vals)):
                assert np.asarray(a).dtype == np.asarray(b).dtype
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(t.coalesced(), j.coalesced()):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert (t.hybrid_policy is None) == (j.hybrid_policy is None), sid
            if t.hybrid_policy is not None:
                for f in ("hot_cols", "coverage", "pad_multiple", "max_hot_cols", "label"):
                    assert getattr(t.hybrid_policy, f) == getattr(j.hybrid_policy, f), f
        else:
            np.testing.assert_array_equal(tds.host_array(f"shard/{sid}"),
                                          np.asarray(jds.host_array(f"shard/{sid}")))
    for t, vocab in jds.entity_vocabs.items():
        np.testing.assert_array_equal(tds.entity_vocabs[t], np.asarray(vocab))
        np.testing.assert_array_equal(tds.host_array(f"entity_idx/{t}"),
                                      np.asarray(jds.host_array(f"entity_idx/{t}")))


def _assert_maps_equal(jmaps, tmaps):
    assert set(jmaps) == set(tmaps)
    for s, jm in jmaps.items():
        tm = tmaps[s]
        assert tm.size == jm.size and tm.intercept_index == jm.intercept_index, s
        if jm.size <= 1 << 20:
            assert dict(tm) == dict(jm), s


@pytest.mark.parametrize("name", list(AVRO_CONFIGS))
def test_avro_sparse_shards_read_as_the_jax_reader(bags, monkeypatch, name):
    """Sparse, hybrid and intercept shards from Avro: the same triples
    (the intercept as n explicit entries), index maps and hybrid policies;
    then the held-out split read with the training maps and vocabs."""
    monkeypatch.setenv("PHOTON_NO_NATIVE_AVRO", "1")
    jcfg, tcfg = _configs(jreader, AVRO_CONFIGS[name]), _configs(treader, AVRO_CONFIGS[name])
    jr = jreader.read_merged(str(bags / "train"), jcfg, random_effect_id_columns=("userId",))
    tr = treader.read_merged(str(bags / "train"), tcfg, random_effect_id_columns=("userId",),
                             device="cpu")
    _assert_maps_equal(jr.index_maps, tr.index_maps)
    assert tr.intercept_indices == jr.intercept_indices
    _assert_datasets_equal(jr.dataset, tr.dataset)
    assert isinstance(tr.dataset.feature_shards["global"], TShard)
    jh = jreader.read_merged(str(bags / "test"), jcfg, index_maps=jr.index_maps,
                             random_effect_id_columns=("userId",),
                             entity_vocabs=jr.dataset.entity_vocabs)
    th = treader.read_merged(str(bags / "test"), tcfg, index_maps=tr.index_maps,
                             random_effect_id_columns=("userId",),
                             entity_vocabs=tr.dataset.entity_vocabs, device="cpu")
    _assert_datasets_equal(jh.dataset, th.dataset)


def test_records_to_game_dataset_sparse_matches(bags):
    """The record-dict assembly of both packages on the same decoded records."""
    records = list(jreader.read_avro_records(str(bags / "train")))
    spec = AVRO_CONFIGS["sparse-beside-dense"]
    jmaps = jreader.build_index_maps(records, _configs(jreader, spec))
    tmaps = treader.build_index_maps(records, _configs(treader, spec))
    _assert_maps_equal(jmaps, tmaps)
    jr = jreader.records_to_game_dataset(records, _configs(jreader, spec), jmaps)
    tr = treader.records_to_game_dataset(records, _configs(treader, spec), tmaps, device="cpu")
    _assert_datasets_equal(jr.dataset, tr.dataset)


def test_hybrid_range_checks_match():
    for kw in (dict(hybrid=True, sparse=True, hybrid_hot_cols=0),
               dict(hybrid=True, sparse=True, hybrid_coverage=1.5),
               dict(hybrid=True, sparse=True, hybrid_hot_cols=4, hybrid_coverage=0.5),
               dict(hybrid=True), dict(hybrid_hot_cols=4, sparse=True),
               dict(sparse=True, dtype="bfloat16")):
        errors = []
        for mod in (jreader, treader):
            with pytest.raises(ValueError) as err:
                mod.FeatureShardConfiguration(feature_bags=("f",), **kw)
            errors.append(str(err.value).split(" ")[:4])
        assert errors[0] == errors[1], kw


LIBSVM_TEXT = """# a comment line
+1 3:0.5 7:1 12:-2.25
-1 1:1 3:1e-3 # a trailing comment

1 2:0.25 2:0.5
-1
0.75 5:3 9:0.125
2.5e-1 1:1 4:-1 12:7
"""


@pytest.fixture
def libsvm_file(tmp_path):
    path = tmp_path / "data.txt"
    path.write_text(LIBSVM_TEXT)
    return path


@pytest.mark.parametrize("zero_based", [False, True])
def test_read_libsvm_records_match(libsvm_file, zero_based):
    """Comments, blank lines, ±1 labels mapped to {0, 1}, regression labels
    kept, repeated indices kept as separate features."""
    want = list(jreader.read_libsvm(libsvm_file, zero_based=zero_based))
    got = list(treader.read_libsvm(libsvm_file, zero_based=zero_based))
    assert got == want and len(got) == 6
    assert [r["label"] for r in got] == [1.0, 0.0, 1.0, 0.0, 0.75, 0.25]


def test_libsvm_data_matches(libsvm_file, tmp_path):
    """CSR arrays (uint64 offsets, uint32 0-based columns, f64 values, raw
    labels) equal the JAX parse's, native and pure-Python; the derived
    views and the concatenation too."""
    got = tlibsvm.parse_libsvm(libsvm_file)
    for want in (jlibsvm.parse_libsvm(libsvm_file),
                 jlibsvm.parse_libsvm(libsvm_file, force_python=True)):
        for f in ("labels", "row_offsets", "cols", "vals"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    want = jlibsvm.parse_libsvm(libsvm_file, force_python=True)
    assert (got.num_rows, got.nnz, got.max_index) == (want.num_rows, want.nnz, want.max_index)
    np.testing.assert_array_equal(got.mapped_labels(), want.mapped_labels())
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(got.to_dense(8, np.float32), want.to_dense(8, np.float32))
    other = tmp_path / "other.txt"
    other.write_text("1 4:2\n-1\n")
    tcat = tlibsvm.concat_libsvm([got, tlibsvm.parse_libsvm(other)])
    jcat = jlibsvm.concat_libsvm([want, jlibsvm.parse_libsvm(other, force_python=True)])
    for f in ("labels", "row_offsets", "cols", "vals"):
        a, b = getattr(tcat, f), getattr(jcat, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    with pytest.raises(IsADirectoryError):
        tlibsvm.parse_libsvm(tmp_path)


@pytest.mark.parametrize("text,where", [("1 0:1\n", "zero index"), ("1 3\n", "bad token")])
def test_libsvm_errors_match(tmp_path, text, where):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    # the pure-Python parses raise the same message, the native parses too
    for kw in ({"force_python": True}, {}):
        with pytest.raises(ValueError) as jerr:
            jlibsvm.parse_libsvm(path, **kw)
        with pytest.raises(ValueError) as terr:
            tlibsvm.parse_libsvm(path, **kw)
        assert str(terr.value) == str(jerr.value), (where, kw)
    if where == "zero index":
        with pytest.raises(ValueError) as jerr:
            list(jreader.read_libsvm(path))
        with pytest.raises(ValueError) as terr:
            list(treader.read_libsvm(path))
        assert str(terr.value) == str(jerr.value)


LIBSVM_CONFIGS = {
    "dense-intercept": {"global": dict(feature_bags=("features",))},
    "sparse-by-name": {"global": dict(feature_bags=("features",), sparse=True)},
    "pre-indexed-sparse": {"global": dict(feature_bags=("features",), sparse=True,
                                          pre_indexed=True, dimension=20, has_intercept=False)},
    "pre-indexed-dense": {"global": dict(feature_bags=("features",), pre_indexed=True,
                                         dimension=13, has_intercept=False)},
    "pre-indexed-hybrid": {"global": dict(feature_bags=("features",), sparse=True, hybrid=True,
                                          hybrid_hot_cols=2, pre_indexed=True,
                                          dimension=1_000_000, has_intercept=False)},
    "no-features-bag": {"global": dict(feature_bags=("features",)),
                        "other": dict(feature_bags=("other",))},
}


@pytest.mark.parametrize("name", list(LIBSVM_CONFIGS))
def test_read_merged_libsvm_matches(libsvm_file, name):
    """LibSVM into dense, sparse and pre-indexed shards (an identity map of
    the declared dimension), and the same file read again with the first
    read's maps, as a validation set is."""
    spec = LIBSVM_CONFIGS[name]
    jr = jreader.read_merged(str(libsvm_file), _configs(jreader, spec), fmt="libsvm",
                             random_effect_id_columns=("userId",))
    tr = treader.read_merged(str(libsvm_file), _configs(treader, spec), fmt="libsvm",
                             random_effect_id_columns=("userId",), device="cpu")
    _assert_maps_equal(jr.index_maps, tr.index_maps)
    assert tr.intercept_indices == jr.intercept_indices
    _assert_datasets_equal(jr.dataset, tr.dataset)
    if spec["global"].get("pre_indexed"):
        assert isinstance(tr.index_maps["global"], tindex.IdentityIndexMap)
    jv = jreader.read_merged(str(libsvm_file), _configs(jreader, spec), fmt="libsvm",
                             index_maps=jr.index_maps)
    tv = treader.read_merged(str(libsvm_file), _configs(treader, spec), fmt="libsvm",
                             index_maps=tr.index_maps, device="cpu")
    _assert_datasets_equal(jv.dataset, tv.dataset)


def test_read_merged_libsvm_directory_of_parts(tmp_path):
    """A directory reads its regular files in name order, skipping ``_`` and
    ``.`` files; a list of paths reads in order."""
    lines = LIBSVM_TEXT.splitlines(keepends=True)
    parts = tmp_path / "parts"
    os.makedirs(parts)
    (parts / "part-00001.txt").write_text("".join(lines[:4]))
    (parts / "part-00000.txt").write_text("".join(lines[4:]))
    (parts / "_SUCCESS").write_text("")
    (parts / ".hidden").write_text("1 1:1\n")
    spec = LIBSVM_CONFIGS["sparse-by-name"]
    for path in (str(parts), [str(parts / "part-00001.txt"), str(parts / "part-00000.txt")]):
        jr = jreader.read_merged(path, _configs(jreader, spec), fmt="libsvm")
        tr = treader.read_merged(path, _configs(treader, spec), fmt="libsvm", device="cpu")
        _assert_maps_equal(jr.index_maps, tr.index_maps)
        _assert_datasets_equal(jr.dataset, tr.dataset)
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(ValueError, match="no LibSVM files found"):
        treader.read_merged(str(empty), _configs(treader, spec), fmt="libsvm", device="cpu")


@pytest.mark.parametrize("case", ["out-of-range", "no-dimension", "intercept", "avro"])
def test_pre_indexed_errors_match(libsvm_file, bags, case):
    spec = {
        "out-of-range": dict(feature_bags=("features",), sparse=True, pre_indexed=True,
                             dimension=10, has_intercept=False),
        "no-dimension": dict(feature_bags=("features",), pre_indexed=True, has_intercept=False),
        "intercept": dict(feature_bags=("features",), pre_indexed=True, dimension=20),
        "avro": dict(feature_bags=("features",), pre_indexed=True, dimension=20,
                     has_intercept=False),
    }[case]
    path, fmt = (str(bags / "train"), "avro") if case == "avro" else (str(libsvm_file), "libsvm")
    errors = []
    for mod in (jreader, treader):
        kw = {} if mod is jreader else {"device": "cpu"}
        with pytest.raises(ValueError) as err:
            mod.read_merged(path, {"global": mod.FeatureShardConfiguration(**spec)}, fmt=fmt,
                            **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_pre_indexed_dimension_past_int32_raises(libsvm_file):
    """The port's gather kernels take int32 column ids, so a pre-indexed
    space of 2^31 columns or more is refused (the JAX package refuses it
    only without x64)."""
    cfg = {"global": treader.FeatureShardConfiguration(
        feature_bags=("features",), sparse=True, pre_indexed=True, dimension=2**31,
        has_intercept=False)}
    with pytest.raises(ValueError, match="exceeds int32"):
        treader.read_merged(str(libsvm_file), cfg, fmt="libsvm", device="cpu")
    ok = {"global": treader.FeatureShardConfiguration(
        feature_bags=("features",), sparse=True, pre_indexed=True, dimension=2**31 - 1,
        has_intercept=False)}
    shard = treader.read_merged(str(libsvm_file), ok, fmt="libsvm",
                                device="cpu").dataset.feature_shards["global"]
    assert shard.feature_dim == 2**31 - 1


def test_identity_index_map_matches(tmp_path):
    from photon_ml_tpu.io import index_map as jindex

    for dim, intercept in ((12, None), (40, 39)):
        j, t = jindex.IdentityIndexMap(dim, intercept_index=intercept), \
            tindex.IdentityIndexMap(dim, intercept_index=intercept)
        assert dict(t) == dict(j) and len(t) == len(j) and t.size == j.size
        for key in ("3\x01", "3", "x\x01", "3\x01t", "-1", "12", jindex.INTERCEPT_KEY):
            assert t.get_index(key) == j.get_index(key), key
        for i in (-1, 0, 11, 39, 40):
            assert t.get_feature_name(i) == j.get_feature_name(i)
        t.save(tmp_path, f"s{dim}")
        j.save(tmp_path / "j", f"s{dim}")
        assert (tmp_path / f"s{dim}.identity.json").read_bytes() == \
            (tmp_path / "j" / f"s{dim}.identity.json").read_bytes()
    big = tindex.IdentityIndexMap(1 << 21)
    with pytest.raises(RuntimeError, match="refusing to enumerate"):
        iter(big)
    assert big.get_index("2000000\x01") == 2_000_000
