"""The port's off-heap and PalDB index stores against the JAX package's on
the CPU: off-heap stores written by either package are byte-identical and
read by the other, the Python reader agrees with the native one key for key,
and a two-partition PalDB V1 store (written by ``tests/torch_paldb_writer``)
reads the same through both packages."""

import os

import numpy as np
import pytest

from photon_ml_tpu.io import index_map as jindex
from photon_ml_tpu.io import offheap_index_map as joff
from photon_ml_tpu.io import paldb as jpaldb
from photon_ml_torch.io import index_map as tindex
from photon_ml_torch.io import offheap_index_map as toff
from photon_ml_torch.io import paldb as tpaldb
from tests.test_paldb import GAME_INDEXES, HEART, HEART_ICPT, REF
from tests.torch_paldb_writer import serialize, write_store

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(0)
    out = [tindex.feature_key(f"feat{i}", f"term{rng.integers(0, 5)}") for i in range(700)]
    out += [tindex.feature_key("unicode", "日本語-ключ"), tindex.feature_key("", ""),
            tindex.feature_key("name-only")]
    return out


@pytest.fixture(scope="module")
def imap(keys):
    return tindex.IndexMap.from_keys(keys, add_intercept=True)


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.mark.parametrize("partitions", [1, 3])
def test_offheap_stores_are_byte_identical_and_read_both_ways(imap, tmp_path, partitions):
    jpaths = joff.build_offheap_store(tmp_path / "j", dict(imap), num_partitions=partitions,
                                      name="global")
    tpaths = toff.build_offheap_store(tmp_path / "t", imap, num_partitions=partitions,
                                      name="global")
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    assert {f.rsplit(".", 1)[-1] for f in _files(tmp_path / "t")} == {"photonix", "idx", "json"}
    for f in _files(tmp_path / "j"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
    # each package reads the other's store
    port_reads_jax = toff.OffHeapIndexMap(tmp_path / "j", "global")
    jax_reads_port = joff.OffHeapIndexMap(tmp_path / "t", "global")
    for key, idx in imap.items():
        assert port_reads_jax.get_index(key) == idx == jax_reads_port.get_index(key)
    for idx in range(0, imap.size, 7):
        assert port_reads_jax.get_feature_name(idx) == imap.get_feature_name(idx)
    assert port_reads_jax.get_index("missing\x01key") == -1
    assert port_reads_jax.get_feature_name(imap.size) is None
    assert port_reads_jax.intercept_index == imap.intercept_index
    assert port_reads_jax.has_intercept and len(port_reads_jax) == imap.size
    assert dict(port_reads_jax) == dict(imap)
    with pytest.raises(KeyError):
        port_reads_jax["missing\x01key"]
    port_reads_jax.close()
    jax_reads_port.close()


def test_python_reader_agrees_with_native(imap, tmp_path):
    toff.build_offheap_store(tmp_path, imap, num_partitions=2, name="s")
    native = toff.OffHeapIndexMap(tmp_path, "s")
    python = toff.OffHeapIndexMap(tmp_path, "s", force_python=True)
    assert isinstance(native._stores[0], toff._NativeStore)
    assert isinstance(python._stores[0], toff._PyStore)
    for key in list(imap) + ["absent\x01", ""]:
        assert python.get_index(key) == native.get_index(key)
    for idx in range(-1, imap.size + 1):
        assert python.get_feature_name(idx) == native.get_feature_name(idx)
    native.close()
    python.close()


def test_offheap_build_refuses_what_the_jax_package_refuses(tmp_path):
    for mod in (joff, toff):
        with pytest.raises(ValueError, match="num_partitions"):
            mod.build_offheap_store(tmp_path, {"a": 0}, num_partitions=0)
        with pytest.raises(ValueError, match="dense"):
            mod.build_offheap_store(tmp_path, {"a": 0, "b": 2})
    (tmp_path / "bad.part-00000.photonix").write_bytes(b"NOTASTORE" + bytes(40))
    (tmp_path / "bad.part-00000.photonix.idx").write_bytes(b"")
    (tmp_path / "bad.photonix.json").write_text('{"num_partitions": 1, "size": 0}')
    with pytest.raises(ValueError, match="photonix"):
        toff.OffHeapIndexMap(tmp_path, "bad", force_python=True)
    with pytest.raises(ValueError, match="photonix"):
        toff.OffHeapIndexMap(tmp_path, "bad")


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: a native store that cannot build raises with the
    compiler's message instead of reading with Python."""
    from photon_ml_torch import build

    monkeypatch.setattr(build, "_HOST_LOADED", {})
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "native-build")
    monkeypatch.setattr(build, "_gxx", lambda: (_ for _ in ()).throw(
        RuntimeError("no C++ compiler (g++) found")))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        toff.build_offheap_store(tmp_path / "s", {"a": 0})


def _paldb_partitions(keys):
    names = sorted(set(keys)) + [tindex.INTERCEPT_KEY]
    # uneven partitions: the first one's 400 local indices cross 255 (packed
    # ints, two-byte varints) and its key lengths make several slot groups
    return [names[:400], names[400:]]


@pytest.mark.parametrize("reader", ["read_partition", "load_paldb_index_map", "load_directory"])
def test_paldb_store_reads_the_same_in_both_packages(keys, tmp_path, reader):
    parts = _paldb_partitions(keys)
    paths = write_store(tmp_path, "global", parts)
    if reader == "read_partition":
        for path, names in zip(paths, parts):
            j, t = jpaldb.read_partition(path), tpaldb.read_partition(path)
            assert t.name_to_local == j.name_to_local == {k: i for i, k in enumerate(names)}
            assert t.local_to_name == j.local_to_name and t.size == len(names)
        return
    if reader == "load_paldb_index_map":
        j = jpaldb.load_paldb_index_map(tmp_path, "global")
        t = tpaldb.load_paldb_index_map(tmp_path, "global")
    else:
        j = jindex.IndexMap.load_directory(tmp_path)["global"]
        t = tindex.IndexMap.load_directory(tmp_path)["global"]
        assert tindex.IndexMap.list_directory(tmp_path) == {"global"}
    assert isinstance(t, tindex.IndexMap)
    assert dict(t) == dict(j)
    expected = {k: i for i, k in enumerate(parts[0] + parts[1])}
    assert dict(t) == expected
    assert t.intercept_index == j.intercept_index == expected[tindex.INTERCEPT_KEY]
    for idx in (0, 255, 399, 400, len(expected) - 1):
        assert t.get_feature_name(idx) == j.get_feature_name(idx)


def test_paldb_errors_match(keys, tmp_path):
    parts = _paldb_partitions(keys)
    write_store(tmp_path / "gap", "g", parts)
    os.rename(tmp_path / "gap" / "paldb-partition-g-1.dat",
              tmp_path / "gap" / "paldb-partition-g-2.dat")
    (tmp_path / "magic").mkdir()
    (tmp_path / "magic" / "paldb-partition-m-0.dat").write_bytes(b"\x00\x08NOTPALDB" + bytes(40))
    for mod in (jpaldb, tpaldb):
        with pytest.raises(ValueError, match="contiguous"):
            mod.load_paldb_index_map(tmp_path / "gap", "g")
        with pytest.raises(FileNotFoundError, match="no PalDB store"):
            mod.load_paldb_index_map(tmp_path / "gap", "absent")
        with pytest.raises(ValueError, match="not a PalDB V1 store"):
            mod.read_partition(tmp_path / "magic" / "paldb-partition-m-0.dat")
        assert mod.discover_stores(tmp_path / "gap") == {"g": {
            0: str(tmp_path / "gap" / "paldb-partition-g-0.dat"),
            2: str(tmp_path / "gap" / "paldb-partition-g-2.dat")}}
        assert mod.PARTITION_RE.match("paldb-partition-a-b-3.dat").group("ns") == "a-b"
    for value in (0, 8, 9, 254, 255, 300, 1 << 20, "", "ab", "日本"):
        blob = serialize(value)
        assert tpaldb._deserialize(blob, 0, len(blob)) == jpaldb._deserialize(blob, 0, len(blob))
        assert tpaldb._deserialize(blob, 0, len(blob)) == value
    with pytest.raises(ValueError, match="unsupported PalDB serialization"):
        tpaldb._deserialize(b"\x01", 0, 1)


def test_load_directory_reads_every_store_kind(imap, tmp_path):
    """A stores directory mixing plain, off-heap and PalDB stores loads
    the same maps in both packages; the port returns an OffHeapIndexMap for
    the off-heap store, as the JAX package does."""
    small = tindex.IndexMap.from_keys(list(imap)[:30])
    small.save(tmp_path, "plain")
    toff.build_offheap_store(tmp_path, imap, num_partitions=3, name="off")
    write_store(tmp_path, "pal", [list(small)[:10], list(small)[10:]])
    j = jindex.IndexMap.load_directory(tmp_path)
    t = tindex.IndexMap.load_directory(tmp_path)
    assert sorted(t) == sorted(j) == ["off", "pal", "plain"]
    assert tindex.IndexMap.list_directory(tmp_path) == jindex.IndexMap.list_directory(tmp_path)
    assert isinstance(t["off"], toff.OffHeapIndexMap)
    for shard in t:
        assert dict(t[shard]) == dict(j[shard]), shard
        assert t[shard].size == j[shard].size


#: the reference's PalDB fixtures, where ``tests/test_paldb.py`` reads them
PALDB_FIXTURES = [(HEART, "global", 13), (HEART_ICPT, "global", 14),
                  (GAME_INDEXES, "shard1", 15045), (GAME_INDEXES, "shard2", 15015),
                  (GAME_INDEXES, "shard3", 31)]


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference fixtures not mounted")
@pytest.mark.parametrize("directory,namespace,size", PALDB_FIXTURES,
                         ids=[f"{os.path.basename(d)}-{ns}" for d, ns, _ in PALDB_FIXTURES])
def test_reference_paldb_fixtures_read_as_the_jax_package_reads_them(directory, namespace,
                                                                      size):
    j = jpaldb.load_paldb_index_map(directory, namespace)
    t = tpaldb.load_paldb_index_map(directory, namespace)
    assert len(t) == size and dict(t) == dict(j)


def test_index_map_from_name_terms_matches():
    pairs = [("b", "x"), ("a", ""), ("b", "x"), ("é", "t")]
    for intercept in (False, True):
        t = tindex.IndexMap.from_name_terms(pairs, add_intercept=intercept)
        j = jindex.IndexMap.from_name_terms(pairs, add_intercept=intercept)
        assert dict(t) == dict(j) and t.intercept_index == j.intercept_index
