"""The port's native LibSVM parser (``photon_ml_torch/native/libsvm_loader.cpp``
through ``photon_ml_torch/io/libsvm.py``) on the CPU: every case of
``tests/test_native_libsvm.py``, each parse held equal to the port's
pure-Python parse and to the JAX package's, malformed input refused by all
three with ``ValueError``, and a build that fails raising."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.io import libsvm_native as jlibsvm
from photon_ml_torch import build
from photon_ml_torch.io import libsvm as tlibsvm
from photon_ml_torch.io.data_reader import (
    FeatureShardConfiguration,
    build_index_maps,
    read_libsvm,
    read_merged,
    records_to_game_dataset,
)

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

A1A_SNIPPET = """\
# comment line
-1 3:1 11:1 14:1 19:1 39:1
+1 5:0.5 7:2.25 11:1

-1 1:1 2:1 40:0.125  # trailing comment
2.5 4:1
"""


@pytest.fixture
def svm_file(tmp_path):
    p = tmp_path / "data.libsvm"
    p.write_text(A1A_SNIPPET)
    return p


def _assert_same(a, b):
    for field in ("labels", "row_offsets", "cols", "vals"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), field


def _all_parses(path, **kw):
    """(port native, port Python, JAX native) parses of one file."""
    return (tlibsvm.parse_libsvm(path, **kw), tlibsvm.parse_libsvm(path, force_python=True, **kw),
            jlibsvm.parse_libsvm(path, **kw))


def test_native_library_builds_under_the_build_dir():
    lib = tlibsvm.load_host("libsvm_loader", tlibsvm._configure)
    path = build.host_library_path("libsvm_loader")
    assert path.exists() and path.parent == build.HOST_BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert lib is tlibsvm.load_host("libsvm_loader", tlibsvm._configure)


def test_parse_basic(svm_file):
    d = tlibsvm.parse_libsvm(svm_file)
    assert d.num_rows == 4 and d.nnz == 5 + 3 + 3 + 1
    np.testing.assert_array_equal(d.labels, [-1.0, 1.0, -1.0, 2.5])
    np.testing.assert_array_equal(d.cols[:5], [2, 10, 13, 18, 38])  # stored 0-based
    np.testing.assert_array_equal(d.row_offsets, [0, 5, 8, 11, 12])
    assert d.max_index == 39


@pytest.mark.parametrize("zero_based", [False, True])
def test_native_matches_python_and_the_reference(tmp_path, svm_file, zero_based):
    rng = np.random.default_rng(0)
    big = tmp_path / "big.libsvm"
    with open(big, "w") as f:
        for i in range(300):
            cols = np.sort(rng.choice(np.arange(1, 500), size=rng.integers(0, 20), replace=False))
            feats = " ".join(f"{c}:{rng.normal():.6g}" for c in cols)
            f.write(f"{rng.choice([-1, 1, 0.5])} {feats}\n")
    for path in (svm_file, big):
        nat, py, ref = _all_parses(path, zero_based=zero_based)
        _assert_same(nat, py)
        _assert_same(nat, ref)


def test_mapped_labels():
    n = 4
    data = tlibsvm.LibSVMData(labels=np.asarray([-1.0, 1.0, 2.5, 0.0]),
                              row_offsets=np.arange(n + 1, dtype=np.uint64),
                              cols=np.zeros(n, dtype=np.uint32), vals=np.ones(n))
    np.testing.assert_array_equal(data.mapped_labels(), [0.0, 1.0, 2.5, 0.0])


def test_to_dense_accumulates_duplicates(tmp_path):
    p = tmp_path / "dup.libsvm"
    p.write_text("1 1:2 1:3 2:1\n")
    np.testing.assert_array_equal(tlibsvm.parse_libsvm(p).to_dense(), [[5.0, 1.0]])


def test_zero_based(tmp_path):
    p = tmp_path / "zb.libsvm"
    p.write_text("1 0:1 3:2\n")
    np.testing.assert_array_equal(tlibsvm.parse_libsvm(p, zero_based=True).cols, [0, 3])
    for parse in (tlibsvm.parse_libsvm, jlibsvm.parse_libsvm):
        with pytest.raises(ValueError, match="out of range|parse failed"):
            parse(p)  # 1-based: index 0 becomes -1
    with pytest.raises(ValueError, match="out of range"):
        tlibsvm.parse_libsvm(p, force_python=True)


def test_dangling_token_does_not_steal_next_line(tmp_path):
    """A dangling 'idx:' token errors; it does not parse the next line's
    label as its value."""
    p = tmp_path / "dangling.libsvm"
    p.write_text("1 5:\n2 3:4\n")
    for kw in ({}, {"force_python": True}):
        with pytest.raises(ValueError):
            tlibsvm.parse_libsvm(p, **kw)
    with pytest.raises(ValueError):
        jlibsvm.parse_libsvm(p)


def test_denormal_and_overflow_values_parse(tmp_path):
    """As Python's float(): denormals parse, overflow gives inf."""
    p = tmp_path / "denorm.libsvm"
    p.write_text("1 1:1e-310 2:1e400\n-1e400 1:1\n")
    nat, py, ref = _all_parses(p)
    _assert_same(nat, py)
    _assert_same(nat, ref)
    assert nat.vals[0] == pytest.approx(1e-310)
    assert np.isposinf(nat.vals[1]) and np.isneginf(nat.labels[1])


@pytest.mark.parametrize("bad", ["1 nocolon\n", "notalabel 1:1\n", "1 5:xyz\n"])
def test_malformed_raises(tmp_path, bad):
    p = tmp_path / "bad.libsvm"
    p.write_text(bad)
    with pytest.raises(ValueError, match="parse failed"):
        tlibsvm.parse_libsvm(p)
    with pytest.raises(ValueError, match="parse failed"):
        jlibsvm.parse_libsvm(p)
    with pytest.raises(ValueError):
        tlibsvm.parse_libsvm(p, force_python=True)


def test_concat_multiple_files(tmp_path):
    p1, p2 = tmp_path / "a.libsvm", tmp_path / "b.libsvm"
    p1.write_text("1 1:1\n-1 2:2\n")
    p2.write_text("1 3:3\n")
    d = tlibsvm.concat_libsvm([tlibsvm.parse_libsvm(p1), tlibsvm.parse_libsvm(p2)])
    assert d.num_rows == 3 and d.nnz == 3
    np.testing.assert_array_equal(d.row_offsets, [0, 1, 2, 3])
    np.testing.assert_array_equal(d.cols, [0, 1, 2])
    _assert_same(d, jlibsvm.concat_libsvm([jlibsvm.parse_libsvm(p1), jlibsvm.parse_libsvm(p2)]))


def test_read_merged_fast_path_matches_record_path(svm_file):
    shard_cfgs = {"g": FeatureShardConfiguration(feature_bags=("features",), has_intercept=True)}
    fast = read_merged(svm_file, shard_cfgs, fmt="libsvm", dtype=np.float64, device="cpu")
    records = list(read_libsvm(svm_file))
    slow = records_to_game_dataset(records, shard_cfgs, build_index_maps(records, shard_cfgs),
                                   dtype=np.float64, device="cpu")
    assert fast.index_maps["g"].size == slow.index_maps["g"].size
    assert torch.equal(fast.dataset.labels, slow.dataset.labels)
    assert torch.equal(fast.dataset.feature_shards["g"], slow.dataset.feature_shards["g"])
    assert fast.intercept_indices == slow.intercept_indices


def test_read_merged_fast_path_with_existing_index_map(svm_file):
    shard_cfgs = {"g": FeatureShardConfiguration(feature_bags=("features",), has_intercept=False)}
    first = read_merged(svm_file, shard_cfgs, fmt="libsvm", device="cpu")
    again = read_merged(svm_file, shard_cfgs, index_maps=first.index_maps, fmt="libsvm",
                        device="cpu")
    assert torch.equal(first.dataset.feature_shards["g"], again.dataset.feature_shards["g"])


def test_directory_path_raises_cleanly(tmp_path):
    for kw in ({}, {"force_python": True}):
        with pytest.raises(IsADirectoryError):
            tlibsvm.parse_libsvm(tmp_path, **kw)


def test_libsvm_to_avro_converter_round_trip(tmp_path, svm_file):
    """Avro written by the port's converter reads as the LibSVM file does."""
    from photon_ml_torch.cli.libsvm_to_avro import convert, main

    out = tmp_path / "converted" / "part-00000.avro"
    assert convert(svm_file, out) == 4 and out.exists()
    shard_cfgs = {"g": FeatureShardConfiguration(feature_bags=("features",), has_intercept=True)}
    from_avro = read_merged(out.parent, shard_cfgs, fmt="avro", dtype=np.float64, device="cpu")
    from_svm = read_merged(svm_file, shard_cfgs, fmt="libsvm", dtype=np.float64, device="cpu")
    assert torch.equal(from_avro.dataset.labels, from_svm.dataset.labels)
    assert torch.equal(from_avro.dataset.feature_shards["g"], from_svm.dataset.feature_shards["g"])
    assert main(["--input", str(svm_file), "--output", str(tmp_path / "x.avro")]) == 4


def test_read_libsvm_rejects_invalid_index(tmp_path):
    p = tmp_path / "bad.libsvm"
    p.write_text("1 0:1.5 2:1\n")
    with pytest.raises(ValueError, match="out of range"):
        list(read_libsvm(p))


def test_a_failed_build_raises(tmp_path, monkeypatch, svm_file):
    """A parser source that does not compile raises RuntimeError with the
    compiler's output, from the parse and from a LibSVM read; nothing falls
    back to the Python parser."""
    broken = tmp_path / "native"
    broken.mkdir()
    (broken / "libsvm_loader.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "NATIVE", broken)
    monkeypatch.setattr(build, "HOST_BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_HOST_LOADED", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*libsvm_loader.cpp"):
        tlibsvm.parse_libsvm(svm_file)
    shard_cfgs = {"g": FeatureShardConfiguration(feature_bags=("features",))}
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        read_merged(svm_file, shard_cfgs, fmt="libsvm", device="cpu")
    assert not list((tmp_path / "out").glob("*.so"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tlibsvm.parse_libsvm(svm_file)
