"""The port's Avro codec, index maps and dataset reader against the JAX
package's (``photon_ml_tpu/io/avro.py``, ``io/index_map.py``,
``io/data_reader.py``), on the CPU.

Files written by one package read in the other, the same records give the
same bytes, and ``read_merged`` on the music fixture gives arrays equal to
the JAX reader's (the JAX reader's native decoder and its Python path are
pinned equal by the JAX package's own tests), the bfloat16 shard included:
exact equality, no tolerance.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import data_reader as jreader
from photon_ml_tpu.io import index_map as jindex
from photon_ml_tpu.io import photon_schemas as jschemas
from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io import data_reader as treader
from photon_ml_torch.io import index_map as tindex
from photon_ml_torch.io import photon_schemas as tschemas
from tests import torch_driver_parity as P

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

SHARDS = {"global": ("features",), "userShard": ("userFeatures",),
          "songShard": ("songFeatures",)}


@pytest.fixture(scope="module")
def music(tmp_path_factory):
    base = tmp_path_factory.mktemp("music")
    P.write_music(str(base))
    return base


def test_schemas_are_the_jax_packages():
    assert tschemas.ALL_SCHEMAS == jschemas.ALL_SCHEMAS
    assert tavro.DEFAULT_SYNC == javro.DEFAULT_SYNC and tavro.MAGIC == javro.MAGIC


@pytest.mark.parametrize("codec,block_records", [("deflate", 4096), ("null", 7),
                                                 ("deflate", 1)])
def test_same_records_give_the_same_bytes(tmp_path, codec, block_records):
    records = P.make_music_records(53, seed=5)
    paths = {}
    for name, mod in (("jax", javro), ("torch", tavro)):
        paths[name] = tmp_path / f"{name}.avro"
        n = mod.write_container(paths[name], P.MUSIC_SCHEMA, records, codec=codec,
                                block_records=block_records)
        assert n == len(records)
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()


def test_each_reads_the_others_files(tmp_path):
    records = P.make_music_records(40, seed=6)
    javro.write_container(tmp_path / "j.avro", P.MUSIC_SCHEMA, records, block_records=9)
    tavro.write_container(tmp_path / "t.avro", P.MUSIC_SCHEMA, records, block_records=9)
    assert list(tavro.read_container(tmp_path / "j.avro")) == records
    assert list(javro.read_container(tmp_path / "t.avro")) == records
    assert tavro.read_container_schema(tmp_path / "j.avro") == \
        javro.read_container_schema(tmp_path / "t.avro")
    assert javro.scan_block_index(tmp_path / "j.avro") == \
        javro.scan_block_index(tmp_path / "t.avro")


def test_quarantine_skips_the_same_blocks(tmp_path):
    """A block whose bytes are damaged is skipped by both readers, and the
    port counts the span it skipped."""
    records = P.make_music_records(30, seed=8)
    path = tmp_path / "c.avro"
    tavro.write_container(path, P.MUSIC_SCHEMA, records, codec="null", block_records=10)
    blocks = javro.scan_block_index(path)
    data = bytearray(path.read_bytes())
    mid = blocks[1][2] + blocks[1][1] // 2  # inside the second block's payload
    data[mid:mid + 8] = b"\xff" * 8
    path.write_bytes(bytes(data))
    before = len(tavro.quarantined_blocks)
    got_t = list(tavro.read_container(path, on_corrupt="quarantine"))
    got_j = list(javro.read_container(path, on_corrupt="quarantine"))
    assert got_t == got_j and len(got_t) == 20
    assert len(tavro.quarantined_blocks) == before + 1
    with pytest.raises(Exception):
        list(tavro.read_container(path))


def _configs(module, bf16_global=False):
    return {s: module.FeatureShardConfiguration(
        feature_bags=bags, has_intercept=(s == "global"),
        dtype="bfloat16" if (bf16_global and s == "global") else "float32")
        for s, bags in SHARDS.items()}


def _host(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if hasattr(a, "dtype") else np.asarray(a)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-global"])
def test_read_merged_equals_the_jax_reader(music, bf16):
    kw = dict(random_effect_id_columns=("songId", "userId"), evaluation_id_columns=("queryId",))
    path = str(music / "train")
    j = jreader.read_merged(path, _configs(jreader, bf16), **kw)
    t = treader.read_merged(path, _configs(treader, bf16), device="cpu", **kw)
    jd, td = j.dataset, t.dataset
    assert {k: dict(v) for k, v in j.index_maps.items()} == \
        {k: dict(v) for k, v in t.index_maps.items()}
    assert j.intercept_indices == t.intercept_indices
    np.testing.assert_array_equal(np.asarray(jd.unique_ids), td.unique_ids)
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(np.asarray(getattr(jd, name)), getattr(td, name).numpy())
    for shard in SHARDS:
        jx, tx = jd.feature_shards[shard], td.feature_shards[shard]
        want = torch.bfloat16 if (bf16 and shard == "global") else torch.float32
        assert tx.dtype == want and str(jx.dtype) == str(want).replace("torch.", "")
        assert np.array_equal(_host(jx), tx.float().numpy())
        # the host copies the bucket builders and summaries read agree too
        assert np.array_equal(_host(jd.host_array(f"shard/{shard}")),
                              td.host_array(f"shard/{shard}"))
    for re_type in ("songId", "userId"):
        assert np.array_equal(np.asarray(jd.entity_vocabs[re_type]), td.entity_vocabs[re_type])
        assert np.array_equal(np.asarray(jd.entity_idx[re_type]),
                              td.entity_idx[re_type].numpy())
    assert np.array_equal(np.asarray(jd.ids["queryId"]), td.ids["queryId"])


def test_read_with_given_maps_and_vocabs(music):
    """The validation read: the training maps and entity vocabs are reused,
    and unseen entities get index -1 in both."""
    kw = dict(random_effect_id_columns=("userId",))
    jt = jreader.read_merged(str(music / "train"), _configs(jreader), **kw)
    tt = treader.read_merged(str(music / "train"), _configs(treader), device="cpu", **kw)
    vocabs = {"userId": np.asarray(tt.dataset.entity_vocabs["userId"])[:-3]}
    j = jreader.read_merged(str(music / "test"), _configs(jreader), index_maps=jt.index_maps,
                            entity_vocabs=vocabs, **kw)
    t = treader.read_merged(str(music / "test"), _configs(treader), index_maps=tt.index_maps,
                            entity_vocabs=vocabs, device="cpu", **kw)
    idx = t.dataset.entity_idx["userId"].numpy()
    assert np.array_equal(np.asarray(j.dataset.entity_idx["userId"]), idx)
    assert (idx < 0).any()
    assert np.array_equal(_host(j.dataset.feature_shards["global"]),
                          t.dataset.feature_shards["global"].numpy())


def test_index_maps_persist_the_same_files(tmp_path):
    keys = [tindex.feature_key(f"n{i}", "t" if i % 2 else "") for i in range(17)]
    jm = jindex.IndexMap.from_keys(keys, add_intercept=True)
    tm = tindex.IndexMap.from_keys(keys, add_intercept=True)
    assert dict(jm) == dict(tm) and tm.intercept_index == jm.intercept_index
    jm.save(tmp_path / "j", "s")
    tm.save(tmp_path / "t", "s")
    for f in ("s.keys", "s.meta.json"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes()
    loaded = tindex.IndexMap.load_directory(tmp_path / "j")
    assert dict(loaded["s"]) == dict(jm)
    ident = tindex.IdentityIndexMap(40, intercept_index=39)
    ident.save(tmp_path / "t", "ident")
    assert tindex.IndexMap.list_directory(tmp_path / "t") == {"s", "ident"}
    back = jindex.IndexMap.load_directory(tmp_path / "t")["ident"]
    assert back.size == 40 and back.intercept_index == 39
    assert tindex.split_feature_key(keys[1]) == jindex.split_feature_key(keys[1])
    # an off-heap store beside them loads in both packages (it was refused
    # before the port had the store)
    from photon_ml_torch.io.offheap_index_map import build_offheap_store

    build_offheap_store(tmp_path / "t", tm, num_partitions=2, name="z")
    for mod in (jindex, tindex):
        loaded = mod.IndexMap.load_directory(tmp_path / "t")
        assert sorted(loaded) == ["ident", "s", "z"] and dict(loaded["z"]) == dict(jm)


def test_reader_refuses_what_is_not_ported(music):
    """Sparse shards and LibSVM input are read now; what the reader still
    refuses is what the JAX package refuses: pre-indexed shards on Avro and
    quarantine on LibSVM."""
    pre = {"global": treader.FeatureShardConfiguration(feature_bags=("features",), sparse=True,
                                                       pre_indexed=True, dimension=10,
                                                       has_intercept=False)}
    with pytest.raises(ValueError, match="require the libsvm input format"):
        treader.read_merged(str(music / "train"), pre, device="cpu")
    with pytest.raises(ValueError, match="supports fmt='avro' only"):
        treader.read_merged(str(music / "train"), _configs(treader), fmt="libsvm",
                            on_corrupt="quarantine", device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        treader.FeatureShardConfiguration(feature_bags=("f",), dtype="float16")
