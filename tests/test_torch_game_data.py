"""The port's GAME dataset builders against the JAX package's, on the CPU:
datasets, vocabularies, entity indices, buckets, lanes and sample rows must
be equal arrays (``np.array_equal``), not merely equivalent."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.sampling import down_sampler as jds
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.sampling import down_sampler as tds
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, game_arrays

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _assert_dataset_equal(jd, td):
    for name in ("labels", "offsets", "weights"):
        assert np.array_equal(np.asarray(getattr(jd, name)), getattr(td, name).numpy())
        assert np.array_equal(jd.host_array(name), td.host_array(name))
    assert np.array_equal(jd.unique_ids, td.unique_ids)
    assert list(jd.feature_shards) == list(td.feature_shards)
    for k in jd.feature_shards:
        assert np.array_equal(np.asarray(jd.feature_shards[k]), td.feature_shards[k].numpy())
    assert list(jd.entity_idx) == list(td.entity_idx)
    for t in jd.entity_idx:
        ref, got = np.asarray(jd.entity_idx[t]), td.entity_idx[t].numpy()
        assert got.dtype == np.int32 and np.array_equal(ref, got)
        assert np.array_equal(jd.entity_vocabs[t], td.entity_vocabs[t])
        assert np.array_equal(jd.host_array(f"entity_idx/{t}"), td.host_array(f"entity_idx/{t}"))
    assert list(jd.ids) == list(td.ids)
    for k in jd.ids:
        assert np.array_equal(jd.ids[k], td.ids[k])


def _assert_buckets_equal(jre, tre):
    assert (jre.num_entities, jre.dim, jre.num_trained_entities) == \
        (tre.num_entities, tre.dim, tre.num_trained_entities)
    assert len(jre.buckets) == len(tre.buckets)
    for jb, tb in zip(jre.buckets, tre.buckets):
        assert (jb.num_entities, jb.capacity) == (tb.num_entities, tb.capacity)
        for name in ("features", "labels", "weights", "entity_rows", "sample_rows"):
            ref, got = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
            assert ref.dtype == got.dtype and np.array_equal(ref, got), name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_build_game_dataset_equal(dtype):
    jd, td = datasets(game_arrays(0), dtype=dtype)
    _assert_dataset_equal(jd, td)
    assert td.labels.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    assert td.num_samples == jd.num_samples and td.device.type == "cpu"


def test_build_game_dataset_with_training_vocab():
    train, held = game_arrays(1, held_out=120)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    _assert_dataset_equal(jh, th)
    assert int((th.entity_idx["user"] < 0).sum()) > 0  # unseen users map to -1
    empty = tgd.entity_index_of(np.array(["a", "b"]), np.array([], dtype=str))
    assert empty.tolist() == [-1, -1]


@pytest.mark.parametrize("kw", [
    {},
    {"active_data_lower_bound": 3},
    {"active_data_upper_bound": 20},
    {"active_data_upper_bound": 40, "active_data_lower_bound": 2, "seed": 5},
    {"bucket_sizes": (128,)},
    {"bucket_sizes": (16, 64), "active_data_upper_bound": 50},
], ids=["default", "lower", "cap", "cap-lower-seed", "one-bucket", "two-buckets"])
@pytest.mark.parametrize("re_type", ["user", "item"])
def test_random_effect_dataset_equal(kw, re_type):
    jd, td = datasets(game_arrays(2))
    jre = jgd.build_random_effect_dataset(jd, re_type, "per_entity", **kw)
    tre = tgd.build_random_effect_dataset(td, re_type, "per_entity", **kw)
    _assert_buckets_equal(jre, tre)
    assert tre.table_width == tre.dim == 3
    assert tre.random_effect_type == re_type and tre.feature_shard_id == "per_entity"


def test_grouping_and_lane_packing_equal():
    a = game_arrays(3)
    jd, td = datasets(a)
    idx = td.host_array("entity_idx/user")
    kw = dict(bucket_sizes=(8, 32), active_data_upper_bound=12, active_data_lower_bound=2, seed=9)
    ref = jgd.group_entities_into_buckets(idx, a["unique_ids"], **kw)
    got = tgd.group_entities_into_buckets(idx, a["unique_ids"], **kw)
    assert list(ref) == list(got)
    for cap in ref:
        assert [e for e, _ in ref[cap]] == [e for e, _ in got[cap]]
        for (_, r), (_, g) in zip(ref[cap], got[cap]):
            assert np.array_equal(r, g)
        if ref[cap]:
            for r, g in zip(jgd.pack_bucket_lanes(ref[cap]), tgd.pack_bucket_lanes(got[cap])):
                assert r.dtype == g.dtype and np.array_equal(r, g)
    ids = np.array([0, 1, -5, 2**40, 7])
    assert np.array_equal(jgd._stable_priorities(ids, 3), tgd._stable_priorities(ids, 3))
    none = tgd.group_entities_into_buckets(np.full(5, -1), np.arange(5), bucket_sizes=(8,))
    assert none == {8: []}


def test_no_entity_meets_the_lower_bound():
    jd, td = datasets(game_arrays(4))
    tre = tgd.build_random_effect_dataset(td, "user", "per_entity",
                                          active_data_lower_bound=10**6)
    assert tre.buckets == [] and tre.num_trained_entities == 0


def test_bucket_gather_offsets():
    jd, td = datasets(game_arrays(5))
    jre = jgd.build_random_effect_dataset(jd, "user", "per_entity")
    tre = tgd.build_random_effect_dataset(td, "user", "per_entity")
    full = np.random.default_rng(0).normal(size=td.num_samples)
    import jax.numpy as jnp
    for jb, tb in zip(jre.buckets, tre.buckets):
        got = tb.gather_offsets(torch.from_numpy(full)).numpy()
        assert np.array_equal(np.asarray(jb.gather_offsets(jnp.asarray(full))), got)


@pytest.mark.parametrize("multiple", [1, 7, 64])
def test_pad_game_dataset_equal(multiple):
    jd, td = datasets(game_arrays(6, n=701))
    jp, jn = jgd.pad_game_dataset(jd, multiple)
    tp, tn = tgd.pad_game_dataset(td, multiple)
    assert jn == tn == 701 and tp.num_samples == jp.num_samples
    _assert_dataset_equal(jp, tp)
    if multiple == 1:
        assert tp is td
    else:
        assert float(tp.weights[701:].abs().sum()) == 0.0
        assert (tp.entity_idx["user"][701:] == -1).all()
        # buckets of the unpadded dataset stay valid on the padded one
        tre = tgd.build_random_effect_dataset(td, "user", "per_entity")
        assert int(max(b.sample_rows.max() for b in tre.buckets)) < 701


def test_pad_game_dataset_sparse_shard():
    a = game_arrays(7, n=50)
    rows = np.repeat(np.arange(50), 2)
    cols = np.tile(np.array([0, 3]), 50)
    shard = SparseShard(rows=rows, cols=cols, vals=np.ones(100), num_samples=50, feature_dim=5)
    td = tgd.build_game_dataset(labels=a["labels"], feature_shards={"wide": shard},
                                dtype=np.float64, device="cpu")
    tp, n = tgd.pad_game_dataset(td, 16)
    assert n == 50 and tp.num_samples == 64 and tp.feature_shards["wide"].num_samples == 64
    assert tp.fixed_effect_batch("wide").num_samples == 64
    with pytest.raises(TypeError, match="sparse"):
        td.host_array("shard/wide")
    # a random effect on the sparse shard is compact: [E, K] over each
    # entity's active columns (here both of the shard's columns)
    red = tgd.build_random_effect_dataset(
        tgd.build_game_dataset(labels=a["labels"], feature_shards={"wide": shard},
                               entity_keys={"user": a["users"]}, dtype=np.float64,
                               device="cpu"), "user", "wide")
    assert red.is_compact and red.table_width == 2 and red.dim == 5
    assert (red.active_cols == np.array([0, 3], dtype=np.int32)).all()


def test_fixed_effect_batch_and_host_arrays():
    jd, td = datasets(game_arrays(8))
    extra = np.random.default_rng(1).normal(size=td.num_samples)
    import jax.numpy as jnp
    jb = jd.fixed_effect_batch("global", jnp.asarray(extra))
    tb = td.fixed_effect_batch("global", torch.from_numpy(extra))
    for name in ("features", "labels", "offsets", "weights"):
        assert np.array_equal(np.asarray(getattr(jb, name)), getattr(tb, name).numpy())
    assert td.fixed_effect_batch("global").offsets is td.offsets
    td.host_cache.clear()
    for name in ("labels", "shard/global", "entity_idx/item"):
        assert np.array_equal(td.host_array(name), jd.host_array(name))
    with pytest.raises(KeyError):
        td.host_array("nope")
    assert td.shard_features("global") is td.feature_shards["global"]
    assert td.entity_indices("user") is td.entity_idx["user"]


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "SMOOTHED_HINGE_LOSS_LINEAR_SVM",
                                  "LINEAR_REGRESSION", "POISSON_REGRESSION"])
@pytest.mark.parametrize("rate", [0.25, 0.7])
def test_down_sampler_equal(task, rate):
    a = game_arrays(9)
    ref = jds.down_sampler_for_task(JTask[task], rate)
    got = tds.down_sampler_for_task(TTask[task], rate)
    assert type(ref).__name__ == type(got).__name__
    for seed in (0, 3):
        r = ref.down_sample_weights(a["labels"], a["weights"], a["unique_ids"], seed=seed)
        g = got.down_sample_weights(a["labels"], a["weights"], a["unique_ids"], seed=seed)
        assert np.array_equal(r, g)
    assert np.array_equal(jds.stable_uniform(a["unique_ids"], 11),
                          tds.stable_uniform(a["unique_ids"], 11))
    with pytest.raises(ValueError, match="rate"):
        tds.DefaultDownSampler(1.5)


def test_convert_game_dataset_and_buckets_from_numpy():
    """The JAX package's dataset and buckets carried over as numpy arrays
    equal the port's own builds."""
    jd, td = datasets(game_arrays(10))
    cd = convert.game_dataset_from_numpy(
        unique_ids=jd.unique_ids, labels=np.asarray(jd.labels), offsets=np.asarray(jd.offsets),
        weights=np.asarray(jd.weights),
        feature_shards={k: np.asarray(v) for k, v in jd.feature_shards.items()},
        entity_idx={k: np.asarray(v) for k, v in jd.entity_idx.items()},
        entity_vocabs=jd.entity_vocabs, ids=jd.ids, device="cpu")
    _assert_dataset_equal(jd, cd)
    jre = jgd.build_random_effect_dataset(jd, "user", "per_entity", active_data_upper_bound=30)
    cre = convert.random_effect_dataset_from_numpy(
        random_effect_type=jre.random_effect_type, feature_shard_id=jre.feature_shard_id,
        buckets=[{k: np.asarray(getattr(b, k)) for k in
                  ("features", "labels", "weights", "entity_rows", "sample_rows")}
                 for b in jre.buckets],
        num_entities=jre.num_entities, dim=jre.dim, device="cpu")
    _assert_buckets_equal(jre, cre)
    _assert_buckets_equal(jre, tgd.build_random_effect_dataset(
        cd, "user", "per_entity", active_data_upper_bound=30))
