"""The port's partitioned I/O against the JAX package's, on the CPU: the
contiguous assignment, read_partitioned (files and blocks modes; dense,
sparse and hybrid shards; uid-less input; given maps and vocabularies),
read_container_block_range with quarantine, the rank-local RE builder,
shard_np_dtypes, the per-rank score writer and the metadata exchanges.

Both packages run their ranks as threads over their own InProcessExchange,
reading the same Avro files written from a numpy seed; every array, map,
vocabulary and PartitionInfo must be equal (tolerance 0). The port's
DistributedKVExchange runs on two spawned gloo ranks
(``tests/torch_mesh_worker.py``), whose reads must equal the threads'.
"""

import os

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.io import avro as javro
from photon_ml_tpu.io import data_reader as jdr
from photon_ml_tpu.io import partitioned_reader as jpr
from photon_ml_tpu.io.model_io import write_scores as jwrite_scores
from photon_ml_tpu.io.score_writer import ShardedScoreWriter as JWriter
from photon_ml_tpu.parallel.multihost import SingleProcessExchange as JSingle
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io import data_reader as tdr
from photon_ml_torch.io import partitioned_reader as tpr
from photon_ml_torch.io.score_writer import ShardedScoreWriter as TWriter
from photon_ml_torch.parallel import multihost
from photon_ml_torch.parallel.distributed import last_lane_positions
from tests import torch_mesh_worker as W
from tests import torch_partitioned_parity as PP

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.mark.parametrize("seed", range(4))
def test_assign_contiguous_matches_the_jax_package(seed):
    """The same [lo, hi) runs as the JAX package's over random weights (zeros,
    ties and lists shorter than the rank count included)."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        weights = rng.integers(0, 5 if seed % 2 else 1000, size=n).tolist()
        ranks = int(rng.integers(1, 7))
        got = tpr.assign_contiguous(weights, ranks)
        assert got == jpr.assign_contiguous(weights, ranks), (weights, ranks)
        assert got[0][0] == 0 and got[-1][1] == n


READS = [("dense", 2, dict(num_files=4)), ("dense", 3, dict(num_files=1, rows_per_file=160,
                                                            block_records=16)),
         ("dense", 3, dict(num_files=5, clustered=False)),
         ("sparse", 2, dict(num_files=4)), ("sparse", 3, dict(num_files=1, rows_per_file=160,
                                                              block_records=16)),
         ("hybrid", 2, dict(num_files=4)), ("hybrid", 3, dict(num_files=2, rows_per_file=90,
                                                              block_records=10))]


@pytest.mark.parametrize("kind,ranks,kw", READS,
                         ids=[f"{k}-{r}ranks-{kw['num_files']}files" for k, r, kw in READS])
def test_read_partitioned_matches_the_jax_reader(tmp_path, kind, ranks, kw):
    """Each rank's arrays, index maps, vocabularies, intercepts, partition,
    mode, decoded bytes and entity_rank_presence equal the JAX reader's; a
    sparse shard's agreed ELL width, flat overflow length and hot ids too."""
    path = PP.write_input(tmp_path / "in", **kw)
    jparts, _ = PP.jread_ranks(path, PP.CONFIGS[kind], ranks, evaluation_id_columns=("queryId",))
    tparts, _ = PP.tread_ranks(path, PP.CONFIGS[kind], ranks, evaluation_id_columns=("queryId",))
    for j, t in zip(jparts, tparts):
        PP.assert_reads_equal(W.read_numpy(t), PP.jread_numpy(j))
        assert 0 < t.bytes_decoded < t.input_bytes_total
    assert tparts[0].mode == ("files" if kw["num_files"] >= ranks else "blocks")
    # files mode covers every byte; blocks mode counts the block payloads
    decoded = sum(t.bytes_decoded for t in tparts)
    if tparts[0].mode == "files":
        assert decoded == tparts[0].input_bytes_total
    else:
        assert 0.9 * tparts[0].input_bytes_total < decoded < tparts[0].input_bytes_total


def test_uidless_input_renumbers_globally(tmp_path):
    """Without a uid field the rows are numbered 0..N-1 across the ranks, as
    a full read numbers them, and as the JAX reader does."""
    path = PP.write_input(tmp_path / "in", num_files=3, uid=False)
    jparts, _ = PP.jread_ranks(path, PP.CONFIGS["dense"], 2)
    tparts, _ = PP.tread_ranks(path, PP.CONFIGS["dense"], 2)
    uids = np.concatenate([np.asarray(t.result.dataset.unique_ids)[: t.partition.local_n]
                           for t in tparts])
    np.testing.assert_array_equal(uids, np.arange(120))
    for j, t in zip(jparts, tparts):
        PP.assert_reads_equal(W.read_numpy(t), PP.jread_numpy(j))


def test_given_maps_and_vocabs_match(tmp_path):
    """A scoring-style read (the model's index maps and entity vocabularies
    given; only counts cross the exchange) equals the JAX reader's."""
    train = PP.write_input(tmp_path / "train", num_files=3, seed=4)
    held = PP.write_input(tmp_path / "held", num_files=2, seed=5, clustered=False)
    full = tdr.read_merged(train, W.shard_configs(PP.CONFIGS["dense"]),
                           random_effect_id_columns=("userId",), device="cpu")
    kw = dict(index_maps=full.index_maps, entity_vocabs=full.dataset.entity_vocabs)
    jparts, _ = PP.jread_ranks(held, PP.CONFIGS["dense"], 2, **kw)
    tparts, _ = PP.tread_ranks(held, PP.CONFIGS["dense"], 2, **kw)
    for j, t in zip(jparts, tparts):
        PP.assert_reads_equal(W.read_numpy(t), PP.jread_numpy(j))
        assert (t.entity_rank_presence["userId"] >= 0).all()


@pytest.mark.parametrize("kind", ["dense", "hybrid"])
def test_one_rank_is_read_merged(tmp_path, kind):
    """With one rank (no exchange, or the single-process one) the read is
    read_merged's, array for array, and its partition one block."""
    path = PP.write_input(tmp_path / "in", num_files=2)
    cfg = W.shard_configs(PP.CONFIGS[kind])
    full = tdr.read_merged(path, cfg, random_effect_id_columns=("userId",), device="cpu")
    for exchange in (None, multihost.SingleProcessExchange()):
        part = tpr.read_partitioned(path, cfg, exchange=exchange,
                                    random_effect_id_columns=("userId",), device="cpu")
        assert part.mode == "single" and part.partition == tpr.PartitionInfo(0, 1, (80,), 80)
        PP.assert_reads_equal(W.read_numpy(part), W.read_numpy(full))


def test_read_partitioned_runs_on_the_card_unless_asked(tmp_path):
    path = PP.write_input(tmp_path / "in", num_files=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpr.read_partitioned(path, W.shard_configs(PP.CONFIGS["dense"]))


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_block_range_matches_the_jax_reader(tmp_path, codec):
    """Any block range gives the JAX reader's records; a range past the end
    raises its error."""
    path = PP.write_input(tmp_path / "in", num_files=1, rows_per_file=100, block_records=16)
    f = os.path.join(path, "part-00000.avro")
    if codec == "null":
        records = list(tavro.read_container(f))
        tavro.write_container(f, PP.SCHEMA, records, codec="null", block_records=16)
    index = tavro.scan_block_index(f)
    assert index == javro.scan_block_index(f) and len(index) == 7
    full = list(tavro.read_container(f))
    for start, count in ((0, 7), (2, 3), (6, 1), (3, 0)):
        got = list(tavro.read_container_block_range(f, start, count))
        assert got == list(javro.read_container_block_range(f, start, count))
        assert got == full[16 * start: 16 * (start + count)]
        assert got == list(tavro.read_container_block_range(f, start, count, index=index))
    with pytest.raises(tavro.AvroError, match="exceeds"):
        list(tavro.read_container_block_range(f, 0, 8))


def test_block_range_quarantine_matches(tmp_path):
    """A block whose compressed payload is damaged is skipped and counted
    under quarantine, the JAX reader skipping the same records; strict reads
    raise."""
    path = PP.write_input(tmp_path / "in", num_files=1, rows_per_file=64, block_records=16)
    f = os.path.join(path, "part-00000.avro")
    index = tavro.scan_block_index(f)
    data = bytearray(open(f, "rb").read())
    mid = index[1][2] + index[1][1] // 2
    data[mid:mid + 8] = b"\xff" * 8
    open(f, "wb").write(bytes(data))
    before = len(tavro.quarantined_blocks)
    got = list(tavro.read_container_block_range(f, 0, 4, on_corrupt="quarantine"))
    assert got == list(javro.read_container_block_range(f, 0, 4, on_corrupt="quarantine"))
    assert len(got) == 48 and len(tavro.quarantined_blocks) == before + 1
    assert tavro.quarantined_blocks[-1][1] == 1
    with pytest.raises(Exception):
        list(tavro.read_container_block_range(f, 0, 4))
    # blocks mode reads through the same quarantine on every rank
    jparts, _ = PP.jread_ranks(path, PP.CONFIGS["dense"], 2, on_corrupt="quarantine")
    tparts, _ = PP.tread_ranks(path, PP.CONFIGS["dense"], 2, on_corrupt="quarantine")
    for j, t in zip(jparts, tparts):
        PP.assert_reads_equal(W.read_numpy(t), PP.jread_numpy(j))
    assert sum(t.partition.local_n for t in tparts[:1]) and tparts[0].partition.total_true_rows == 48


@pytest.mark.parametrize("clustered", [True, False])
def test_partitioned_re_builder_matches(tmp_path, clustered):
    """build_random_effect_dataset_partitioned: every rank's buckets (lanes
    padded to the common count, sample rows shifted by the base row) equal
    the JAX builder's, with lane_multiple 2."""
    path = PP.write_input(tmp_path / "in", num_files=4, clustered=clustered, uneven=True,
                          users_per_file=6)
    jparts, jex = PP.jread_ranks(path, PP.CONFIGS["dense"], 2)
    tparts, tex = PP.tread_ranks(path, PP.CONFIGS["dense"], 2)
    kw = dict(bucket_sizes=(8, 32, 128), lane_multiple=2)

    def build(module, parts, ex, r):
        return module.build_random_effect_dataset_partitioned(
            parts[r].result.dataset, "userId", "perUser", partition=parts[r].partition,
            exchange=ex[r], entity_rank_presence=parts[r].entity_rank_presence["userId"], **kw)

    jbuilt = PP.on_threads(2, lambda r: build(jgd, jparts, jex, r))
    tbuilt = PP.on_threads(2, lambda r: build(tgd, tparts, tex, r))
    for r, (j, t) in enumerate(zip(jbuilt, tbuilt)):
        assert (t.num_entities, t.dim) == (j.num_entities, j.dim)
        assert len(t.buckets) == len(j.buckets) > 0
        for jb, tb in zip(j.buckets, t.buckets):
            for f in ("features", "labels", "weights", "entity_rows", "sample_rows"):
                np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                              np.asarray(getattr(jb, f)), err_msg=f)
            rows = tb.sample_rows.numpy()
            base = tparts[r].partition.base_row
            assert ((rows[rows >= 0] >= base)
                    & (rows[rows >= 0] < base + tparts[r].partition.block_rows)).all()
            assert tb.num_entities % 2 == 0
    spanning = int((tparts[0].entity_rank_presence["userId"] > 1).sum())
    assert (spanning > 0) == (not clustered)


def test_shard_np_dtypes_matches():
    for spec in ({"a": {}}, {"a": {"dtype": "bfloat16"}, "b": {}}):
        t = tdr.shard_np_dtypes({k: tdr.FeatureShardConfiguration(feature_bags=("f",), **v)
                                 for k, v in spec.items()})
        j = jdr.shard_np_dtypes({k: jdr.FeatureShardConfiguration(feature_bags=("f",), **v)
                                 for k, v in spec.items()})
        assert t == j


def test_sharded_score_writer_parts_match_the_one_rank_writer(tmp_path):
    """Two ranks' parts, in part order, hold the one-rank writer's records;
    each part's bytes are the JAX package's part of the same rows."""
    rng = np.random.default_rng(7)
    n, split = 111, 60
    scores, uids = rng.normal(size=n), np.arange(n)
    labels, weights = rng.normal(size=n), np.ones(n)
    TWriter(tmp_path / "ref").write(scores, model_id="m", uids=uids, labels=labels,
                                    weights=weights)
    out = tmp_path / "scores"
    os.makedirs(out)
    (out / "part-00007.avro").write_bytes(b"stale")
    exchanges = multihost.InProcessExchange.create_group(2)

    def write(r):
        sl = slice(0, split) if r == 0 else slice(split, n)
        return TWriter(out, exchange=exchanges[r]).write(
            scores[sl], model_id="m", uids=uids[sl], labels=labels[sl], weights=weights[sl])

    paths = PP.on_threads(2, write)
    assert sorted(os.listdir(out)) == ["part-00000.avro", "part-00001.avro"]
    assert [os.path.basename(p[0]) for p in paths] == sorted(os.listdir(out))
    got = [r for p in sorted(os.listdir(out)) for r in tavro.read_container(out / p)]
    assert got == list(tavro.read_container(tmp_path / "ref" / "part-00000.avro"))
    for r, sl in enumerate((slice(0, split), slice(split, n))):
        jwrite_scores(str(tmp_path / f"j{r}.avro"), scores[sl], model_id="m", uids=uids[sl],
                      labels=labels[sl], weights=weights[sl])
        assert (out / f"part-{r:05d}.avro").read_bytes() == \
            (tmp_path / f"j{r}.avro").read_bytes()


def test_sharded_score_writer_one_rank_keeps_the_layout(tmp_path):
    scores = np.random.default_rng(9).normal(size=50)
    JWriter(str(tmp_path / "j"), exchange=JSingle()).write(scores, model_id="m",
                                                            uids=np.arange(50))
    for ex in (None, multihost.SingleProcessExchange()):
        TWriter(tmp_path / "t", exchange=ex).write(scores, model_id="m", uids=np.arange(50))
        assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
        for name in os.listdir(tmp_path / "j"):
            assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes()


def test_in_process_exchange_orders_and_names_the_missing_rank():
    exchanges = multihost.InProcessExchange.create_group(3)
    got = PP.on_threads(3, lambda r: [exchanges[r].allgather("t", r), exchanges[r].allgather(
        "t", -r), exchanges[r].barrier("b")])
    assert all(g[:2] == [[0, 1, 2], [0, -1, -2]] for g in got)
    lonely = multihost.InProcessExchange.create_group(2, timeout=0.2)
    with pytest.raises(TimeoutError, match=r"exchange 'x'.*rank\(s\) 1 did not participate"):
        lonely[0].allgather("x", 1)


def test_assemble_partitioned_checks_every_ranks_blocks():
    """The rank's own blocks come back on its device; blocks whose shapes
    differ between ranks raise, naming the rank."""
    exchanges = multihost.InProcessExchange.create_group(2)
    same = PP.on_threads(2, lambda r: multihost.assemble_partitioned(
        {"x": np.full((4, 2), float(r)), "b": [torch.arange(3)]}, exchanges[r], device="cpu"))
    assert torch.equal(same[1]["x"], torch.full((4, 2), 1.0, dtype=torch.float64))
    assert isinstance(same[0]["b"][0], torch.Tensor)
    exchanges = multihost.InProcessExchange.create_group(2)
    with pytest.raises(ValueError, match=r"rank [01]'s blocks differ from rank [01]'s"):
        PP.on_threads(2, lambda r: multihost.assemble_partitioned(
            {"x": np.zeros((4 + r, 2))}, exchanges[r], device="cpu"))


def test_last_lane_positions():
    """Of the lanes that share an entity row, only the one last in the
    given order is written; pad rows never are."""
    pad = int(tgd.PAD_ENTITY_ROW)
    rows = np.array([3, 5, pad, 3, 7, 5, -1])
    assert last_lane_positions(rows, np.arange(7)).tolist() == [3, 4, 5]
    assert last_lane_positions(rows, -np.arange(7)).tolist() == [0, 1, 4]
    lanes = {"entity_rows": torch.tensor([1, 2], dtype=torch.int32),
             "sample_rows": torch.zeros((2, 3), dtype=torch.int32),
             "features": torch.ones((2, 3, 2))}
    out = tgd.pad_lanes_to(lanes, 5)
    assert out["entity_rows"].tolist() == [1, 2, pad, pad, pad]
    assert out["sample_rows"][2:].eq(-1).all() and out["features"][2:].eq(0).all()
    with pytest.raises(ValueError, match="down to"):
        tgd.pad_lanes_to(lanes, 1)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Two gloo ranks: the key-value exchange, and read_partitioned through it."""
    base = tmp_path_factory.mktemp("partitioned-io")
    hybrid = PP.write_input(base / "hybrid", num_files=3, seed=3)
    blocks = PP.write_input(base / "blocks", num_files=1, rows_per_file=100, block_records=16)
    tasks = [dict(kind="exchange", timeout=2.0),
             dict(kind="partitioned_read", path=hybrid, configs=PP.CONFIGS["hybrid"],
                  re_columns=["userId"]),
             dict(kind="partitioned_read", path=blocks, configs=PP.CONFIGS["dense"],
                  re_columns=["userId"])]
    ranks = base / "ranks"
    ranks.mkdir()
    return {"results": W.spawn_ranks(2, tasks, ranks), "paths": (hybrid, blocks)}


def test_kv_exchange_on_two_gloo_ranks(gloo_runs):
    """DistributedKVExchange over the group's store: payloads in rank order,
    the same tag twice kept apart, and ranks whose calls diverge each raising
    TimeoutError that names the key it waited for and the rank that should
    have published it."""
    got = gloo_runs["results"][0]
    for out in got:
        assert out["type"] == "DistributedKVExchange"
        assert out["first"] == [{"rank": 0, "x": [0]}, {"rank": 1, "x": [1, 1]}]
        assert out["second"] == [0, 10]
    for rank, (tag, missing) in enumerate((("lonely", 1), ("elsewhere", 0))):
        message = got[rank]["timeout"]
        assert f"/{tag}/{missing}' was never published" in message, message
        assert f"rank(s) {missing} did not participate" in message
        assert f"observed on rank {rank} after 2 s" in message


@pytest.mark.parametrize("case", [1, 2], ids=["hybrid-files", "dense-blocks"])
def test_gloo_reads_equal_the_threads(gloo_runs, case):
    """read_partitioned on gloo ranks (the key-value exchange) equals the
    same read on threads, and so the JAX reader's."""
    path = gloo_runs["paths"][case - 1]
    kind = "hybrid" if case == 1 else "dense"
    jparts, _ = PP.jread_ranks(path, PP.CONFIGS[kind], 2)
    for got, j in zip(gloo_runs["results"][case], jparts):
        PP.assert_reads_equal(got, PP.jread_numpy(j))
