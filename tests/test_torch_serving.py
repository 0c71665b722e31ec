"""The port's serving layer on the CPU: ``slice_game_dataset`` and
``concat_game_datasets`` against the JAX package's; the resident scorer
against the JAX package's ``ResidentScorer.score`` (dense, ELL, hybrid,
compact layouts, every bucket, a bucket miss that splits; rel 1e-12 in f64,
1e-6·max|score| in f32) and bitwise against the port's ``score_dataset``;
the one-rank mesh; the micro-batching server; hot swaps; the serve driver
against the port's scoring driver. The card's graph captures are held in
``tests/test_torch_serving_cuda.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.models.matrix_factorization import MatrixFactorizationModel as JMF
from photon_ml_tpu.serving import ResidentScorer as JResident
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data import sparse_batch as tsb
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.parallel.scoring import MIN_NNZ_BUCKET, DistributedScorer, nnz_bucket
from photon_ml_torch.serving import (
    DEFAULT_MICROBATCH_SHAPES,
    MicroBatchServer,
    ModelSwapError,
    RequestError,
    ResidentScorer,
    ServeError,
    ServeTimeout,
)
from photon_ml_torch.telemetry import serving_counters
from tests import torch_parity  # noqa: F401  (the JAX compilation cache's lock)

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

LAYOUTS = ["dense", "ell", "hybrid", "compact", "compact_dense"]
SHAPES = (8, 32)
N_USERS, N_ITEMS = 9, 7


def _arrays(layout: str, seed: int = 0, n: int = 53, d: int = 12, d_re: int = 4,
            d_sparse: int = 4000, per_row: int = 6) -> dict:
    """One fixture's host arrays and model values. Sparse layouts give row 3
    2100 entries (more than one gather chunk); the last key of each entity
    vocabulary is left out, so its rows are unseen (index -1)."""
    r = np.random.default_rng(seed)
    users = np.array([f"u{i}" for i in r.integers(0, N_USERS + 1, size=n)])
    items = np.array([f"i{i}" for i in r.integers(0, N_ITEMS, size=n)])
    a = {"labels": r.normal(size=n), "offsets": r.normal(scale=0.1, size=n),
         "weights": r.uniform(0.5, 1.5, size=n), "users": users, "items": items, "n": n,
         "vocabs": {"userId": np.array([f"u{i}" for i in range(N_USERS)]),
                    "itemId": np.array([f"i{i}" for i in range(N_ITEMS)])},
         "shards": {}, "models": {}}
    task = "LINEAR_REGRESSION"
    if layout in ("dense", "compact_dense"):
        a["shards"]["g"] = r.normal(size=(n, d))
        a["shards"]["u"] = r.normal(size=(n, d_re))
        a["models"]["fe"] = {"kind": "fixed", "means": r.normal(size=d), "task": task,
                             "feature_shard_id": "g"}
    else:
        counts = np.full(n, per_row)
        counts[3] = 2100
        rows = np.repeat(np.arange(n), counts)
        cols = r.integers(0, d_sparse, size=len(rows))
        cols[rows == 3] = r.choice(d_sparse, size=2100, replace=False)
        a["coo"] = (rows, cols, r.normal(size=len(rows)), d_sparse)
        a["models"]["fe"] = {"kind": "fixed", "means": r.normal(size=d_sparse) / 30.0,
                             "task": task, "feature_shard_id": "giant"}
    re = {"kind": "random", "entity_keys": a["vocabs"]["userId"], "random_effect_type": "userId",
          "task": task}
    if layout == "dense":
        a["models"]["re"] = dict(re, coefficients=r.normal(size=(N_USERS, d_re)),
                                 feature_shard_id="u")
        a["models"]["mf"] = {"kind": "matrix_factorization",
                             "row_factors": r.normal(size=(N_USERS, 3)),
                             "col_factors": r.normal(size=(N_ITEMS, 3)),
                             "row_effect_type": "userId", "col_effect_type": "itemId",
                             "row_keys": a["vocabs"]["userId"], "col_keys": a["vocabs"]["itemId"],
                             "task": task}
    elif layout.startswith("compact"):
        dim, k = (d_re, 3) if layout == "compact_dense" else (d_sparse, 40)
        active = np.sort(np.stack([r.choice(dim, size=k, replace=False)
                                   for _ in range(N_USERS)]), axis=1)
        active[0, -1] = dim  # a pad slot
        a["models"]["re"] = dict(re, coefficients=r.normal(size=(N_USERS, k)),
                                 active_cols=active.astype(np.int32), feature_dim=dim,
                                 feature_shard_id="u" if layout == "compact_dense" else "giant")
    a["layout"] = layout
    return a


def _sparse_kw(layout):
    return {"ell": dict(ell_width=4), "hybrid": dict(hybrid_policy="hybrid")}.get(layout, {})


def tdataset(a, dtype=np.float64, rows=None):
    """The port's dataset of the fixture (``rows``: a row range of it)."""
    shards = {k: v.astype(dtype) for k, v in a["shards"].items()}
    if "coo" in a:
        kw = _sparse_kw(a["layout"])
        if "hybrid_policy" in kw:
            kw["hybrid_policy"] = tsb.HybridPolicy(hot_cols=8)
        rows_, cols, vals, dim = a["coo"]
        shards["giant"] = tsb.SparseShard(rows=rows_, cols=cols, vals=vals.astype(dtype),
                                          num_samples=a["n"], feature_dim=dim, **kw)
    return tgd.build_game_dataset(
        labels=a["labels"], feature_shards=shards, offsets=a["offsets"], weights=a["weights"],
        entity_keys={"userId": a["users"], "itemId": a["items"]}, entity_vocabs=a["vocabs"],
        dtype=dtype, device="cpu")


def jdataset(a, dtype=np.float64):
    shards = {k: v.astype(dtype) for k, v in a["shards"].items()}
    if "coo" in a:
        kw = _sparse_kw(a["layout"])
        if "hybrid_policy" in kw:
            kw["hybrid_policy"] = jsb.HybridPolicy(hot_cols=8)
        rows_, cols, vals, dim = a["coo"]
        shards["giant"] = jsb.SparseShard(rows=rows_, cols=cols, vals=vals.astype(dtype),
                                          num_samples=a["n"], feature_dim=dim, **kw)
    return jgd.build_game_dataset(
        labels=a["labels"], feature_shards=shards, offsets=a["offsets"], weights=a["weights"],
        entity_keys={"userId": a["users"], "itemId": a["items"]}, entity_vocabs=a["vocabs"],
        dtype=dtype)


def magnitudes(a) -> dict:
    """The fixture with every feature, offset and parameter value replaced by
    its magnitude: its scores are each row's Σ|terms|, the scale a sum's
    rounding error is relative to."""
    b = dict(a, offsets=np.abs(a["offsets"]),
             shards={k: np.abs(v) for k, v in a["shards"].items()},
             models={cid: {k: np.abs(v) if k in ("means", "coefficients", "row_factors",
                                                 "col_factors") else v for k, v in m.items()}
                     for cid, m in a["models"].items()})
    if "coo" in a:
        rows, cols, vals, dim = a["coo"]
        b["coo"] = (rows, cols, np.abs(vals), dim)
    return b


def tmodel(a, dtype=np.float64, scale: float = 1.0):
    plain = {}
    for cid, m in a["models"].items():
        m = dict(m)
        for key in ("means", "coefficients", "row_factors", "col_factors"):
            if key in m:
                m[key] = (scale * m[key]).astype(dtype)
        plain[cid] = m
    return convert.game_model_from_numpy(plain, device="cpu")


def jmodel(a, dtype=np.float64):
    out = {}
    task = JTask.LINEAR_REGRESSION
    for cid, m in a["models"].items():
        if m["kind"] == "fixed":
            out[cid] = jgame.FixedEffectModel(
                glm=JGLM(JCoefficients(means=jnp.asarray(m["means"].astype(dtype))), task),
                feature_shard_id=m["feature_shard_id"])
        elif m["kind"] == "random":
            out[cid] = jgame.RandomEffectModel(
                coefficients=jnp.asarray(m["coefficients"].astype(dtype)),
                entity_keys=m["entity_keys"], random_effect_type=m["random_effect_type"],
                feature_shard_id=m["feature_shard_id"], task=task,
                active_cols=m.get("active_cols"), feature_dim=m.get("feature_dim"))
        else:
            out[cid] = JMF(row_factors=jnp.asarray(m["row_factors"].astype(dtype)),
                           col_factors=jnp.asarray(m["col_factors"].astype(dtype)),
                           row_effect_type=m["row_effect_type"],
                           col_effect_type=m["col_effect_type"], row_keys=m["row_keys"],
                           col_keys=m["col_keys"], task=task)
    return jgame.GameModel(models=out)


def eager_bucketed(scorer: DistributedScorer, ds, shapes=SHAPES) -> np.ndarray:
    """``score_dataset`` of each micro-batch the resident scorer makes of
    ``ds`` (split at the largest bucket, each part padded to its bucket by
    ``pad_game_dataset_to``), its true rows kept."""
    out = []
    for lo in range(0, ds.num_samples, shapes[-1]):
        part = tgd.slice_game_dataset(ds, lo, min(lo + shapes[-1], ds.num_samples)) \
            if ds.num_samples > shapes[-1] else ds
        bucket = next(s for s in shapes if s >= part.num_samples)
        padded, n = tgd.pad_game_dataset_to(part, bucket)
        out.append(scorer.score_dataset(padded)[:n])
    return np.concatenate(out)


def _requests(n: int) -> list:
    """Row ranges that reach every bucket of SHAPES (1, 8 and 9 rows:
    buckets 8, 8, 32) and one past the largest (41 rows: a split)."""
    bounds, lo = [], 0
    for size in (1, 8, 9, 41):
        hi = min(lo + size, n)
        bounds.append((lo, hi))
        lo = hi
    return bounds


# -- slice and concat --------------------------------------------------------


def _assert_datasets_equal(t, j):
    assert t.num_samples == j.num_samples
    for name in ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(t.host_array(name), np.asarray(j.host_array(name)))
    np.testing.assert_array_equal(t.unique_ids, j.unique_ids)
    for k, v in j.feature_shards.items():
        tv = t.feature_shards[k]
        if isinstance(v, jsb.SparseShard):
            assert tv.num_samples == v.num_samples and tv.feature_dim == v.feature_dim
            for x, y in zip(tv.coalesced(), v.coalesced()):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert tv.hybrid_policy is not None or v.hybrid_policy is None
        else:
            np.testing.assert_array_equal(t.host_array(f"shard/{k}"), np.asarray(v))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    for k in j.entity_idx:
        np.testing.assert_array_equal(t.entity_idx[k].numpy(), np.asarray(j.entity_idx[k]))
        np.testing.assert_array_equal(t.host_array(f"entity_idx/{k}"),
                                      np.asarray(j.entity_idx[k]))
    assert set(t.entity_vocabs) == set(j.entity_vocabs)


@pytest.mark.parametrize("layout", ["dense", "hybrid"])
def test_slice_and_concat_match_the_jax_functions(layout):
    """Row slices and their concatenation equal the JAX package's, array for
    array, and concatenating the slices gives back the whole dataset."""
    a = _arrays(layout)
    t, j = tdataset(a), jdataset(a)
    bounds = [(0, 5), (5, 6), (6, 30), (30, a["n"])]
    tparts = [tgd.slice_game_dataset(t, lo, hi) for lo, hi in bounds]
    jparts = [jgd.slice_game_dataset(j, lo, hi) for lo, hi in bounds]
    for tp, jp in zip(tparts, jparts):
        _assert_datasets_equal(tp, jp)
    tcat, jcat = tgd.concat_game_datasets(tparts), jgd.concat_game_datasets(jparts)
    _assert_datasets_equal(tcat, jcat)
    _assert_datasets_equal(tcat, j)
    with pytest.raises(ValueError, match="out of range"):
        tgd.slice_game_dataset(t, 4, 4)


def test_concat_rejects_a_vocab_mismatch():
    """Another entity vocabulary is refused with the JAX package's message."""
    a = _arrays("dense")
    t, j = tdataset(a), jdataset(a)
    other = dataclasses.replace(t, entity_vocabs=dict(t.entity_vocabs,
                                                      userId=np.array(["x", "y"])))
    jother = dataclasses.replace(j, entity_vocabs=dict(j.entity_vocabs,
                                                       userId=np.array(["x", "y"])))
    with pytest.raises(ValueError) as jerr:
        jgd.concat_game_datasets([j, jother])
    with pytest.raises(ValueError) as terr:
        tgd.concat_game_datasets([t, other])
    assert str(terr.value) == str(jerr.value)
    assert "'userId' entity vocab" in str(terr.value)


# -- the resident scorer -----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_resident_scores_match_the_jax_resident_scorer(layout, dtype):
    """Every bucket and a split request: the port's resident scores against
    the JAX package's ``ResidentScorer.score`` (rel 1e-12 in f64, 1e-6 in
    f32, of the request's largest score or Σ|terms| of a row: row 3's 2100
    f32 terms sum in another order in each package), and bitwise equal to
    the port's ``DistributedScorer.score_dataset`` of the same padded
    micro-batches (of the unpadded rows within the same limit: a CPU
    reduction may round by its shape)."""
    np_dtype = np.dtype(dtype)
    a = _arrays(layout)
    t, j = tdataset(a, np_dtype), jdataset(a, np_dtype)
    tm, jm = tmodel(a, np_dtype), jmodel(a, np_dtype)
    ours, theirs = ResidentScorer(tm, shapes=SHAPES), JResident(jm, shapes=SHAPES)
    eager = DistributedScorer(tm)
    terms = DistributedScorer(tmodel(magnitudes(a))).score_dataset(tdataset(magnitudes(a)))
    rel = 1e-12 if dtype == "float64" else 1e-6
    for lo, hi in _requests(a["n"]):
        got = ours.score(tgd.slice_game_dataset(t, lo, hi))
        want = theirs.score(jgd.slice_game_dataset(j, lo, hi))
        assert got.dtype == np_dtype and got.shape == (hi - lo,)
        limit = rel * max(np.abs(want).max(), terms[lo:hi].max())
        np.testing.assert_allclose(got, want, rtol=rel, atol=limit)
        part = tgd.slice_game_dataset(t, lo, hi)
        np.testing.assert_array_equal(got, eager_bucketed(eager, part))
        np.testing.assert_allclose(got, eager.score_dataset(part), rtol=0, atol=limit)
    buckets = {sig[0] for sig in ours.signatures}
    assert buckets == set(SHAPES)
    assert ours.captures == 0  # the CPU runs the program eagerly


def test_entry_axes_pad_to_powers_of_two_and_plans_match():
    """A sparse request's entry axis pads to a power of two of at least
    MIN_NNZ_BUCKET with inert pads, and the host plan equals the device
    plan ``segment_plan`` builds (row pointers and the long rows' chunks)."""
    a = _arrays("compact")
    t = tdataset(a)
    scorer = DistributedScorer(tmodel(a))
    part = tgd.slice_game_dataset(t, 0, 5)
    inputs, layouts, sig = scorer.resident_inputs(part, 8)
    assert layouts == {"fe": "sparse", "re": "entries"}
    fe = dict(zip(("cid", "target", "long", "count"), sig[0]))
    nnz = len(part.feature_shards["giant"].coalesced()[2])
    assert 2100 < nnz <= 2124
    assert fe == {"cid": "fe", "target": 4096, "long": 1, "count": 2}
    assert nnz_bucket(nnz) == 4096 and nnz_bucket(3) == MIN_NNZ_BUCKET
    vals, rows = inputs["fe/vals"][0], inputs["fe/rows"][0]
    assert len(vals) == 4096 and not vals[nnz:].any() and (rows[nnz:] == rows[nnz - 1]).all()
    k = a["models"]["re"]["coefficients"].shape[1]
    assert (inputs["re/cols"][0][-1] == k)  # the pad's slot: entity 0's scratch slot
    row_ptr, chunks = sparse_gather.segment_plan(torch.from_numpy(rows), 8)
    np.testing.assert_array_equal(inputs["fe/row_ptr"][0], row_ptr.numpy())
    np.testing.assert_array_equal(inputs["fe/chunk_rows"][0], chunks.rows.numpy())
    np.testing.assert_array_equal(inputs["fe/chunk_ptr"][0], chunks.chunk_ptr.numpy())
    assert chunks.count == fe["count"]


def test_signatures_stay_bounded_over_a_long_replay():
    """1000 one-row requests of a sparse model, after a warm-up: every one
    lands in a signature the warm-up made (the CPU captures nothing)."""
    a = _arrays("ell", seed=1, n=400)
    rows, cols, vals, dim = a["coo"]
    keep = rows != 3  # one-row requests of 6 entries each
    a["coo"] = (np.searchsorted(np.flatnonzero(np.bincount(rows[keep], minlength=400)),
                                rows[keep]), cols[keep], vals[keep], dim)
    a.update(n=399, labels=a["labels"][:399], offsets=a["offsets"][:399],
             weights=a["weights"][:399], users=a["users"][:399], items=a["items"][:399])
    t = tdataset(a)
    scorer = ResidentScorer(tmodel(a), shapes=SHAPES)
    scorer.warm(tgd.slice_game_dataset(t, 0, 1))
    warm = scorer.signatures
    assert len(warm) == len(SHAPES)
    for i in range(1000):
        lo = i % a["n"]
        scorer.score(tgd.slice_game_dataset(t, lo, lo + 1))
    assert scorer.signatures == warm


def test_one_rank_mesh_scores_as_without_a_mesh():
    """Over the port's one-process in-memory mesh the resident scores equal
    those with mesh=None; shapes must divide the data axis (1 here)."""
    from photon_ml_torch.parallel import mesh as mesh_ops
    from photon_ml_torch.parallel import multihost

    a = _arrays("compact")
    t, m = tdataset(a), tmodel(a)
    want = ResidentScorer(m, shapes=SHAPES).score(t)
    multihost.initialize(device="cpu")
    try:
        got = ResidentScorer(m, shapes=SHAPES, mesh=mesh_ops.make_mesh()).score(t)
    finally:
        multihost.shutdown()
    np.testing.assert_array_equal(got, want)


def test_shapes_are_checked_with_the_jax_messages():
    m = tmodel(_arrays("dense"))
    for shapes, jmatch in (((48,), "not a positive power of two"), ((32, 8), "ascending"),
                           ((), "at least one")):
        with pytest.raises(ValueError, match=jmatch):
            ResidentScorer(m, shapes=shapes)
    assert DEFAULT_MICROBATCH_SHAPES == (64, 256, 1024)


def test_bf16_is_close_but_not_required_bitwise():
    a = _arrays("dense")
    t = tdataset(a, np.float32)
    m = tmodel(a, np.float32)
    exact = ResidentScorer(m, shapes=SHAPES).score(t)
    half = ResidentScorer(m, shapes=SHAPES, bf16=True).score(t)
    assert half.dtype == np.float32
    assert np.abs(half - exact).max() <= 0.05 * np.abs(exact).max()


def test_gauges_and_resident_bytes():
    """The pad fraction and signature gauges, and the resident bytes: one
    copy of the model's parameters for its layout."""
    serving_counters.reset_serving_metrics()
    a = _arrays("dense")
    t, m = tdataset(a), tmodel(a)
    scorer = ResidentScorer(m, shapes=SHAPES)
    scorer.score(tgd.slice_game_dataset(t, 0, 5))
    assert serving_counters.pad_fraction() == pytest.approx(3 / 8)
    reg = serving_counters.default_registry()
    assert reg.gauge(serving_counters.COMPILED_SIGNATURES).value == 1
    params = sum(v.nbytes for mm in a["models"].values() for k, v in mm.items()
                 if k in ("means", "coefficients", "row_factors", "col_factors"))
    assert scorer._scorer.resident_params_bytes() == params
    assert reg.gauge(serving_counters.RESIDENT_PARAMS_BYTES).value == params


# -- hot swaps ---------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_equal_layout_swap_scores_the_new_model(layout):
    """The new model's scores, bitwise its own ``score_dataset``, through the
    same resident buffers (their addresses unchanged)."""
    a = _arrays(layout)
    t = tdataset(a)
    old, new = tmodel(a), tmodel(a, scale=-0.5)
    scorer = ResidentScorer(old, shapes=SHAPES)
    before = scorer.score(t)
    params = [tt for p in scorer._scorer._resident.values() for d in p.values()
              for tt in d.values()]
    addresses = [tt.data_ptr() for tt in params]
    scorer.swap_model(new)
    after = scorer.score(t)
    np.testing.assert_array_equal(after, DistributedScorer(new).score_dataset(t))
    np.testing.assert_array_equal(before, DistributedScorer(old).score_dataset(t))
    assert [tt.data_ptr() for tt in params] == addresses
    assert scorer.model is new


def test_a_racing_swap_never_mixes_two_models_in_a_micro_batch():
    """Four swap threads flip the model while the scorer scores, with a short
    switch interval: every micro-batch's scores are wholly one model's (a
    swap's copies and a micro-batch's replay share one lock)."""
    import sys

    a = _arrays("compact")
    t = tdataset(a)
    one, two = tmodel(a), tmodel(a, scale=3.0)
    scorer = ResidentScorer(one, shapes=SHAPES)
    part = tgd.slice_game_dataset(t, 0, 20)
    want = {id(m): DistributedScorer(m).score_dataset(part) for m in (one, two)}
    scorer.score(part)
    stop = threading.Event()

    def swapper():
        while not stop.is_set():
            scorer.swap_model(two)
            scorer.swap_model(one)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=swapper) for _ in range(4)]
    try:
        for th in threads:
            th.start()
        for _ in range(200):
            got = scorer.score(part)
            assert any(np.array_equal(got, w) for w in want.values())
    finally:
        stop.set()
        for th in threads:
            th.join(30)
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)


def test_layout_changing_swap_is_refused_and_the_old_model_serves():
    a = _arrays("dense")
    t = tdataset(a)
    scorer = ResidentScorer(tmodel(a), shapes=SHAPES)
    before = scorer.score(t)
    wider = dict(a, models=dict(a["models"], fe=dict(a["models"]["fe"],
                                                      means=np.ones(13))))
    with pytest.raises(ModelSwapError, match=r"fe/w \(\(12,\):float64 -> \(13,\):float64\)"):
        scorer.swap_model(tmodel(wider))
    np.testing.assert_array_equal(scorer.score(t), before)


# -- the micro-batching server -----------------------------------------------


def _one_row_requests(t):
    return [tgd.slice_game_dataset(t, i, i + 1) for i in range(t.num_samples)]


def test_server_coalesces_and_matches_bitwise():
    a = _arrays("compact")
    t = tdataset(a)
    scorer = ResidentScorer(tmodel(a), shapes=SHAPES)
    want = DistributedScorer(scorer.model).score_dataset(t)
    serving_counters.reset_serving_metrics()
    with MicroBatchServer(scorer, max_wait_ms=200) as server:
        futures = [server.submit(r) for r in _one_row_requests(t)]
        got = np.concatenate([f.result(30) for f in futures])
    np.testing.assert_array_equal(got, want)
    reg = serving_counters.default_registry()
    assert reg.counter(serving_counters.BATCHES).value < t.num_samples
    assert reg.histogram(serving_counters.LATENCY_MS).count == t.num_samples


class _Gated:
    """A scorer stand-in whose ``score`` blocks until released and records
    each batch's rows."""

    def __init__(self, shapes=(8,), fail_on=None):
        self.shapes, self.batches, self.release = shapes, [], threading.Event()
        self.fail_on = fail_on

    def score(self, ds):
        self.release.wait(30)
        self.batches.append(ds.num_samples)
        if self.fail_on is not None:
            self.fail_on(ds)
        return ds.host_array("labels").copy()


def test_server_flushes_on_max_rows():
    t = tdataset(_arrays("dense"))
    gated = _Gated()
    gated.release.set()
    with MicroBatchServer(gated, max_wait_ms=5000, max_batch_rows=4) as server:
        futures = [server.submit(r) for r in _one_row_requests(t)[:12]]
        for f in futures:
            f.result(30)
    assert max(gated.batches) == 4 and sum(gated.batches) == 12


def test_server_rejects_a_submit_after_stop_and_fails_queued_futures():
    t = tdataset(_arrays("dense"))
    gated = _Gated()
    server = MicroBatchServer(gated, max_wait_ms=1).start()
    reqs = _one_row_requests(t)
    first = server.submit(reqs[0])
    queued = [server.submit(r) for r in reqs[1:4]]
    server.stop()  # the consumer is blocked in score(): its join times out
    gated.release.set()
    for f in queued:
        with pytest.raises(ServeError, match="stopped before serving"):
            f.result(5)
    with pytest.raises(ServeError, match="not running"):
        server.submit(reqs[5])
    first.result(30)
    with pytest.raises(ServeTimeout):
        type(first)("r").result(0.01)


def test_a_poisoned_request_fails_alone_with_its_id():
    t = tdataset(_arrays("dense"))

    def poison(ds):
        if (ds.host_array("labels") == 12345.0).any():
            raise ValueError("poisoned feature block")

    gated = _Gated(fail_on=poison)
    gated.release.set()
    reqs = _one_row_requests(t)[:6]
    bad = tgd.slice_game_dataset(t, 6, 7)
    bad.host_cache["labels"] = np.array([12345.0])
    with MicroBatchServer(gated, max_wait_ms=200) as server:
        futures = [server.submit(r) for r in reqs[:3]]
        bad_f = server.submit(bad, request_id="the-bad-one")
        futures += [server.submit(r) for r in reqs[3:]]
        for i, f in enumerate(futures):
            np.testing.assert_array_equal(f.result(30), reqs[i].host_array("labels"))
        with pytest.raises(RequestError, match="'the-bad-one' failed: ValueError: poisoned"):
            bad_f.result(30)


def test_a_sticky_cuda_error_stops_the_server():
    """An illegal address leaves the CUDA context unusable: every request of
    the batch and of the queue fails with it, and the server stops."""
    t = tdataset(_arrays("dense"))

    def broken(ds):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    gated = _Gated(fail_on=broken)
    server = MicroBatchServer(gated, max_wait_ms=50).start()
    reqs = _one_row_requests(t)
    futures = [server.submit(r) for r in reqs[:5]]
    gated.release.set()
    for f in futures:
        with pytest.raises(ServeError, match="CUDA context failed") as err:
            f.result(30)
        assert "illegal memory access" in str(err.value.__cause__)
    assert len(gated.batches) == 1  # no request was scored alone afterwards
    with pytest.raises(ServeError, match="not running"):
        server.submit(reqs[6])
    server.stop()


# -- the serve driver --------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from photon_ml_torch.cli import game_training_driver
    from tests import torch_driver_parity as DP

    base = tmp_path_factory.mktemp("serve-driver")
    DP.write_music(base)
    game_training_driver.main(DP.training_args(
        base, base / "out", [*DP.FE_ARGS, *DP.PER_USER_ARGS,
                             "--coordinate-descent-iterations", "1"], validation=False),
        device="cpu")
    return base


def _serve(trained, out, **kw):
    from photon_ml_torch.cli import serve_driver

    args = dict(requests_avro=str(trained / "test"), model_input_dir=str(trained / "out" / "best"),
                output_dir=str(out), microbatch_shapes="32,128", request_rows=4, max_wait_ms=5,
                device="cpu")
    args.update(kw)
    return serve_driver.run(**args)


def test_serve_driver_matches_the_scoring_driver(trained, tmp_path):
    """The summary (the JAX driver's keys, no capture on the CPU), and the
    resident path through the micro-batching server bitwise equal to the
    port's scoring driver's scores of the same rows."""
    from photon_ml_torch.cli import game_scoring_driver
    from photon_ml_torch.cli.game_scoring_driver import _load_scoring_model
    from photon_ml_torch.io import avro as tavro
    from photon_ml_torch.io.partitioned_reader import read_partitioned

    s = _serve(trained, tmp_path / "serve")
    assert s["num_requests"] == 100 and s["num_rows"] == 400
    assert s["scores_per_sec"] > 0 and s["scores_per_sec_unbatched"] > 0
    assert np.isfinite(s["latency_ms_p95"]) and 0 <= s["pad_fraction"] < 1
    assert s["compiled_signatures"] <= 2 and s["warm_compiles"] == s["replay_compiles"] == 0
    assert s["swap"] is None and s["program_compiles"] is None
    on_disk = json.loads((tmp_path / "serve" / "serving-summary.json").read_text())
    assert set(on_disk) == set(s)

    game_scoring_driver.main(["--input-data-path", str(trained / "test"), "--model-input-dir",
                              str(trained / "out" / "best"), "--output-dir",
                              str(tmp_path / "scored")], device="cpu")
    records = []
    for name in sorted(os.listdir(tmp_path / "scored" / "scores")):
        records += list(tavro.read_container(str(tmp_path / "scored" / "scores" / name)))
    by_uid = {r["uid"]: r["predictionScore"] for r in records}

    model, maps, shards, vocabs, re_cols = _load_scoring_model(
        model_input_dir=str(trained / "out" / "best"), index_maps_dir=None, feature_shards=None,
        compact_random_effect_threshold=100000, device="cpu")
    ds = read_partitioned(str(trained / "test"), shards, index_maps=maps,
                          random_effect_id_columns=re_cols, entity_vocabs=vocabs,
                          device="cpu").result.dataset
    ref = DistributedScorer(model).score_dataset(ds)
    with MicroBatchServer(ResidentScorer(model, shapes=(32, 128)), max_wait_ms=20) as server:
        futures = [server.submit(tgd.slice_game_dataset(ds, lo, lo + 4))
                   for lo in range(0, ds.num_samples, 4)]
        got = np.concatenate([f.result(30) for f in futures])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got.astype(np.float64),
                                  [by_uid[str(u)] for u in ds.unique_ids])


def test_serve_driver_swaps_mid_replay_and_by_polling(trained, tmp_path):
    """A one-shot swap of a model of the same layout adds no capture; in
    poll mode an atomically renamed model is applied and a bad publish is
    rejected while every request is served."""
    import shutil

    s = _serve(trained, tmp_path / "once", swap_model_dir=str(trained / "out" / "best"),
               skip_unbatched_baseline=True)
    assert s["swap"] == {"performed": True, "at_request": 50, "score_compiles_after_swap": 0}
    watch = tmp_path / "watch"
    watch.mkdir()
    shutil.copytree(trained / "out" / "best", watch / "tmp.m1")
    os.rename(watch / "tmp.m1", watch / "model-0001")
    (watch / "model-0002").mkdir()
    s = _serve(trained, tmp_path / "poll", swap_model_dir=str(watch), swap_poll_ms=5,
               skip_unbatched_baseline=True)
    assert s["num_rows"] == 400 and s["swap"]["mode"] == "poll"
    assert "model-0001" in s["swap"]["applied"]
    assert {r["dir"] for r in s["swap"]["rejected"]} == {"model-0002"}


def test_serve_driver_rejects_bad_shapes_and_rows(trained, tmp_path):
    with pytest.raises(ValueError, match="request_rows must be positive, got 0"):
        _serve(trained, tmp_path / "x", request_rows=0)
    with pytest.raises(ValueError, match="micro-batch shape 48 is not a positive power of two"):
        _serve(trained, tmp_path / "y", microbatch_shapes="48")
    with pytest.raises(ValueError, match="--swap-at-request names a submit index"):
        _serve(trained, tmp_path / "z", swap_poll_ms=5, swap_at_request=3)

