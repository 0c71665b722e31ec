"""The resident scorer's captured CUDA graphs on the card.

Imports only torch, numpy and the port, so it also runs where JAX is not
installed. Every test needs an NVIDIA GPU and skips without one; on the
card run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py

A graph replay scores bitwise what the same program scores eagerly on the
same inputs and counts the launches that eager run makes, and a dense model's bucket bitwise what ``score_dataset`` gives
for the bucket padded by ``pad_game_dataset_to``; a 1000-request replay
through the micro-batching server and an equal-layout swap capture nothing
new; a swap racing the scorer never mixes two models in one micro-batch; a
graph captured before a swap scores the new model after it (the swap copies
into the buffers the graph reads).
"""

import threading

import numpy as np
import pytest
import torch

from photon_ml_torch import convert
from photon_ml_torch.data.game_data import (
    build_game_dataset,
    pad_game_dataset_to,
    slice_game_dataset,
)
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.ops import sparse_gather
from photon_ml_torch.parallel.scoring import DistributedScorer
from photon_ml_torch.serving import MicroBatchServer, ResidentScorer

pytestmark = pytest.mark.cuda

SHAPES = (16, 64, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fixture(kind: str, device, seed: int = 0, n: int = 600, users: int = 40):
    """(dataset, model values): "dense" a fixed effect on a 64-wide shard, a
    per-user effect and a user x item factorization; "sparse" a fixed effect
    on a d=50,000 shard (12 entries a row, row 5 of 3000: a chunk plan) and
    a compact per-user effect on it."""
    r = np.random.default_rng(seed)
    u = np.char.add("u", r.integers(0, users + 1, size=n).astype(str))
    it = np.char.add("i", r.integers(0, 30, size=n).astype(str))
    vocabs = {"user": np.char.add("u", np.arange(users).astype(str)),
              "item": np.char.add("i", np.arange(30).astype(str))}
    re = {"kind": "random", "entity_keys": vocabs["user"], "random_effect_type": "user",
          "task": "LINEAR_REGRESSION"}
    if kind == "dense":
        shards = {"g": r.normal(size=(n, 64)).astype(np.float32),
                  "u": r.normal(size=(n, 8)).astype(np.float32)}
        models = {"fe": {"kind": "fixed", "means": r.normal(size=64), "task": "LINEAR_REGRESSION",
                         "feature_shard_id": "g"},
                  "re": dict(re, coefficients=r.normal(size=(users, 8)), feature_shard_id="u"),
                  "mf": {"kind": "matrix_factorization", "row_factors": r.normal(size=(users, 4)),
                         "col_factors": r.normal(size=(30, 4)), "row_effect_type": "user",
                         "col_effect_type": "item", "row_keys": vocabs["user"],
                         "col_keys": vocabs["item"], "task": "LINEAR_REGRESSION"}}
    else:
        d, k = 50_000, 64
        counts = np.full(n, 12)
        counts[5] = 3000
        rows = np.repeat(np.arange(n), counts)
        cols = r.integers(0, d, size=len(rows))
        cols[rows == 5] = r.choice(d, size=3000, replace=False)
        shards = {"g": SparseShard(rows=rows, cols=cols,
                                   vals=r.normal(size=len(rows)).astype(np.float32),
                                   num_samples=n, feature_dim=d)}
        active = np.sort(np.stack([r.choice(d, size=k, replace=False) for _ in range(users)]), 1)
        models = {"fe": {"kind": "fixed", "means": r.normal(size=d) / 10,
                         "task": "LINEAR_REGRESSION", "feature_shard_id": "g"},
                  "re": dict(re, coefficients=r.normal(size=(users, k)), feature_shard_id="g",
                             active_cols=active.astype(np.int32), feature_dim=d)}
    ds = build_game_dataset(labels=r.normal(size=n), feature_shards=shards,
                            offsets=r.normal(scale=0.1, size=n),
                            entity_keys={"user": u, "item": it}, entity_vocabs=vocabs,
                            device=device)
    return ds, models


def _model(values, device, scale: float = 1.0):
    plain = {}
    for cid, m in values.items():
        m = dict(m)
        for key in ("means", "coefficients", "row_factors", "col_factors"):
            if key in m:
                m[key] = (scale * m[key]).astype(np.float32)
        plain[cid] = m
    return convert.game_model_from_numpy(plain, device=device)


def _launch_counts() -> dict:
    from photon_ml_torch.models import game

    return {(sparse_gather, "launches"): sparse_gather.launches,
            (sparse_gather, "segment_launches"): sparse_gather.segment_launches,
            (sparse_gather, "chunk_launches"): sparse_gather.chunk_launches,
            (game, "compact_launches"): game.compact_launches}


def _eager_program(scorer: ResidentScorer, part) -> tuple:
    """The resident program run eagerly on the inputs the graph got: (its
    scores, the graph's signature, the launches the eager run made)."""
    bucket = scorer._bucket_for(part.num_samples)
    inputs, layouts, sig = scorer._scorer.resident_inputs(part, bucket)
    params = scorer._scorer.resident_params(layouts)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device=scorer.device, dtype=dt)
               for k, (a, dt) in inputs.items()}
    before = _launch_counts()
    out = scorer._scorer.score_resident(layouts, tensors, params, bucket,
                                        {cid: c for cid, _, _, c in sig})
    after = _launch_counts()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return (out[:part.num_samples].cpu().numpy(), (bucket, tuple(sorted(layouts.items())), sig),
            ran)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_graph_scores_equal_eager_scores(cuda, kind):
    ds, values = _fixture(kind, cuda)
    model = _model(values, cuda)
    scorer = ResidentScorer(model, shapes=SHAPES)
    eager = DistributedScorer(model)
    for lo, hi in ((0, 1), (1, 17), (17, 80), (80, 336)):
        part = slice_game_dataset(ds, lo, hi)
        got = scorer.score(part)
        eager_scores, key, ran = _eager_program(scorer, part)
        np.testing.assert_array_equal(got, eager_scores)
        # the launches a replay counts are those the same program makes eagerly
        assert scorer._graphs[key].launches == ran
        if kind == "dense":
            padded, n = pad_game_dataset_to(part, scorer._bucket_for(hi - lo))
            np.testing.assert_array_equal(got, eager.score_dataset(padded)[:n])
        else:
            want = eager.score_dataset(part)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert scorer.captures == len(scorer.signatures)
    if kind == "sparse":
        assert any(count for sig in scorer.signatures for _, _, _, count in sig[2])


def test_no_capture_across_a_replay_and_an_equal_layout_swap(cuda):
    """1000 requests of 1-4 rows through the server, with an equal-layout
    swap in the middle: every request resolves with the scores of the model
    it met, the warm-up's captures are the only ones, and each replay
    counts its launches (the sparse model's gather kernels)."""
    for kind in ("dense", "sparse"):
        ds, values = _fixture(kind, cuda)
        old, new = _model(values, cuda), _model(values, cuda, scale=-2.0)
        scorer = ResidentScorer(old, shapes=SHAPES)
        rng = np.random.default_rng(1)
        starts = [i for i in range(590) if not i <= 5 < i + 4]  # not row 5, the long one
        requests = [slice_game_dataset(ds, lo, lo + int(rng.integers(1, 5)))
                    for lo in rng.choice(starts, size=1000)]
        if kind == "dense":
            scorer.warm(requests[0])
            captured = scorer.captures
            assert captured == len(SHAPES)
        launches = sparse_gather.segment_launches
        with MicroBatchServer(scorer, max_wait_ms=1) as server:
            futures = [server.submit(r) for r in requests[:500]]
            for f in futures:
                f.result(60)
            server.swap_model(new)
            futures += [server.submit(r) for r in requests[500:]]
            got = [f.result(60) for f in futures]
        want_old, want_new = DistributedScorer(old), DistributedScorer(new)
        for i in (0, 499, 500, 999):
            want = (want_old if i < 500 else want_new).score_dataset(requests[i])
            np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5 * np.abs(want).max())
        if kind == "dense":
            assert scorer.captures == captured
        else:
            assert sparse_gather.segment_launches > launches
            assert scorer.captures == len(scorer.signatures) <= len(SHAPES) * 8


def test_a_swap_never_mixes_two_models_in_a_micro_batch(cuda):
    """A thread swaps between two models while another scores: each
    micro-batch's scores are wholly one model's."""
    ds, values = _fixture("dense", cuda)
    a, b = _model(values, cuda), _model(values, cuda, scale=3.0)
    scorer = ResidentScorer(a, shapes=SHAPES)
    part = slice_game_dataset(ds, 0, 200)
    scorer.swap_model(b)
    want_b = scorer.score(part)
    scorer.swap_model(a)
    want_a = scorer.score(part)
    stop = threading.Event()

    def swapper():
        while not stop.is_set():
            scorer.swap_model(b)
            scorer.swap_model(a)

    thread = threading.Thread(target=swapper)
    thread.start()
    try:
        seen = set()
        for _ in range(300):
            got = scorer.score(part)
            match_a, match_b = np.array_equal(got, want_a), np.array_equal(got, want_b)
            assert match_a or match_b
            seen.add(match_a)
    finally:
        stop.set()
        thread.join(30)
    assert scorer.captures == 1


def test_a_graph_captured_before_a_swap_scores_the_new_model(cuda):
    ds, values = _fixture("sparse", cuda)
    old, new = _model(values, cuda), _model(values, cuda, scale=0.5)
    scorer = ResidentScorer(old, shapes=SHAPES)
    part = slice_game_dataset(ds, 0, 40)
    first = scorer.score(part)
    scorer.swap_model(new)
    after = scorer.score(part)
    assert scorer.captures == 1
    fresh = ResidentScorer(new, shapes=SHAPES).score(part)
    np.testing.assert_array_equal(after, fresh)
    assert not np.array_equal(after, first)
