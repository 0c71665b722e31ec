"""The port's GAME models against the JAX package's: scores of each
sub-model and of the GameModel on the same numpy fixture, on the CPU in f64
(rtol 1e-12: the same dot products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGlm
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.models import game as tgame
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, game_arrays, model_to_plain

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def _models(jd, seed=0, variances=False):
    rng = np.random.default_rng(seed)
    fe = jgame.FixedEffectModel(
        JGlm(JCoefficients(jnp.asarray(rng.normal(size=6)),
                           jnp.asarray(rng.uniform(size=6)) if variances else None),
             JTask.LOGISTIC_REGRESSION), "global")
    res = {}
    for t in ("user", "item"):
        e = len(jd.entity_vocabs[t])
        res[t] = jgame.RandomEffectModel(
            coefficients=jnp.asarray(rng.normal(size=(e, 3))), entity_keys=jd.entity_vocabs[t],
            random_effect_type=t, feature_shard_id="per_entity", task=JTask.LOGISTIC_REGRESSION,
            variances=jnp.asarray(rng.uniform(size=(e, 3))) if variances else None)
    return jgame.GameModel({"fixed": fe, "per_user": res["user"], "per_item": res["item"]})


def test_score_random_effect_unseen_entity_scores_zero():
    table = np.arange(6.0).reshape(3, 2)
    feats = np.array([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [7.0, 8.0]])
    idx = np.array([0, 2, -1, 1], dtype=np.int32)
    ref = jgame.score_random_effect(jnp.asarray(table), jnp.asarray(feats), jnp.asarray(idx))
    got = tgame.score_random_effect(torch.from_numpy(table), torch.from_numpy(feats),
                                    torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    assert got[2] == 0.0
    empty = tgame.score_random_effect(torch.zeros((0, 2), dtype=torch.float64),
                                      torch.from_numpy(feats), torch.from_numpy(idx))
    assert empty.shape == (4,) and float(empty.abs().sum()) == 0.0


@pytest.mark.parametrize("held_out", [False, True], ids=["training", "held-out"])
def test_game_model_scores_match(held_out):
    train, held = game_arrays(0, held_out=150)
    jd, td = datasets(train)
    jmodel = _models(jd)
    tmodel = convert.game_model_from_numpy(model_to_plain(jmodel), device="cpu")
    if held_out:
        jd, td = datasets(held, vocabs=jd.entity_vocabs)
        assert int((td.entity_idx["user"] < 0).sum()) > 0
    for cid in jmodel.models:
        np.testing.assert_allclose(tmodel.get(cid).score_dataset(td).numpy(),
                                   np.asarray(jmodel.get(cid).score_dataset(jd)),
                                   rtol=1e-12, atol=1e-13)
    ref = np.asarray(jmodel.score_dataset(jd))
    np.testing.assert_allclose(tmodel.score_dataset(td).numpy(), ref, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(tmodel.score(td).numpy(), ref, rtol=1e-12, atol=1e-13)


def test_game_model_round_trip_through_numpy():
    jd, _ = datasets(game_arrays(1))
    plain = model_to_plain(_models(jd, variances=True))
    tmodel = convert.game_model_from_numpy(plain, device="cpu")
    back = convert.game_model_to_numpy(tmodel)
    assert list(back) == list(plain)
    for cid in plain:
        for k, v in plain[cid].items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(back[cid][k], v), (cid, k)
            else:
                assert back[cid][k] == v, (cid, k)
    assert tmodel.task == TTask.LOGISTIC_REGRESSION
    assert tmodel.get("per_user").num_entities == len(jd.entity_vocabs["user"])
    assert tmodel.get("per_user").dim == 3
    with pytest.raises(ValueError, match="unknown model kind"):
        convert.game_model_from_numpy({"x": {"kind": "mf"}}, device="cpu")


def test_game_model_rules():
    jd, td = datasets(game_arrays(2))
    tmodel = convert.game_model_from_numpy(model_to_plain(_models(jd)), device="cpu")
    other = convert.glm_from_numpy(np.zeros(6), None, "LINEAR_REGRESSION", device="cpu")
    with pytest.raises(ValueError, match="Inconsistent task"):
        tmodel.updated("extra", tgame.FixedEffectModel(other, "global"))
    with pytest.raises(ValueError, match="no sub-models"):
        tgame.GameModel({}).score_dataset(td)
    assert tgame.GameModel({}).task == TTask.NONE
    re = tmodel.get("per_user")
    swapped = re.with_coefficients(torch.zeros_like(re.coefficients))
    assert swapped.variances is None and float(swapped.score_dataset(td).abs().sum()) == 0.0
    updated = tmodel.updated("per_user", swapped)
    assert list(updated.models) == list(tmodel.models)
    with pytest.raises(NotImplementedError):
        tgame.DatumScoringModel().score_dataset(td)


def test_fixed_effect_model_scores_a_sparse_shard():
    rng = np.random.default_rng(3)
    n, d = 40, 30
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, d, size=3 * n)
    vals = rng.normal(size=3 * n)
    shard = SparseShard(rows=rows, cols=cols, vals=vals, num_samples=n, feature_dim=d)
    td = tgd.build_game_dataset(labels=np.zeros(n), feature_shards={"wide": shard},
                                entity_keys={"user": np.arange(n) % 4}, dtype=np.float64,
                                device="cpu")
    w = rng.normal(size=d)
    model = tgame.FixedEffectModel(convert.glm_from_numpy(w, None, "LINEAR_REGRESSION",
                                                          device="cpu"), "wide")
    dense = np.zeros((n, d))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(model.score_dataset(td).numpy(), dense @ w, rtol=1e-12,
                               atol=1e-13)
    re = tgame.RandomEffectModel(torch.zeros((4, d), dtype=torch.float64),
                                 td.entity_vocabs["user"], "user", "wide",
                                 TTask.LINEAR_REGRESSION)
    # a dense [E, d] table cannot score a sparse shard: it is trained compact
    with pytest.raises(ValueError, match="trained compact"):
        re.score_dataset(td)
