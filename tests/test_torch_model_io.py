"""The port's model persistence (``photon_ml_torch/io/model_io.py``) against
the JAX package's (``photon_ml_tpu/io/model_io.py``), on the CPU.

Given the same model (carried across with ``convert.py``), the two packages
write byte-identical model directories, score files, text models and
feature statistics; a model saved by either loads in the other and scores
the same data within 1e-12 (float64, scaled by the largest score).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.io import index_map as jindex
from photon_ml_tpu.io import model_io as jio
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models.coefficients import Coefficients as JCoefficients
from photon_ml_tpu.models.glm import GeneralizedLinearModel as JGLM
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.io import index_map as tindex
from photon_ml_torch.io import model_io as tio
from photon_ml_torch.models import game as tgame
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType
from tests.torch_game_parity import model_to_plain

D_FE, D_RE, E, N = 9, 5, 13, 200


def _keys(prefix, d):
    return [tindex.feature_key(f"{prefix}{j}", "t" if j % 2 else "") for j in range(d)]


def _maps(module):
    return {"global": module.IndexMap.from_keys(_keys("g", D_FE - 1), add_intercept=True),
            "per_entity": module.IndexMap.from_keys(_keys("u", D_RE))}


def _jax_model(dtype, seed=0, variances=True):
    """A JAX GameModel: a fixed effect (some coefficients below the sparsity
    threshold, one exactly 0) and a random effect over E entities whose
    variances carry a NaN row (an entity without variances)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=D_FE).astype(dtype)
    means[1], means[4] = 3e-5, 0.0
    fe_var = rng.uniform(0.1, 1.0, size=D_FE).astype(dtype) if variances else None
    table = rng.normal(size=(E, D_RE)).astype(dtype)
    table[2, 1] = -2e-5
    re_var = rng.uniform(0.1, 1.0, size=(E, D_RE)).astype(dtype) if variances else None
    if variances:
        re_var[5] = np.nan
    glm = JGLM(JCoefficients(means=jnp.asarray(means),
                             variances=None if fe_var is None else jnp.asarray(fe_var)),
               JTask.LOGISTIC_REGRESSION)
    re = jgame.RandomEffectModel(
        coefficients=jnp.asarray(table), entity_keys=np.asarray([f"e{i:02d}" for i in range(E)]),
        random_effect_type="user", feature_shard_id="per_entity",
        task=JTask.LOGISTIC_REGRESSION,
        variances=None if re_var is None else jnp.asarray(re_var))
    return jgame.GameModel(models={"fixed": jgame.FixedEffectModel(glm=glm,
                                                                   feature_shard_id="global"),
                                   "per_user": re})


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("per_file", [65536, 4])
def test_same_model_saves_byte_identical(tmp_path, dtype, per_file):
    jmodel = _jax_model(dtype)
    tmodel = convert.game_model_from_numpy(model_to_plain(jmodel), device="cpu")
    kw = dict(optimization_configurations={"regWeights": {"fixed": 1.0, "per_user": 10.0}},
              random_effect_records_per_file=per_file)
    jio.save_game_model(tmp_path / "j", jmodel, _maps(jindex), **kw)
    tio.save_game_model(tmp_path / "t", tmodel, _maps(tindex), **kw)
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(jf) == sorted(tf)
    assert len([f for f in tf if f.startswith("random-effect")]) == (5 if per_file == 4 else 2)
    for name in jf:
        assert jf[name] == tf[name], name


def test_compact_random_effect_saves_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    active = np.sort(rng.choice(D_RE, size=(E, 3)), axis=1).astype(np.int32)
    active[:, 2] = np.where(np.arange(E) % 3 == 0, D_RE, active[:, 2])  # pad slots
    table = rng.normal(size=(E, 3)).astype(np.float32)
    keys = np.asarray([f"e{i}" for i in range(E)])
    common = dict(entity_keys=keys, random_effect_type="user", feature_shard_id="per_entity",
                  active_cols=active, feature_dim=D_RE)
    jm = jgame.GameModel(models={"per_user": jgame.RandomEffectModel(
        coefficients=jnp.asarray(table), task=JTask.LINEAR_REGRESSION, **common)})
    tm = tgame.GameModel(models={"per_user": tgame.RandomEffectModel(
        coefficients=torch.from_numpy(table), task=TaskType.LINEAR_REGRESSION, **common)})
    jio.save_game_model(tmp_path / "j", jm, _maps(jindex))
    tio.save_game_model(tmp_path / "t", tm, _maps(tindex))
    assert _files(tmp_path / "j") == _files(tmp_path / "t")


def _datasets(seed=1):
    rng = np.random.default_rng(seed)
    arrays = dict(
        labels=(rng.uniform(size=N) < 0.5).astype(np.float64),
        feature_shards={"global": rng.normal(size=(N, D_FE)),
                        "per_entity": rng.normal(size=(N, D_RE))},
        entity_keys={"user": np.asarray([f"e{i:02d}" for i in rng.integers(0, E + 4, size=N)])},
        offsets=rng.normal(scale=0.1, size=N))
    vocab = {"user": np.asarray([f"e{i:02d}" for i in range(E)])}
    jds = jgd.build_game_dataset(**arrays, entity_vocabs=vocab, dtype=np.float64)
    tds = tgd.build_game_dataset(**arrays, entity_vocabs=vocab, dtype=np.float64, device="cpu")
    return jds, tds


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_saved_model_loads_in_the_other_and_scores_the_same(tmp_path, writer):
    jmodel = _jax_model(np.float64, seed=4)
    tmodel = convert.game_model_from_numpy(model_to_plain(jmodel), device="cpu")
    if writer == "jax":
        jio.save_game_model(tmp_path / "m", jmodel, _maps(jindex))
    else:
        tio.save_game_model(tmp_path / "m", tmodel, _maps(tindex))
    jl = jio.load_game_model(tmp_path / "m", _maps(jindex), dtype=np.float64)
    tl = tio.load_game_model(tmp_path / "m", _maps(tindex), dtype=np.float64, device="cpu")
    assert list(jl.models) == list(tl.models) and tl.task == TaskType.LOGISTIC_REGRESSION
    assert tl.get("per_user").coefficients.dtype == torch.float64
    # the NaN variance row was dropped on save and reads back as NaN
    assert np.isnan(tl.get("per_user").variances.numpy()[5]).all()
    jds, tds = _datasets()
    _close(jl.score_dataset(jds), tl.score_dataset(tds).numpy())
    _close(jmodel.score_dataset(jds), tmodel.score_dataset(tds).numpy())
    # with no maps both rebuild them from the model's own records
    jm2, jmaps = jio.load_game_model_and_index_maps(tmp_path / "m", dtype=np.float64)
    tm2, tmaps = tio.load_game_model_and_index_maps(tmp_path / "m", dtype=np.float64,
                                                    device="cpu")
    assert {k: dict(v) for k, v in jmaps.items()} == {k: dict(v) for k, v in tmaps.items()}
    assert {k: dict(v) for k, v in tio.index_maps_from_model(tmp_path / "m").items()} == \
        {k: dict(v) for k, v in jmaps.items()}
    np.testing.assert_array_equal(np.asarray(jm2.get("fixed").glm.coefficients.means),
                                  tm2.get("fixed").glm.coefficients.means.numpy())


def test_compact_load_scores_like_the_dense_load(tmp_path):
    """Past the size threshold both load the random effect compact, and the
    compact table scores a dense shard like the dense table does."""
    jmodel = _jax_model(np.float64, seed=5, variances=False)
    jio.save_game_model(tmp_path / "m", jmodel, _maps(jindex))
    dense = tio.load_game_model(tmp_path / "m", _maps(tindex), dtype=np.float64, device="cpu")
    compact = tio.load_game_model(tmp_path / "m", _maps(tindex), dtype=np.float64,
                                  device="cpu", compact_random_effect_threshold=2)
    jcompact = jio.load_game_model(tmp_path / "m", _maps(jindex), dtype=np.float64,
                                   compact_random_effect_threshold=2)
    re = compact.get("per_user")
    assert re.active_cols is not None and re.dim == D_RE
    np.testing.assert_array_equal(re.active_cols, jcompact.get("per_user").active_cols)
    jds, tds = _datasets(seed=2)
    _close(dense.score_dataset(tds).numpy(), compact.score_dataset(tds).numpy())
    _close(jcompact.score_dataset(jds), compact.score_dataset(tds).numpy())


@pytest.mark.parametrize("per_file", [None, 64])
@pytest.mark.parametrize("uid_kind", ["int", "str", "none"])
def test_scores_round_trip_and_match_bytes(tmp_path, per_file, uid_kind):
    rng = np.random.default_rng(6)
    n = 150
    scores = rng.normal(size=n).astype(np.float32)
    uids = {"int": np.arange(n, dtype=np.int64) * 977, "none": None,
            "str": np.asarray([f"row-{i}" * (1 + i % 30) for i in range(n)])}[uid_kind]
    kw = dict(model_id="m1", uids=uids, labels=(rng.uniform(size=n) < 0.5).astype(np.float32),
              weights=np.ones(n, np.float32), records_per_file=per_file)
    name = "scores" if per_file else "scores.avro"
    jio.write_scores(tmp_path / "j" / name, scores, **kw)
    tio.write_scores(tmp_path / "t" / name, scores, **kw)
    assert _files(tmp_path / "j") == _files(tmp_path / "t")
    back = tio.read_scores(tmp_path / "t" / name)
    assert back == jio.read_scores(tmp_path / "j" / name)
    assert [r["predictionScore"] for r in back] == [float(s) for s in scores]
    assert back[3]["uid"] == (None if uids is None else str(uids[3]))


def test_text_model_and_feature_stats_match(tmp_path):
    from photon_ml_tpu.data.batch import summarize as jsummarize
    from photon_ml_torch.data.batch import summarize

    rng = np.random.default_rng(7)
    tmodels, jmodels = {}, {}
    for lam in (0.1, 1.0, 10.0):
        w = rng.normal(size=D_FE).astype(np.float32)
        jmodels[lam] = JGLM(JCoefficients(means=jnp.asarray(w)), JTask.LOGISTIC_REGRESSION)
        tmodels[lam] = GeneralizedLinearModel(Coefficients(means=torch.from_numpy(w)),
                                              TaskType.LOGISTIC_REGRESSION)
    jio.write_glm_text(tmp_path / "j", jmodels, _maps(jindex)["global"])
    tio.write_glm_text(tmp_path / "t", tmodels, _maps(tindex)["global"])
    x = rng.normal(size=(50, D_FE)).astype(np.float32)
    ws = rng.uniform(size=50).astype(np.float32)
    jio.write_feature_stats(tmp_path / "j" / "stats.avro", jsummarize(x, ws),
                            _maps(jindex)["global"])
    tio.write_feature_stats(tmp_path / "t" / "stats.avro", summarize(x, ws),
                            _maps(tindex)["global"])
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(tf) == ["0.1.txt", "1.0.txt", "10.0.txt", "stats.avro"]
    assert jf == tf


def test_matrix_factorization_is_refused(tmp_path):
    """Matrix-factorization coordinates load now; one whose directory lacks
    its id-info is refused as the JAX loader refuses it."""
    jio.save_game_model(tmp_path / "m", _jax_model(np.float32), _maps(jindex))
    os.makedirs(tmp_path / "m" / "matrix-factorization" / "mf")
    with pytest.raises(FileNotFoundError, match="id-info"):
        jio.load_game_model(tmp_path / "m", _maps(jindex))
    with pytest.raises(FileNotFoundError, match="id-info"):
        tio.load_game_model(tmp_path / "m", _maps(tindex), device="cpu")


def _jax_mf_game(dtype, seed=1):
    """A JAX GameModel with the fixed and random effects of ``_jax_model``
    and an MF coordinate (an all-zero row: an untrained vocab entity)."""
    from photon_ml_tpu.models import matrix_factorization as jmf

    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(7, 3)).astype(dtype)
    rows[4] = 0.0
    mf = jmf.MatrixFactorizationModel(
        row_factors=jnp.asarray(rows), col_factors=jnp.asarray(rng.normal(size=(5, 3)).astype(dtype)),
        row_effect_type="user", col_effect_type="item",
        row_keys=np.asarray([f"e{i:02d}" for i in range(7)]),
        col_keys=np.asarray([f"i{i}" for i in range(5)]), task=JTask.LOGISTIC_REGRESSION)
    return jgame.GameModel(models={**_jax_model(dtype).models, "mf": mf})


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matrix_factorization_files_are_the_references(tmp_path, dtype):
    """The same MF factors (carried across by ``convert``) save to the JAX
    package's bytes, LatentFactorAvro part files split at the same record
    counts; each package loads the other's directory to equal factors, keys
    and scores."""
    jmodel = _jax_mf_game(dtype)
    tmodel = convert.game_model_from_numpy(model_to_plain(jmodel), device="cpu")
    jio.save_game_model(tmp_path / "j", jmodel, _maps(jindex), random_effect_records_per_file=3)
    tio.save_game_model(tmp_path / "t", tmodel, _maps(tindex), random_effect_records_per_file=3)
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(jf) == sorted(tf)
    assert "matrix-factorization/mf/row-latent-factors/part-00002.avro" in tf
    for name in jf:
        assert tf[name] == jf[name], name
    loaded = tio.load_game_model(tmp_path / "j", _maps(tindex), dtype=dtype, device="cpu")
    mf, ref = loaded.get("mf"), jmodel.get("mf")
    assert (mf.row_effect_type, mf.col_effect_type, mf.task.value) == (
        "user", "item", ref.task.value)
    assert mf.row_factors.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_array_equal(mf.row_factors.numpy(), np.asarray(ref.row_factors))
    np.testing.assert_array_equal(mf.col_factors.numpy(), np.asarray(ref.col_factors))
    np.testing.assert_array_equal(mf.row_keys, ref.row_keys)
    np.testing.assert_array_equal(mf.col_keys, ref.col_keys)
    back = jio.load_game_model(tmp_path / "t", _maps(jindex), dtype=dtype)
    np.testing.assert_array_equal(np.asarray(back.get("mf").row_factors),
                                  np.asarray(ref.row_factors))
    rng = np.random.default_rng(2)
    kw = dict(labels=np.zeros(N), feature_shards={"global": rng.normal(size=(N, D_FE)),
                                                  "per_entity": rng.normal(size=(N, D_RE))},
              entity_keys={"user": np.asarray([f"e{i:02d}" for i in rng.integers(0, 9, N)]),
                           "item": np.asarray([f"i{i}" for i in rng.integers(0, 6, N)])},
              entity_vocabs={"user": np.asarray(ref.row_keys), "item": np.asarray(ref.col_keys)},
              dtype=np.float64)
    jds, tds = jgd.build_game_dataset(**kw), tgd.build_game_dataset(**kw, device="cpu")
    # both loaded from the JAX package's files (coefficients below the
    # sparsity threshold were not written)
    expect = np.asarray(jio.load_game_model(tmp_path / "j", _maps(jindex),
                                            dtype=dtype).score_dataset(jds))
    tol = 1e-12 if dtype == np.float64 else 1e-6  # an f32 table scores in f32 in the port
    np.testing.assert_allclose(loaded.score(tds).numpy(), expect, rtol=tol,
                               atol=tol * np.abs(expect).max())
