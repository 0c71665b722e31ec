"""Random effects on a sparse shard: compact ``[E, K]`` tables over each
entity's active columns, held against the JAX package on the CPU in float64.

One numpy fixture, made from a seed, builds both packages' datasets: a dense
fixed-effect shard and a sparse random-effect shard in which each user
touches a few columns of a wide space (plus stray columns, duplicate entries
and held-out rows of unseen users). The builders' arrays are equal (features
bitwise), coordinate updates and ``GameEstimator.fit`` agree within rel 1e-8
with equal lane iterations (TRON lanes at their reference tolerance 1e-5),
compact scores within 1e-12, and the refusals raise the JAX package's errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.data.sparse_batch import SparseShard as JShard
from photon_ml_tpu.io.index_map import IndexMap as JIndexMap
from photon_ml_tpu.io import model_io as jmodel_io
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.ops.normalization import NormalizationType as JNorm
from photon_ml_tpu.ops.normalization import build_normalization as jbuild_norm
from photon_ml_tpu.projector.projectors import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data.sparse_batch import SparseShard as TShard
from photon_ml_torch.io import model_io as tmodel_io
from photon_ml_torch.io.index_map import IndexMap as TIndexMap
from photon_ml_torch.models import game as tgame
from photon_ml_torch.ops.normalization import NormalizationType as TNorm
from photon_ml_torch.ops.normalization import build_normalization as tbuild_norm
from photon_ml_torch.projector.projectors import ProjectorType as TProj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import assert_models_close, model_to_plain, optimizer_pair

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


def sparse_arrays(seed: int = 0, *, n: int = 400, d_re: int = 3000, users: int = 18,
                  support: int = 5, held_out: int = 0, task: str = "LINEAR_REGRESSION"):
    """A dense ``global`` shard (intercept last) and a sparse ``re`` shard:
    each user owns ``support`` columns of ``d_re``, every row holds its
    user's columns plus one stray column, every 7th row repeats an entry
    (duplicates add up); skewed user counts, a user with two rows; offsets,
    weights with zeros. With ``held_out`` > 0 the last rows are split off,
    half of them of unseen users."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    u = rng.choice(users, size=total, p=rng.dirichlet(np.full(users, 0.6)))
    u[:2] = users  # a user with two rows
    u[2:n][u[2:n] == users] = 0
    cols_of = np.stack([np.sort(rng.choice(d_re, size=support, replace=False))
                        for _ in range(users + 1)])
    w_of = rng.normal(size=(users + 1, support))
    xv = rng.normal(size=(total, support))
    stray = rng.integers(0, d_re, size=total)
    rows = np.concatenate([np.repeat(np.arange(total), support), np.arange(total),
                           np.arange(0, total, 7)])
    cols = np.concatenate([cols_of[u].ravel(), stray, cols_of[u[::7], 0]])
    vals = np.concatenate([xv.ravel(), 0.3 * rng.normal(size=total),
                           0.5 * rng.normal(size=len(range(0, total, 7)))])
    xg = rng.normal(size=(total, 4))
    xg[:, -1] = 1.0
    z = xg @ rng.normal(size=4) + np.einsum("nk,nk->n", xv, w_of[u])
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = z + 0.05 * rng.normal(size=total)
    keys = u.copy()
    if held_out:
        keys[n + held_out // 2:] += users + 1  # unseen at training time
    weights = rng.uniform(0.5, 1.5, size=total)
    weights[::13] = 0.0
    arrays = dict(labels=y, xg=xg, rows=rows, cols=cols, vals=vals, d_re=d_re,
                  users=np.array([f"u{k}" for k in keys]), offsets=0.05 * rng.normal(size=total),
                  weights=weights, unique_ids=rng.permutation(total).astype(np.int64) + 100,
                  cols_of=cols_of, u=u)
    if not held_out:
        return arrays
    return _split(arrays, 0, n), _split(arrays, n, total)


def _split(a, lo, hi):
    keep = (a["rows"] >= lo) & (a["rows"] < hi)
    out = {k: (v[lo:hi] if isinstance(v, np.ndarray) and len(v) == len(a["labels"]) else v)
           for k, v in a.items()}
    out.update(rows=a["rows"][keep] - lo, cols=a["cols"][keep], vals=a["vals"][keep])
    return out


def datasets(a, vocabs=None, dtype=np.float64):
    """(JAX GameDataset, port GameDataset on the CPU) of one array dict."""
    n = len(a["labels"])
    shard = dict(rows=a["rows"], cols=a["cols"], vals=a["vals"].astype(dtype), num_samples=n,
                 feature_dim=a["d_re"])
    kw = dict(labels=a["labels"], entity_keys={"user": a["users"]}, offsets=a["offsets"],
              weights=a["weights"], unique_ids=a["unique_ids"], entity_vocabs=vocabs,
              dtype=dtype)
    return (jgd.build_game_dataset(feature_shards={"global": a["xg"], "re": JShard(**shard)},
                                   **kw),
            tgd.build_game_dataset(feature_shards={"global": a["xg"], "re": TShard(**shard)},
                                   device="cpu", **kw))


def scale_contexts(td, norm="SCALE_WITH_STANDARD_DEVIATION"):
    """The JAX package's context from the port's summary of ``re``, and the
    same factors carried into the port."""
    stats = td.feature_shards["re"].summarize(td.host_array("weights"))
    jn = jbuild_norm(JNorm[norm], **{k: jnp.asarray(np.asarray(stats[k]))
                                     for k in ("mean", "variance", "max_magnitude")})
    return jn, convert.normalization_from_numpy(np.asarray(jn.factors), None, device="cpu")


def _to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, ref, rtol=1e-8):
    ref, got = np.asarray(ref, dtype=np.float64), _to_np(got).astype(np.float64)
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    live = ~np.isnan(ref)
    np.testing.assert_allclose(got[live], ref[live], rtol=rtol,
                               atol=rtol * max(np.abs(ref[live]).max(initial=0.0), 1e-30))


BUILDS = {"plain": {}, "bounds": dict(active_data_lower_bound=3, active_data_upper_bound=20),
          "scaled": dict(normalization="SCALE_WITH_STANDARD_DEVIATION"),
          "max-magnitude": dict(normalization="SCALE_WITH_MAX_MAGNITUDE")}


def _build_pair(jd, td, normalization=None, **kw):
    jn = tn = None
    if normalization is not None:
        jn, tn = scale_contexts(td, normalization)
    return (jgd.build_random_effect_dataset(jd, "user", "re", normalization=jn, **kw), jn), \
        (tgd.build_random_effect_dataset(td, "user", "re", normalization=tn, **kw), tn)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("build", list(BUILDS))
def test_compact_builder_matches(build, dtype):
    """Active columns are each entity's support; ``active_cols``, the
    buckets' local ``col_index`` and members equal the JAX package's and the
    features are bitwise its (values scaled before the gather when a SCALE
    context is given)."""
    a = sparse_arrays(0)
    jd, td = datasets(a, dtype=dtype)
    (jr, _), (tr, _) = _build_pair(jd, td, seed=3, **BUILDS[build])
    assert tr.is_compact and tr.projector_type == TProj.INDEX_MAP and tr.dim == a["d_re"]
    assert tr.pre_normalized == jr.pre_normalized == ("normalization" in BUILDS[build])
    assert tr.table_width == jr.table_width and tr.num_entities == jr.num_entities
    assert tr.active_cols.dtype == np.int32 and np.array_equal(tr.active_cols, jr.active_cols)
    assert len(tr.buckets) == len(jr.buckets) >= 2
    for jb, tb in zip(jr.buckets, tr.buckets):
        for field in ("features", "labels", "weights", "entity_rows", "sample_rows",
                      "col_index"):
            r, g = np.asarray(getattr(jb, field)), getattr(tb, field).numpy()
            assert g.dtype == r.dtype and np.array_equal(g, r), field
    if build == "plain":
        # a user's active columns: its own support and the stray columns of its rows
        vocab = list(td.entity_vocabs["user"])
        for user in (0, 3):
            row = vocab.index(f"u{user}")
            got = tr.active_cols[row][tr.active_cols[row] < tr.dim]
            mine = a["rows"][np.isin(a["rows"], np.nonzero(a["u"] == user)[0])]
            want = np.unique(a["cols"][np.isin(a["rows"], mine)])
            assert np.array_equal(got, want) and set(a["cols_of"][user]) <= set(got)


@pytest.mark.parametrize("case", ["random", "pearson", "standardization"])
def test_compact_builder_refusals_match(case):
    a = sparse_arrays(1, n=120)
    jd, td = datasets(a)
    stats = td.feature_shards["re"].summarize(td.host_array("weights"))
    kw = {k: np.asarray(stats[k]) for k in ("mean", "variance", "max_magnitude")}
    calls = {
        "random": (dict(projector_type=JProj.RANDOM, projected_dim=3),
                   dict(projector_type=TProj.RANDOM, projected_dim=3)),
        "pearson": (dict(features_to_samples_ratio=0.5), dict(features_to_samples_ratio=0.5)),
        "standardization": (
            dict(normalization=jbuild_norm(JNorm.STANDARDIZATION, intercept_index=0, **{
                k: jnp.asarray(v) for k, v in kw.items()})),
            dict(normalization=tbuild_norm(TNorm.STANDARDIZATION, intercept_index=0, **{
                k: torch.from_numpy(v) for k, v in kw.items()}))),
    }[case]
    errors = []
    for mod, ds, call in ((jgd, jd, calls[0]), (tgd, td, calls[1])):
        with pytest.raises(ValueError) as err:
            mod.build_random_effect_dataset(ds, "user", "re", **call)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _coordinate_pair(jd, td, lanes, *, normalization=None, variance=True, tolerance=1e-7,
                     l1=0.0):
    """The per-user compact coordinate in both packages: 10 lane iterations,
    L2 1, full variances."""
    (jr, jn), (tr, tn) = _build_pair(jd, td, normalization=normalization,
                                     active_data_lower_bound=2)
    jopt, topt = optimizer_pair(lanes, 10, tolerance=tolerance)
    cfg = dict(l2_weight=1.0, l1_weight=l1, compute_variance=variance, variance_mode="full")
    common = dict(coordinate_id="per_user")
    return (jcoord.RandomEffectCoordinate(
                dataset=jd, re_dataset=jr, task=JTask.LINEAR_REGRESSION,
                config=jcoord.CoordinateOptimizationConfig(optimizer=jopt, **cfg),
                normalization=jn, **common),
            tcoord.RandomEffectCoordinate(
                dataset=td, re_dataset=tr, task=TTask.LINEAR_REGRESSION,
                config=tcoord.CoordinateOptimizationConfig(optimizer=topt, **cfg),
                normalization=tn, **common))


UPDATES = {
    "lbfgs": dict(lanes="LBFGS"), "newton": dict(lanes="NEWTON"),
    "lbfgs-scaled": dict(lanes="LBFGS", normalization="SCALE_WITH_STANDARD_DEVIATION"),
    "newton-max-magnitude": dict(lanes="NEWTON", normalization="SCALE_WITH_MAX_MAGNITUDE"),
    "owlqn": dict(lanes="OWLQN", l1=0.05),
    "tron": dict(lanes="TRON", tolerance=1e-5),
}


@pytest.mark.parametrize("name", list(UPDATES))
def test_compact_update_matches(name):
    """Two updates of the compact per-user coordinate (the second
    warm-started, with residual offsets): lane iterations and reasons
    equal, tables, variances (full, then diagonal) and scores within rel
    1e-8; variances NaN on pad slots and untrained entities."""
    a = sparse_arrays(2)
    jd, td = datasets(a)
    jc, tc = _coordinate_pair(jd, td, **UPDATES[name])
    extra = 0.3 * np.random.default_rng(2).normal(size=td.num_samples)
    jm, tm = jc.initial_model(), tc.initial_model()
    assert tm.is_compact and np.array_equal(tm.active_cols, jm.active_cols)
    assert tm.feature_dim == jm.feature_dim == a["d_re"]
    for sweep in range(2):
        if sweep:
            jc.config = dataclasses.replace(jc.config, variance_mode="diagonal")
            tc.config = dataclasses.replace(tc.config, variance_mode="diagonal")
        jm, jinfo = jc.update_model(jm, jnp.asarray(extra) * (sweep + 1))
        tm, tinfo = tc.update_model(tm, torch.from_numpy(extra) * (sweep + 1))
        assert len(jinfo.buckets) == len(tinfo.buckets)
        for jt, tt in zip(jinfo.buckets, tinfo.buckets):
            assert np.array_equal(np.asarray(jt.iterations), tt.iterations.numpy())
            assert np.array_equal(np.asarray(jt.reason), tt.reason.numpy())
        _close(tm.coefficients, jm.coefficients)
        _close(tm.variances, jm.variances)
        _close(tc.score(tm), jc.score(jm))
    var = tm.variances.numpy()
    pads = tm.active_cols >= a["d_re"]
    assert np.isnan(var[pads]).all()
    trained = np.concatenate([b.entity_rows.numpy() for b in tc.re_dataset.buckets])
    assert np.isfinite(var[trained][~pads[trained]]).all() and \
        (var[trained][~pads[trained]] > 0).all()
    assert (tm.coefficients.numpy()[pads] == 0.0).all()


def _estimators(*, lanes="LBFGS", normalization="NONE", fe_variance=False, re_variance=False,
                task="LINEAR_REGRESSION", sweeps=2, tolerance=1e-7, evaluators=()):
    """A fixed effect on ``global`` and a compact per-user effect on ``re`` in
    both packages."""
    def configs(est, cfg, fe_opt, re_opt):
        return {"fixed": est.FixedEffectCoordinateConfig("global", cfg(
                    optimizer=fe_opt, l2_weight=0.5, compute_variance=fe_variance)),
                "per_user": est.RandomEffectCoordinateConfig("user", "re", cfg(
                    optimizer=re_opt, l2_weight=1.0, compute_variance=re_variance),
                    active_data_lower_bound=2)}

    jfe, tfe = optimizer_pair("LBFGS", 30)
    jre, tre = optimizer_pair(lanes, 10, tolerance=tolerance)
    common = dict(num_iterations=sweeps, validation_evaluators=tuple(evaluators),
                  intercept_indices={"global": 3})
    return (jest.GameEstimator(task=JTask[task], normalization=JNorm[normalization],
                               coordinate_configs=configs(jest, jcoord.CoordinateOptimizationConfig,
                                                          jfe, jre),
                               use_pallas=False, **common),
            test_.GameEstimator(task=TTask[task], normalization=TNorm[normalization],
                                coordinate_configs=configs(
                                    test_, tcoord.CoordinateOptimizationConfig, tfe, tre),
                                **common))


FITS = {
    "lbfgs": dict(lanes="LBFGS"),
    "newton-logistic": dict(lanes="NEWTON", task="LOGISTIC_REGRESSION"),
    "tron": dict(lanes="TRON", tolerance=1e-5),
    "scaled": dict(lanes="LBFGS", normalization="SCALE_WITH_STANDARD_DEVIATION"),
    "re-variances": dict(lanes="NEWTON", re_variance=True),
    "fe-variances": dict(lanes="NEWTON", fe_variance=True),
}


@pytest.mark.parametrize("name", list(FITS))
def test_compact_fit_matches(name):
    """``GameEstimator.fit`` with a compact per-user effect: models
    (variances included) within rel 1e-8, training losses within 1e-9, and
    scores on the training rows and on held-out rows (unseen users, columns
    off each support) within 1e-8."""
    kw = FITS[name]
    train, held = sparse_arrays(4, held_out=120, task=kw.get("task", "LINEAR_REGRESSION"))
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    je, te = _estimators(**kw, evaluators=("RMSE",) if "task" not in kw else ("AUC",))
    jr, tr = je.fit(jd, validation_dataset=jh), te.fit(td, validation_dataset=th)
    assert_models_close(jr.model, tr.model, rtol=1e-8)
    user = tr.model.get("per_user")
    assert user.is_compact and np.array_equal(user.active_cols,
                                              jr.model.get("per_user").active_cols)
    assert (user.variances is not None) == kw.get("re_variance", False)
    assert (tr.model.get("fixed").glm.coefficients.variances is not None) == \
        kw.get("fe_variance", False)
    for key in tr.metric_history[0]:
        if ":" in key:
            assert [h[key] for h in tr.metric_history] == pytest.approx(
                [h[key] for h in jr.metric_history], rel=1e-9), key
    for ref_ds, got_ds in ((jd, td), (jh, th)):
        ref = np.asarray(jr.model.score_dataset(ref_ds))
        np.testing.assert_allclose(tr.model.score(got_ds).numpy(), ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max())
    assert int((th.entity_idx["user"] < 0).sum()) > 0


def test_compact_fit_equals_a_dense_index_map_fit():
    """The compact effect is the INDEX_MAP projection of the same model: a
    dense INDEX_MAP fit over the densified shard gives the same table on
    each support (its buckets hold the same columns in the same order) and
    zeros off it, and the same scores."""
    a = sparse_arrays(5, d_re=300)
    _, td = datasets(a)
    dense = np.zeros((td.num_samples, a["d_re"]))
    np.add.at(dense, (a["rows"], a["cols"]), a["vals"])
    td_dense = tgd.build_game_dataset(
        labels=a["labels"], feature_shards={"global": a["xg"], "re": dense},
        entity_keys={"user": a["users"]}, offsets=a["offsets"], weights=a["weights"],
        unique_ids=a["unique_ids"], dtype=np.float64, device="cpu")
    _, te = _estimators(lanes="NEWTON")
    tc = dataclasses.replace(te, coordinate_configs={
        **te.coordinate_configs, "per_user": dataclasses.replace(
            te.coordinate_configs["per_user"], projector_type=TProj.INDEX_MAP)})
    compact, indexed = te.fit(td).model, tc.fit(td_dense).model
    table, active = compact.get("per_user").coefficients.numpy(), \
        compact.get("per_user").active_cols
    full = indexed.get("per_user").coefficients.numpy()
    rows, slots = np.nonzero(active < a["d_re"])
    np.testing.assert_allclose(table[rows, slots], full[rows, active[rows, slots]],
                               rtol=1e-10, atol=1e-12)
    on = np.zeros_like(full, dtype=bool)
    on[rows, active[rows, slots]] = True
    assert (full[~on] == 0.0).all()
    np.testing.assert_allclose(compact.score(td).numpy(), indexed.score(td_dense).numpy(),
                               rtol=1e-10, atol=1e-12)


def test_compact_model_scores_dense_and_sparse_shards():
    """A compact model carried from the JAX package scores a sparse shard
    (the entry positions, pads included) and a dense shard (each sample's
    entity's columns gathered) as the JAX model does, within 1e-12."""
    train, held = sparse_arrays(6, held_out=100)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    je, _ = _estimators(lanes="NEWTON", sweeps=1)
    jmodel = je.fit(jd).model
    plain = model_to_plain(jmodel)
    ju = jmodel.get("per_user")
    plain["per_user"].update(active_cols=np.asarray(ju.active_cols),
                             feature_dim=int(ju.feature_dim))
    tmodel = convert.game_model_from_numpy(plain, device="cpu")
    assert tmodel.get("per_user").is_compact
    for jds, tds in ((jd, td), (jh, th)):
        ref = np.asarray(ju.score_dataset(jds))
        np.testing.assert_allclose(tmodel.get("per_user").score_dataset(tds).numpy(), ref,
                                   rtol=1e-12, atol=1e-12)
    # dense shards of the same rows
    x = np.zeros((len(held["labels"]), held["d_re"]))
    np.add.at(x, (held["rows"], held["cols"]), held["vals"])
    kw = dict(labels=held["labels"], feature_shards={"global": held["xg"], "re": x},
              entity_keys={"user": held["users"]}, entity_vocabs=jd.entity_vocabs,
              dtype=np.float64)
    jdense, tdense = jgd.build_game_dataset(**kw), tgd.build_game_dataset(**kw, device="cpu")
    ref = np.asarray(ju.score_dataset(jdense))
    np.testing.assert_allclose(tmodel.get("per_user").score_dataset(tdense).numpy(), ref,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ref, np.asarray(ju.score_dataset(jh)), rtol=1e-12, atol=1e-12)


def test_compact_model_save_load_round_trip(tmp_path):
    """The port saves a compact model as the JAX package does (the same
    records), and loads it back compact (threshold below d) or dense, both
    scoring as before; the JAX package loads the port's files alike."""
    a = sparse_arrays(7, d_re=500)
    jd, td = datasets(a)
    je, te = _estimators(lanes="NEWTON", sweeps=1)
    jmodel, tmodel = je.fit(jd).model, te.fit(td).model
    keys = {"global": [f"g{i}\x01" for i in range(3)], "re": [f"f{i}\x01" for i in range(500)]}
    tmaps = {k: TIndexMap.from_keys(v, add_intercept=k == "global") for k, v in keys.items()}
    jmaps = {k: JIndexMap.from_keys(v, add_intercept=k == "global") for k, v in keys.items()}
    tmodel_io.save_game_model(tmp_path / "t", tmodel, tmaps, sparsity_threshold=0.0)
    jmodel_io.save_game_model(tmp_path / "j", jmodel, jmaps, sparsity_threshold=0.0)
    for rel in ("per_user/coefficients/part-00000.avro", "per_user/id-info"):
        jf = sorted((tmp_path / "j").rglob(rel.split("/")[-1]))
        tf = sorted((tmp_path / "t").rglob(rel.split("/")[-1]))
        assert [p.relative_to(tmp_path / "j") for p in jf] == \
            [p.relative_to(tmp_path / "t") for p in tf]
    want = tmodel.score(td).numpy()
    compact = tmodel_io.load_game_model(tmp_path / "t", tmaps, dtype=np.float64,
                                        compact_random_effect_threshold=100, device="cpu")
    dense = tmodel_io.load_game_model(tmp_path / "t", tmaps, dtype=np.float64,
                                      compact_random_effect_threshold=10_000, device="cpu")
    assert compact.get("per_user").is_compact and not dense.get("per_user").is_compact
    np.testing.assert_allclose(compact.score(td).numpy(), want, rtol=1e-9, atol=1e-12)
    jback = jmodel_io.load_game_model(tmp_path / "t", jmaps, dtype=np.float64,
                                      compact_random_effect_threshold=100)
    np.testing.assert_allclose(np.asarray(jback.score_dataset(jd)), want, rtol=1e-9, atol=1e-12)
    table, active = compact.get("per_user").coefficients.numpy(), \
        compact.get("per_user").active_cols
    full = dense.get("per_user").coefficients.numpy()
    for i in range(table.shape[0]):
        live = active[i] < 500
        np.testing.assert_allclose(full[i][active[i][live]], table[i][live], atol=1e-12)


def test_active_positions_and_entry_positions_match():
    """``match_active_positions`` and ``compact_entry_positions`` give the
    JAX package's arrays, pads (absent columns, unseen entities, pad
    queries) included; their device copy is cached on the shard, found by
    identity or by equal arrays."""
    train, held = sparse_arrays(8, held_out=80)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    jr = jgd.build_random_effect_dataset(jd, "user", "re")
    active = jr.active_cols
    rng = np.random.default_rng(0)
    ent = rng.integers(-2, active.shape[0], size=500)
    cols = np.concatenate([active[np.maximum(ent[:250], 0), rng.integers(0, active.shape[1],
                                                                         size=250)],
                           rng.integers(0, train["d_re"] + 1, size=250)])
    got = tgame.match_active_positions(ent, cols, active, train["d_re"])
    want = jgame.match_active_positions(ent, cols, active, train["d_re"])
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert (got == active.shape[1]).any() and (got < active.shape[1]).any()
    for jds, tds in ((jd, td), (jh, th)):
        ref = jgame.compact_entry_positions(jds.feature_shards["re"],
                                            np.asarray(jds.host_array("entity_idx/user")),
                                            active)
        out = tgame.compact_entry_positions(tds.feature_shards["re"],
                                            tds.host_array("entity_idx/user"), active)
        for g, r in zip(out, ref):
            assert g.dtype == np.asarray(r).dtype and np.array_equal(g, np.asarray(r))
        idx = tds.host_array("entity_idx/user")
        entries = tgame.compact_entries(tds.feature_shards["re"], idx, active, "cpu")
        for g, t in zip(out, (entries.ent, entries.pos, entries.rows, entries.vals)):
            assert np.array_equal(t.numpy(), g.astype(t.numpy().dtype))
        assert tgame.compact_entries(tds.feature_shards["re"], idx, active, "cpu") is entries
        assert tgame.compact_entries(tds.feature_shards["re"], idx.copy(), active.copy(),
                                     "cpu") is entries
        other = tgame.compact_entries(tds.feature_shards["re"], np.full_like(idx, -1),
                                      active, "cpu")
        assert other is not entries and bool((other.pos == active.shape[1]).all())
    # scoring from those positions: the plain version in both packages
    table = rng.normal(size=active.shape)
    ent_, pos, rows, vals = tgame.compact_entry_positions(th.feature_shards["re"],
                                                          th.host_array("entity_idx/user"),
                                                          active)
    got = tgame.score_random_effect_compact(torch.from_numpy(table), *(
        torch.from_numpy(v) for v in (ent_, pos, rows, vals)), th.num_samples)
    want = jgame.score_random_effect_compact(jnp.asarray(table), *(
        jnp.asarray(v) for v in (ent_, pos, rows, vals)), th.num_samples)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_compact_normalization_methods_match():
    """The ``*_compact`` context methods: the pad slot keeps factor 1, and a
    context with shifts raises the JAX package's error."""
    a = sparse_arrays(9)
    jd, td = datasets(a)
    jn, tn = scale_contexts(td)
    active = jgd.build_random_effect_dataset(jd, "user", "re").active_cols
    table = np.random.default_rng(1).normal(size=active.shape)
    tt, ta = torch.from_numpy(table), torch.from_numpy(active)
    for name in ("to_model_space_compact", "from_model_space_compact",
                 "variances_to_model_space_compact"):
        got = getattr(tn, name)(tt, ta).numpy()
        want = np.asarray(getattr(jn, name)(jnp.asarray(table), jnp.asarray(active)))
        np.testing.assert_allclose(got, want, rtol=1e-15)
        pads = active >= a["d_re"]
        assert np.array_equal(got[pads], table[pads])
    stats = td.feature_shards["re"].summarize(td.host_array("weights"))
    kw = {k: np.asarray(stats[k]) for k in ("mean", "variance", "max_magnitude")}
    jstd = jbuild_norm(JNorm.STANDARDIZATION, intercept_index=0,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    tstd = tbuild_norm(TNorm.STANDARDIZATION, intercept_index=0,
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    with pytest.raises(ValueError) as jerr:
        jstd.to_model_space_compact(jnp.asarray(table), jnp.asarray(active))
    with pytest.raises(ValueError) as terr:
        tstd.to_model_space_compact(tt, ta)
    assert str(jerr.value) == str(terr.value)


def test_standardized_fit_with_a_compact_effect_raises():
    """STANDARDIZATION reaches the compact effect's shard with its shifts:
    both packages refuse it with the same error."""
    a = sparse_arrays(10, n=150)
    jd, td = datasets(a)
    je, te = _estimators(lanes="NEWTON", normalization="STANDARDIZATION", sweeps=1)
    je = dataclasses.replace(je, intercept_indices={"global": 3, "re": 0})
    te = dataclasses.replace(te, intercept_indices={"global": 3, "re": 0})
    errors = []
    for est, ds in ((je, jd), (te, td)):
        with pytest.raises(ValueError) as err:
            est.fit(ds)
        errors.append(str(err.value).splitlines()[0])
    assert errors[0] == errors[1] and "SCALE-only" in errors[0]
