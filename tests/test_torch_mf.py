"""Matrix factorization in the port (ROADMAP item 13), held against the JAX
package on the CPU in float64: scoring, the side buckets (arrays equal), one
alternating half-step (lane iterations and reasons equal), whole
``GameEstimator.fit`` runs from the JAX package's initial factors carried
across by ``photon_ml_torch.convert``, the CLI grammar and LatentFactorAvro
I/O; and every case of ``tests/test_mf.py`` but its checkpoint round trip
(checkpoints are ROADMAP item 16)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.algorithm import mf_coordinate as jmfc
from photon_ml_tpu.models import matrix_factorization as jmf
from photon_ml_tpu.models.game import GameModel as JGameModel
from photon_ml_tpu.ops.objective import GLMObjective as JObjective
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.algorithm import mf_coordinate as tmfc
from photon_ml_torch.algorithm.coordinates import CoordinateOptimizationConfig
from photon_ml_torch.cli.configs import parse_coordinate_config
from photon_ml_torch.data.game_data import build_game_dataset
from photon_ml_torch.io.model_io import load_game_model, save_game_model
from photon_ml_torch.models import matrix_factorization as tmf
from photon_ml_torch.models.game import GameModel
from photon_ml_torch.ops.objective import GLMObjective as TObjective
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.types import TaskType
from tests.torch_game_parity import (
    assert_models_close,
    datasets,
    game_arrays,
    model_to_plain,
    optimizer_pair,
)
from tests.torch_lane_parity import assert_lanes_equal
from tests.torch_parity import loss_pair


def _mf_problem(rng, n=600, n_rows=12, n_cols=9, k=2, noise=0.05):
    """Low-rank regression data: y = u_r . v_c + noise."""
    u = rng.normal(size=(n_rows, k))
    v = rng.normal(size=(n_cols, k))
    r = rng.integers(0, n_rows, size=n)
    c = rng.integers(0, n_cols, size=n)
    y = np.einsum("nk,nk->n", u[r], v[c]) + noise * rng.normal(size=n)
    return np.array([f"u{i}" for i in r]), np.array([f"v{i}" for i in c]), y


def _dataset(rows, cols, y, **kw):
    return build_game_dataset(labels=y, feature_shards=kw.pop("feature_shards", {}),
                              entity_keys={"user": rows, "item": cols}, dtype=np.float64,
                              device="cpu", **kw)


def _coordinate(ds, *, opt_type=OptimizerType.LBFGS, max_iterations=20, l1=0.0,
                num_alternations=6, **kw):
    return tmfc.MatrixFactorizationCoordinate(
        coordinate_id="mf", dataset=ds, mf_dataset=tmfc.build_mf_dataset(ds, "user", "item"),
        task=TaskType.LINEAR_REGRESSION,
        config=CoordinateOptimizationConfig(
            optimizer=OptimizerConfig(optimizer_type=opt_type, max_iterations=max_iterations),
            l2_weight=1e-3, l1_weight=l1),
        num_latent_factors=2, num_alternations=num_alternations, **kw)


def _rmse(coord, model, y) -> float:
    return float(np.sqrt(np.mean((coord.score(model).numpy() - y) ** 2)))


def test_score_semantics_missing_entities(rng):
    row_f, col_f = rng.normal(size=(4, 3)), rng.normal(size=(5, 3))
    row_idx = np.array([0, 1, -1, 2], dtype=np.int32)
    col_idx = np.array([0, -1, 2, 4], dtype=np.int32)
    t = torch.from_numpy
    s = tmf.score_matrix_factorization(t(row_f), t(col_f), t(row_idx), t(col_idx)).numpy()
    assert s[1] == 0.0 and s[2] == 0.0  # either side missing -> 0
    np.testing.assert_allclose(s[0], np.dot(row_f[0], col_f[0]), rtol=1e-12)
    np.testing.assert_allclose(s[3], np.dot(row_f[2], col_f[4]), rtol=1e-12)
    ref = np.asarray(jmf.score_matrix_factorization(*(jnp.asarray(a) for a in
                                                       (row_f, col_f, row_idx, col_idx))))
    np.testing.assert_allclose(s, ref, rtol=0, atol=1e-12)
    empty = tmf.score_matrix_factorization(t(np.zeros((0, 3))), t(col_f), t(row_idx),
                                           t(col_idx))
    assert empty.dtype == torch.float64 and empty.tolist() == [0.0] * 4


def test_init_factors_nonzero_and_deterministic():
    r1, c1 = tmf.init_factors(7, 5, 3, seed=42, device="cpu")
    r2, c2 = tmf.init_factors(7, 5, 3, seed=42, device="cpu")
    r3, _ = tmf.init_factors(7, 5, 3, seed=43, device="cpu")
    assert torch.equal(r1, r2) and torch.equal(c1, c2) and not torch.equal(r1, r3)
    assert r1.abs().max() > 0 and r1.shape == (7, 3) and c1.shape == (5, 3)
    assert r1.dtype == torch.float32
    # the scale is 1/sqrt(k) as in the JAX package (its draws differ by design)
    big, _ = tmf.init_factors(4000, 1, 4, seed=0, dtype=torch.float64, device="cpu")
    assert abs(float(big.std()) - 0.5) < 0.02


def test_build_mf_dataset_buckets(rng):
    rows, cols, y = _mf_problem(rng, n=100)
    # knock some col entities out of the vocab to exercise weight zeroing
    ds = _dataset(rows, cols, y, entity_vocabs={"item": np.unique(cols)[:-2]})
    mf = tmfc.build_mf_dataset(ds, "user", "item")
    assert mf.num_row_entities == len(np.unique(rows))
    # a sample whose item is unseen has no factor-feature: it is left out of
    # the row side's buckets (it must not crowd usable samples out of a cap)
    item_idx = ds.entity_idx["item"].numpy()
    usable = int((item_idx >= 0).sum())
    assert usable < 100
    assert sum(int((b.sample_rows >= 0).sum()) for b in mf.row_buckets) == usable
    for b in mf.row_buckets:
        assert bool(torch.all(b.weights[b.sample_rows >= 0] > 0))


@pytest.mark.parametrize("bucket_sizes,cap", [((8, 32, 128, 512, 2048), None), ((4, 16), 12)])
def test_mf_buckets_equal_the_references(bucket_sizes, cap):
    """Both sides' bucket arrays equal the JAX package's exactly, on data with
    unseen entities on either side and a reservoir cap."""
    a = game_arrays(11, n=500, n_users=30, n_items=9)
    vocabs = {"user": np.unique(a["users"])[2:], "item": np.unique(a["items"])[1:]}
    jd, td = datasets(a, vocabs=vocabs)
    kw = dict(bucket_sizes=bucket_sizes, active_data_upper_bound=cap, seed=3)
    ref = jmfc.build_mf_dataset(jd, "user", "item", **kw)
    got = tmfc.build_mf_dataset(td, "user", "item", **kw)
    assert (got.num_row_entities, got.num_col_entities) == (ref.num_row_entities,
                                                            ref.num_col_entities)
    for side in ("row_buckets", "col_buckets"):
        rb, gb = getattr(ref, side), getattr(got, side)
        assert len(rb) == len(gb) > 0
        for r, g in zip(rb, gb):
            for field in ("labels", "weights", "entity_rows", "sample_rows"):
                rv, gv = np.asarray(getattr(r, field)), getattr(g, field).numpy()
                assert rv.dtype == gv.dtype and np.array_equal(rv, gv), (side, field)
    for r, g in zip(ref.trained_masks(), got.trained_masks()):
        assert np.array_equal(r, g)


@pytest.mark.parametrize("lanes,loss", [("NEWTON", "LogisticLoss"), ("LBFGS", "LogisticLoss"),
                                        ("LBFGS", "SquaredLoss")])
@pytest.mark.parametrize("side", ["row", "col"])
def test_side_bucket_solve_matches(lanes, loss, side):
    """One half-step over every bucket of one side from the same factors:
    the factor tables within rel 1e-8, lane iterations and reasons equal."""
    a = game_arrays(12, n=600, n_users=20, n_items=8)
    jd, td = datasets(a, vocabs={"item": np.unique(a["items"])[1:]})
    jm, tm = jmfc.build_mf_dataset(jd, "user", "item"), tmfc.build_mf_dataset(td, "user", "item")
    rng = np.random.default_rng(5)
    rows = 0.5 * rng.normal(size=(jm.num_row_entities, 3))
    cols = 0.5 * rng.normal(size=(jm.num_col_entities, 3))
    offsets = 0.2 * rng.normal(size=len(a["labels"]))
    jl, tl = loss_pair(loss)
    jobj = JObjective(jl, l2_weight=0.5, use_pallas=False)
    tobj = TObjective(tl, l2_weight=0.5, use_kernel=False)
    jopt, topt = optimizer_pair(lanes, 10)
    this, other = (rows, cols) if side == "row" else (cols, rows)
    other_type = "item" if side == "row" else "user"
    jtable, ttable = jnp.asarray(this), torch.from_numpy(this)
    t = torch.from_numpy
    for jb, tb in zip(getattr(jm, f"{side}_buckets"), getattr(tm, f"{side}_buckets")):
        # the JAX half-step's own gather, then its vmapped solve with the trace
        sr = jnp.maximum(jb.sample_rows, 0)
        oidx = jd.entity_idx[other_type][sr]
        feats = jnp.asarray(other)[jnp.maximum(oidx, 0)]
        feats = jnp.where(((jb.sample_rows < 0) | (oidx < 0))[..., None], 0.0, feats)
        ref = jcoord._solve_bucket_entities(
            jobj, jopt, feats, jb.labels, jb.weights,
            jcoord._bucket_offsets(jb.sample_rows, jnp.asarray(offsets)),
            jtable[jb.entity_rows])
        ref_table = np.asarray(jmfc.solve_mf_side_bucket(
            jobj, jopt, jb.labels, jb.weights, jb.entity_rows, jb.sample_rows,
            jd.entity_idx[other_type], jnp.asarray(other), jnp.asarray(offsets), jtable))
        ttable_next, trace = tmfc.solve_mf_side_bucket(
            tobj, topt, tb.labels, tb.weights, tb.entity_rows, tb.sample_rows,
            td.entity_idx[other_type], t(other), t(offsets), ttable)
        assert_lanes_equal(ref, (ttable_next[tb.entity_rows.long()], trace), tol=1e-8)
        np.testing.assert_allclose(ttable_next.numpy(), ref_table, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref_table).max())
        jtable, ttable = jnp.asarray(ref_table), ttable_next


def _fit_pair(task: str, lanes: str, with_random_effect: bool):
    """The same GAME configuration in both packages: a fixed effect on
    "global", optionally a per-user random effect, and a user × item MF
    coordinate (k = 3, 2 alternations), 3 sweeps."""
    jfe, tfe = optimizer_pair("LBFGS", 30)
    tol = {"tolerance": 1e-5} if lanes == "NEWTON" else {}
    jla, tla = optimizer_pair(lanes, 10, **tol)

    def configs(mod_est, mod_coord, fe_opt, lane_opt):
        def opt(o, l2):
            return mod_coord.CoordinateOptimizationConfig(optimizer=o, l2_weight=l2)

        out = {"fixed": mod_est.FixedEffectCoordinateConfig("global", opt(fe_opt, 0.5))}
        if with_random_effect:
            out["per_user"] = mod_est.RandomEffectCoordinateConfig("user", "per_entity",
                                                                   opt(lane_opt, 1.0))
        out["mf"] = mod_est.MatrixFactorizationCoordinateConfig(
            "user", "item", num_latent_factors=3, optimization=opt(lane_opt, 1.0),
            num_alternations=2, seed=7)
        return out

    common = dict(num_iterations=3, intercept_indices={"global": 5, "per_entity": 2})
    je = jest.GameEstimator(task=JTask[task], coordinate_configs=configs(jest, jcoord, jfe, jla),
                            use_pallas=False, **common)
    te = test_.GameEstimator(task=TaskType[task],
                             coordinate_configs=configs(test_, tcoord, tfe, tla), **common)
    return je, te


@pytest.mark.parametrize("task,lanes,with_re", [
    ("LOGISTIC_REGRESSION", "LBFGS", False), ("LINEAR_REGRESSION", "NEWTON", True),
    ("LOGISTIC_REGRESSION", "AUTO", True)], ids=["fe+mf-lbfgs", "fe+re+mf-newton", "fe+re+mf-auto"])
def test_fit_matches_from_carried_initial_factors(task, lanes, with_re):
    """A 3-sweep fit in both packages, both starting from the JAX package's
    initial factors (the port's ``init_factors`` draws differ by design):
    every coordinate within rel 1e-8, training losses and held-out scores
    (a quarter of the rows with unseen users) too."""
    train, held = game_arrays(13, task=task, held_out=200, n_users=18, n_items=6)
    jd, td = datasets(train)
    jh, th = datasets(held, vocabs=jd.entity_vocabs)
    je, te = _fit_pair(task, lanes, with_re)
    jcfg = je.coordinate_configs["mf"]
    jinit = jmfc.MatrixFactorizationCoordinate(
        coordinate_id="mf", dataset=jd,
        mf_dataset=jmfc.build_mf_dataset(jd, "user", "item", seed=jcfg.seed),
        task=je.task, config=jcfg.optimization, num_latent_factors=3,
        seed=jcfg.seed).initial_model()
    jinit_model = JGameModel(models={"mf": jinit})
    carried = convert.game_model_from_numpy(model_to_plain(jinit_model), device="cpu")
    jr = je.fit(jd, initial_model=jinit_model)
    tr = te.fit(td, initial_model=carried)
    assert_models_close(jr.model, tr.model, rtol=1e-8)
    for r, g in zip(jr.metric_history, tr.metric_history):
        assert r["coordinate"] == g["coordinate"]
        key = next(k for k in r if k.startswith("train:"))
        np.testing.assert_allclose(g[key], r[key], rtol=1e-8)
    ref = np.asarray(jr.model.score_dataset(jh))
    got = tr.model.score(th).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max())
    unseen = th.entity_idx["user"].numpy() < 0
    assert unseen.any()
    assert np.all(tr.model.get("mf").score_dataset(th).numpy()[unseen] == 0.0)


def test_mf_coordinate_recovers_low_rank(rng):
    rows, cols, y = _mf_problem(rng, n=800, k=2, noise=0.05)
    coord = _coordinate(_dataset(rows, cols, y))
    model = coord.initial_model()
    rmse0 = _rmse(coord, model, y)
    model, info = coord.update_model(model)
    rmse = _rmse(coord, model, y)
    assert rmse < 0.35, f"MF failed to fit rank-2 structure: rmse {rmse0} -> {rmse}"
    assert rmse < rmse0 / 3
    # 6 alternations, one row and one col bucket each
    assert len(info.buckets) == 6 * (len(coord.mf_dataset.row_buckets)
                                     + len(coord.mf_dataset.col_buckets))


def test_mf_newton_matches_lbfgs(rng):
    """AUTO and NEWTON run the half-steps on Newton lanes, LBFGS on L-BFGS
    lanes: equal fit quality."""
    rows, cols, y = _mf_problem(rng, n=800, k=2, noise=0.05)
    ds = _dataset(rows, cols, y)

    def fit(opt_type):
        coord = _coordinate(ds, opt_type=opt_type)
        model, _ = coord.update_model(coord.initial_model())
        return _rmse(coord, model, y)

    rmse_newton, rmse_auto, rmse_lbfgs = (fit(t) for t in (
        OptimizerType.NEWTON, OptimizerType.AUTO, OptimizerType.LBFGS))
    assert rmse_newton < 0.35 and rmse_auto == rmse_newton
    assert abs(rmse_newton - rmse_lbfgs) < 0.02, (rmse_newton, rmse_lbfgs)


def test_mf_l1_rejected(rng):
    rows, cols, y = _mf_problem(rng, n=50)
    coord = _coordinate(_dataset(rows, cols, y), l1=0.1)
    with pytest.raises(ValueError, match="L1 regularization is not supported on latent factors"):
        coord.update_model(coord.initial_model())


def test_estimator_with_mf_coordinate(rng):
    n, d, k = 700, 4, 2
    w_true = rng.normal(size=d)
    x = rng.normal(size=(n, d))
    rows, cols, y_mf = _mf_problem(rng, n=n, k=k, noise=0.0)
    y = x @ w_true + 0.7 * y_mf + 0.05 * rng.normal(size=n)
    ds = _dataset(rows, cols, y, feature_shards={"global": x})
    opt = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(optimizer_type=OptimizerType.LBFGS, max_iterations=20),
        l2_weight=1e-3)
    est = test_.GameEstimator(task=TaskType.LINEAR_REGRESSION, coordinate_configs={
        "fixed": test_.FixedEffectCoordinateConfig("global", opt),
        "mf": test_.MatrixFactorizationCoordinateConfig("user", "item", num_latent_factors=k,
                                                        optimization=opt, num_alternations=2)},
        num_iterations=4)
    result = est.fit(ds)
    rmse = float(np.sqrt(np.mean((result.model.score(ds).numpy() - y) ** 2)))
    # the fixed effect alone leaves the 0.7·mf residual; the joint fit takes most of it
    assert rmse < 0.4, f"joint FE+MF fit too weak: rmse={rmse}"
    assert isinstance(result.model.get("mf"), tmf.MatrixFactorizationModel)


def test_mf_cli_config_partial_spec_rejected():
    cfg = parse_coordinate_config(
        "name=mf,mf.row.effect.type=u,mf.col.effect.type=i,mf.latent.factors=4")
    assert cfg.is_matrix_factorization and cfg.mf_latent_factors == 4
    est_cfg = cfg.estimator_config(0.5)
    assert isinstance(est_cfg, test_.MatrixFactorizationCoordinateConfig)
    assert (est_cfg.row_effect_type, est_cfg.col_effect_type, est_cfg.num_latent_factors,
            est_cfg.num_alternations, est_cfg.optimization.l2_weight) == ("u", "i", 4, 2, 0.5)
    # partial MF specs must fail loudly, not silently train a fixed effect
    with pytest.raises(ValueError, match="matrix-.*factorization coordinate"):
        parse_coordinate_config("name=x,feature.shard=g,mf.col.effect.type=i,mf.latent.factors=2")
    with pytest.raises(ValueError, match="mf.latent.factors"):
        parse_coordinate_config("name=x,mf.row.effect.type=u,mf.col.effect.type=i")


def test_mf_cli_config_conflicts_rejected():
    with pytest.raises(ValueError, match="either a random effect or"):
        parse_coordinate_config("name=x,feature.shard=g,random.effect.type=u,"
                                "mf.row.effect.type=u,mf.col.effect.type=i,mf.latent.factors=2")
    with pytest.raises(ValueError, match="L1"):
        parse_coordinate_config("name=x,mf.row.effect.type=u,mf.col.effect.type=i,"
                                "mf.latent.factors=2,reg.alpha=0.5")


def test_mf_untrained_vocab_entities_score_zero(rng):
    """Vocab entities with zero samples score 0, not random-init noise."""
    rows, cols, y = _mf_problem(rng, n=60, n_rows=5, n_cols=4)
    vocab_rows = np.concatenate([np.unique(rows), ["ghost-user"]])
    coord = _coordinate(_dataset(rows, cols, y, entity_vocabs={"user": vocab_rows}),
                        max_iterations=5, num_alternations=1)
    init = coord.initial_model()
    ghost = int(np.nonzero(np.asarray(init.row_keys) == "ghost-user")[0][0])
    assert torch.all(init.row_factors[ghost] == 0) and init.row_factors.abs().sum() > 0
    model, _ = coord.update_model(init)
    assert torch.all(model.row_factors[ghost] == 0.0)


def test_mf_model_avro_round_trip(tmp_path, rng):
    rows, cols = np.array(["u0", "u1", "u2"]), np.array(["i0", "i1"])
    model = tmf.MatrixFactorizationModel(
        row_factors=torch.from_numpy(rng.normal(size=(3, 4))),
        col_factors=torch.from_numpy(rng.normal(size=(2, 4))), row_effect_type="user",
        col_effect_type="item", row_keys=rows, col_keys=cols, task=TaskType.LINEAR_REGRESSION)
    save_game_model(tmp_path / "model", GameModel(models={"mf": model}), index_maps={})
    lm = load_game_model(tmp_path / "model", index_maps={}, dtype=np.float64,
                         device="cpu").get("mf")
    assert isinstance(lm, tmf.MatrixFactorizationModel)
    assert (lm.row_effect_type, lm.col_effect_type) == ("user", "item")
    assert lm.task == TaskType.LINEAR_REGRESSION
    np.testing.assert_array_equal(lm.row_keys, rows)
    assert torch.equal(lm.row_factors, model.row_factors)
    assert torch.equal(lm.col_factors, model.col_factors)
    ds = build_game_dataset(labels=np.zeros(4), feature_shards={}, entity_keys={
        "user": np.array(["u1", "u0", "zz", "u2"]), "item": np.array(["i0", "i1", "i0", "zz"])},
        entity_vocabs={"user": rows, "item": cols}, dtype=np.float64, device="cpu")
    scores = lm.score_dataset(ds)
    assert torch.equal(scores, model.score_dataset(ds))
    assert scores[2] == 0.0 and scores[3] == 0.0


def test_mf_reservoir_cap_ignores_unusable_samples(rng):
    n_usable, n_dead = 6, 40
    rows = np.array(["r0"] * (n_usable + n_dead))
    cols = np.array(["c0"] * n_usable + ["GONE"] * n_dead)
    ds = _dataset(rows, cols, rng.normal(size=n_usable + n_dead),
                  entity_vocabs={"item": np.array(["c0"])})
    mf = tmfc.build_mf_dataset(ds, "user", "item", bucket_sizes=(8,), active_data_upper_bound=8)
    assert sum(float((b.weights > 0).sum()) for b in mf.row_buckets) == n_usable
