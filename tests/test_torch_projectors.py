"""Projected random effects in the port against the JAX package, on the CPU in
float64: the projection matrix, the bucket builder (INDEX_MAP, RANDOM,
per-entity Pearson selection, pre-normalization: every bucket field exactly
equal, in f64 and f32), the projected bucket solves and their variances
(within rel 1e-8, per-lane iterations and reasons equal), and the
reference's refusals raised alike."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.ops import normalization as jnorm
from photon_ml_tpu.projector import projectors as jproj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.ops import normalization as tnorm
from photon_ml_torch.projector import projectors as tproj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import datasets, optimizer_pair, projected_arrays
from tests.torch_parity import normalizations, to_np

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

NORMS = ["NONE", "SCALE_WITH_STANDARD_DEVIATION", "STANDARDIZATION"]


@pytest.mark.parametrize("d,k,seed", [(12, 5, 0), (512, 64, 0), (40, 39, 7), (3, 1, 123)])
def test_random_projection_matrix_is_bitwise_the_references(d, k, seed):
    ref = jproj.RandomProjectionMatrix.create(d, k, seed)
    got = tproj.RandomProjectionMatrix.create(d, k, seed)
    assert got.matrix.dtype == ref.matrix.dtype == np.float32
    assert np.array_equal(got.matrix, ref.matrix)
    assert (got.dim, got.projected_dim) == (ref.dim, ref.projected_dim) == (d, k)
    x = np.random.default_rng(seed).normal(size=(6, d))
    assert np.array_equal(got.project_features(x), ref.project_features(x))
    assert np.array_equal(got.back_project(x[:, :k]), ref.back_project(x[:, :k]))


def test_random_projection_needs_a_narrower_width():
    for mod in (jproj, tproj):
        with pytest.raises(ValueError, match="projected_dim < dim"):
            mod.RandomProjectionMatrix.create(4, 4)
    assert [p.value for p in tproj.ProjectorType] == [p.value for p in jproj.ProjectorType]


@pytest.mark.parametrize("active", [[0, 3, 4], []])
def test_entity_active_columns_match(active):
    x = np.zeros((5, 6))
    x[1, active] = 2.0
    got = tproj.entity_active_columns(x)
    assert np.array_equal(got, jproj.entity_active_columns(x))
    assert got.tolist() == (active or [0])


@pytest.mark.parametrize("ratio", [0.2, 0.5, 1.0])
def test_pearson_masks_match(ratio):
    """The scalar and the grouped forms against the reference's, with
    2-sample entities (every doubly-active column ties at |corr| = 1), an
    intercept, all-zero columns and constant labels."""
    rng = np.random.default_rng(3)
    counts = [2, 2, 7, 13, 1]
    lane = np.repeat(np.arange(len(counts)), counts)
    x = rng.normal(size=(len(lane), 9)) * (rng.uniform(size=(len(lane), 9)) < 0.7)
    x[:, 0] = 1.0
    x[:, 8] = 0.0
    y = (rng.uniform(size=len(lane)) < 0.5).astype(np.float64)
    y[lane == 2] = 1.0  # constant labels
    ref = jgd._pearson_keep_masks_grouped(x, y, lane, len(counts), ratio)
    got = tgd._pearson_keep_masks_grouped(x, y, lane, len(counts), ratio)
    assert np.array_equal(got, ref)
    for e, c in enumerate(counts):
        keep = max(1, int(np.ceil(ratio * c)))
        rows = lane == e
        scalar = tgd._pearson_keep_mask(x[rows], y[rows], keep)
        assert np.array_equal(scalar, jgd._pearson_keep_mask(x[rows], y[rows], keep))
        assert np.array_equal(scalar, got[e]) and got[e].sum() == min(keep, 9)
        assert got[e][0] or keep == 0  # the intercept is always kept
    # f32 inputs rank as f64 ones
    assert np.array_equal(tgd._pearson_keep_masks_grouped(
        x.astype(np.float32), y.astype(np.float32), lane, len(counts), ratio), ref)


def test_host_factors_and_shifts_match():
    x = np.random.default_rng(0).normal(size=(30, 5)) + 2.0
    for kind in NORMS:
        jn, tn = normalizations(kind, x, intercept_index=0)
        for name in ("host_factors", "host_shifts"):
            r, g = getattr(jnorm, name)(jn), getattr(tnorm, name)(tn)
            assert (r is None) == (g is None)
            if r is not None:
                assert np.array_equal(g, r)


#: (projector, builder options) of the bucket-field parity cases
BUILDS = [("INDEX_MAP", {}), ("RANDOM", {"projected_dim": 5}),
          ("INDEX_MAP", {"features_to_samples_ratio": 0.4}),
          ("IDENTITY", {"features_to_samples_ratio": 0.4})]


def _build_pair(a, jd, td, projector, norm, dtype=None, **kw):
    jn, tn = (None, None) if norm == "NONE" else normalizations(
        norm, a["xr"], intercept_index=0, dtype=dtype)
    jr = jgd.build_random_effect_dataset(jd, "user", "per_entity", normalization=jn,
                                         projector_type=jproj.ProjectorType[projector], **kw)
    tr = tgd.build_random_effect_dataset(td, "user", "per_entity", normalization=tn,
                                         projector_type=tproj.ProjectorType[projector], **kw)
    return (jr, jn), (tr, tn)


#: IDENTITY blocks are never pre-normalized (that refusal is tested below)
BUILD_CASES = [(p, kw, norm) for p, kw in BUILDS for norm in NORMS
               if p != "IDENTITY" or norm == "NONE"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("projector,kw,norm", BUILD_CASES,
                         ids=[f"{p}{'-pearson' if kw.get('features_to_samples_ratio') else ''}"
                              f"-{n}" for p, kw, n in BUILD_CASES])
def test_bucket_fields_match(projector, kw, norm, dtype):
    a = projected_arrays(0)
    jd, td = datasets(a, dtype=dtype)
    (jr, _), (tr, _) = _build_pair(a, jd, td, projector, norm, dtype=dtype, seed=3,
                                   active_data_lower_bound=2, **kw)
    assert len(tr.buckets) == len(jr.buckets) >= 3
    assert (tr.dim, tr.num_entities) == (jr.dim, jr.num_entities)
    assert tr.projector_type.value == jr.projector_type.value
    assert tr.pre_normalized == jr.pre_normalized == (norm != "NONE")
    if projector == "RANDOM":
        assert np.array_equal(tr.projection.matrix, jr.projection.matrix)
    else:
        assert tr.projection is None
    for jb, tb in zip(jr.buckets, tr.buckets):
        for field in ("features", "labels", "weights", "entity_rows", "sample_rows",
                      "col_index"):
            r, g = getattr(jb, field), getattr(tb, field)
            assert (r is None) == (g is None), field
            if r is not None:
                assert g.device.type == "cpu"
                assert np.array_equal(g.numpy(), np.asarray(r)), field
    if projector == "INDEX_MAP":
        # the widest support of a bucket sets its width; pad slots point at d
        widths = [b.features.shape[2] for b in tr.buckets]
        assert max(widths) < tr.dim and all((b.col_index <= tr.dim).all() for b in tr.buckets)


@pytest.mark.parametrize("case", ["random-without-width", "identity-normalization",
                                  "pearson-with-random", "width-not-narrower"])
def test_builder_refusals_match(case):
    a = projected_arrays(1, n=120)
    jd, td = datasets(a)
    jn, tn = normalizations("SCALE_WITH_STANDARD_DEVIATION", a["xr"], intercept_index=0)
    kw = {"random-without-width": dict(projector_type="RANDOM"),
          "identity-normalization": dict(projector_type="IDENTITY", normalization=(jn, tn)),
          "pearson-with-random": dict(projector_type="RANDOM", projected_dim=3,
                                      features_to_samples_ratio=0.5),
          "width-not-narrower": dict(projector_type="RANDOM", projected_dim=12)}[case]
    errors = []
    for i, (mod, proj, ds) in enumerate(((jgd, jproj, jd), (tgd, tproj, td))):
        call = dict(kw, projector_type=proj.ProjectorType[kw["projector_type"]])
        if "normalization" in call:
            call["normalization"] = call["normalization"][i]
        with pytest.raises(ValueError) as err:
            mod.build_random_effect_dataset(ds, "user", "per_entity", **call)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _coordinate_pair(a, jd, td, projector, norm, lanes, *, prebuilt=None, **build):
    """The per-user coordinate in both packages, 10 lane iterations, L2 1,
    full variances; its dataset built by :func:`_build_pair` unless given."""
    jopt, topt = optimizer_pair(lanes, 10)
    cfg = dict(l2_weight=1.0, compute_variance=True, variance_mode="full")
    (jr, jn), (tr, tn) = prebuilt or _build_pair(a, jd, td, projector, norm,
                                                 active_data_lower_bound=3, **build)
    common = dict(coordinate_id="per_user", intercept_index=0)
    return (jcoord.RandomEffectCoordinate(
                dataset=jd, re_dataset=jr, task=JTask.LOGISTIC_REGRESSION,
                config=jcoord.CoordinateOptimizationConfig(optimizer=jopt, **cfg),
                normalization=jn, **common),
            tcoord.RandomEffectCoordinate(
                dataset=td, re_dataset=tr, task=TTask.LOGISTIC_REGRESSION,
                config=tcoord.CoordinateOptimizationConfig(optimizer=topt, **cfg),
                normalization=tn, **common))


def _assert_traces_equal(jinfo, tinfo):
    assert len(jinfo.buckets) == len(tinfo.buckets)
    for jt, tt in zip(jinfo.buckets, tinfo.buckets):
        assert np.array_equal(np.asarray(jt.iterations), tt.iterations.numpy())
        assert np.array_equal(np.asarray(jt.reason), tt.reason.numpy())
        assert np.array_equal(np.asarray(jt.valid), tt.valid.numpy())


def _assert_close(got, ref, rtol=1e-8):
    ref, got = np.asarray(ref, dtype=np.float64), to_np(got)
    assert np.array_equal(np.isnan(ref), np.isnan(got))
    live = ~np.isnan(ref)
    np.testing.assert_allclose(got[live], ref[live], rtol=rtol,
                               atol=rtol * max(np.abs(ref[live]).max(), 1e-30))


def _run_updates(jc, tc, td, sweeps=2):
    """``sweeps`` updates warm-starting each other, with residual offsets;
    the first computes full variances, the second diagonal ones."""
    extra = 0.3 * np.random.default_rng(2).normal(size=td.num_samples)
    jm, tm = jc.initial_model(), tc.initial_model()
    for sweep in range(sweeps):
        if sweep:
            jc.config = dataclasses.replace(jc.config, variance_mode="diagonal")
            tc.config = dataclasses.replace(tc.config, variance_mode="diagonal")
        jm, jinfo = jc.update_model(jm, jnp.asarray(extra) * (sweep + 1))
        tm, tinfo = tc.update_model(tm, torch.from_numpy(extra) * (sweep + 1))
        _assert_traces_equal(jinfo, tinfo)
        _assert_close(tm.coefficients, jm.coefficients)
        _assert_close(tm.variances, jm.variances)
        _assert_close(tc.score(tm), jc.score(jm))
    return jm, tm


@pytest.mark.parametrize("lanes", ["LBFGS", "NEWTON"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("projector", ["INDEX_MAP", "RANDOM"])
def test_projected_update_matches(projector, norm, lanes):
    """Two updates of a projected per-user coordinate: tables, variances
    (full, then diagonal) and scores within rel 1e-8, lane iterations and
    reasons equal."""
    a = projected_arrays(1)
    jd, td = datasets(a)
    build = {"projected_dim": 5} if projector == "RANDOM" else {}
    jc, tc = _coordinate_pair(a, jd, td, projector, norm, lanes, **build)
    _, tm = _run_updates(jc, tc, td)
    var = tm.variances.numpy()
    trained = np.concatenate([b.entity_rows.numpy() for b in tc.re_dataset.buckets])
    untrained = np.setdiff1d(np.arange(tm.num_entities), trained)
    assert len(untrained) >= 2 and np.isnan(var[untrained]).all()  # below the lower bound
    assert (var[trained] > 0).sum() > 0 and not (var[trained] <= 0).any()
    if projector == "INDEX_MAP":
        # off each entity's support: coefficient 0, variance NaN
        support = np.zeros_like(var, dtype=bool)
        for b in tc.re_dataset.buckets:
            for row, cols in zip(b.entity_rows.numpy(), b.col_index.numpy()):
                support[row, cols[cols < var.shape[1]]] = True
        assert np.isnan(var[trained][~support[trained]]).all()
        assert np.isfinite(var[support]).all()
        assert (tm.coefficients.numpy()[~support] == 0.0).all()
    else:
        assert np.isfinite(var[trained]).all()


@pytest.mark.parametrize("lanes", ["OWLQN", "TRON"])
@pytest.mark.parametrize("projector", ["INDEX_MAP", "RANDOM"])
def test_projected_update_with_the_other_lanes_matches(projector, lanes):
    """OWL-QN (an L1 weight) and TRON lanes on projected buckets; TRON at its
    reference default tolerance 1e-5 (at 1e-7 a warm-started lane's gradient
    test compares rounding-level norms, where the Hessian-vector products of
    the two packages differ in the last bits)."""
    a = projected_arrays(2)
    jd, td = datasets(a)
    build = {"projected_dim": 5} if projector == "RANDOM" else {}
    jc, tc = _coordinate_pair(a, jd, td, projector, "STANDARDIZATION", lanes, **build)
    if lanes == "TRON":
        jopt, topt = optimizer_pair("TRON", 10, tolerance=1e-5)
        jc.config = dataclasses.replace(jc.config, optimizer=jopt)
        tc.config = dataclasses.replace(tc.config, optimizer=topt)
    else:
        jc.config = dataclasses.replace(jc.config, l1_weight=0.05)
        tc.config = dataclasses.replace(tc.config, l1_weight=0.05)
    _run_updates(jc, tc, td)


@pytest.mark.parametrize("case", ["index-map-context", "random-context", "context-missing"])
def test_normalization_composition_refusals_match(case):
    """A projected coordinate with normalization needs pre-normalized blocks,
    and pre-normalized blocks need the context."""
    a = projected_arrays(3, n=200)
    jd, td = datasets(a)
    projector = "RANDOM" if case == "random-context" else "INDEX_MAP"
    build = {"projected_dim": 4} if projector == "RANDOM" else {}
    norm = "SCALE_WITH_STANDARD_DEVIATION"
    (jr, jn), (tr, tn) = _build_pair(a, jd, td, projector,
                                     "NONE" if case != "context-missing" else norm, **build)
    if case != "context-missing":
        jn, tn = normalizations(norm, a["xr"], intercept_index=0)
    else:
        jn = tn = None
    jc, tc = _coordinate_pair(a, jd, td, projector, norm, "LBFGS",
                              prebuilt=((jr, jn), (tr, tn)))
    messages = []
    for c, extra in ((jc, jnp.zeros(td.num_samples)), (tc, torch.zeros(td.num_samples,
                                                                         dtype=torch.float64))):
        with pytest.raises(ValueError) as err:
            c.update_model(c.initial_model(), extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("mode,d,k,problems", [("auto", 512, 64, 2000), ("auto", 512, 64, 100),
                                               ("auto", 12, 5, 10), ("full", 512, 64, 2000),
                                               ("diagonal", 12, 5, 1)])
def test_random_variance_mode_matches(mode, d, k, problems):
    got = tcoord.random_variance_mode(mode, d, k, problems)
    assert got == jcoord.random_variance_mode(mode, d, k, problems)


def test_recover_sketch_coefficients_matches():
    p = tproj.RandomProjectionMatrix.create(20, 6, 4).matrix.astype(np.float64)
    wk = np.random.default_rng(0).normal(size=(5, 6))
    rows = wk @ p.T
    ref = np.asarray(jcoord._recover_sketch_coefficients(jnp.asarray(rows), jnp.asarray(p)))
    got = tcoord._recover_sketch_coefficients(torch.from_numpy(rows), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), wk, rtol=1e-8, atol=1e-10)  # exact, not Pᵀw


@pytest.mark.parametrize("projector", ["INDEX_MAP", "RANDOM"])
def test_projected_bucket_solve_with_a_padding_lane(projector):
    """A padding lane (an out-of-range entity row) solves a zero problem,
    is marked invalid and writes nothing; the scratch column is zero after
    an INDEX_MAP solve."""
    a = projected_arrays(4, n=300)
    jd, td = datasets(a)
    build = {"projected_dim": 4} if projector == "RANDOM" else {}
    (jr, _), (tr, _) = _build_pair(a, jd, td, projector, "NONE", **build)
    jopt, topt = optimizer_pair("LBFGS", 8)
    from photon_ml_tpu.ops.losses import LogisticLoss as JL
    from photon_ml_tpu.ops.objective import GLMObjective as JObj
    from photon_ml_torch.ops.losses import LogisticLoss as TL
    from photon_ml_torch.ops.objective import GLMObjective as TObj

    jobj, tobj = JObj(JL(), l2_weight=1.0, use_pallas=False), TObj(TL(), l2_weight=1.0,
                                                                   use_kernel=False)
    jb, tb = jr.buckets[-1], tr.buckets[-1]
    rows = tb.entity_rows.numpy().copy()
    rows[1] = 2**31 - 1
    rng = np.random.default_rng(5)
    full = rng.normal(size=td.num_samples)
    t = torch.from_numpy
    if projector == "INDEX_MAP":
        table = np.concatenate([rng.normal(size=(tr.num_entities, tr.dim)),
                                np.zeros((tr.num_entities, 1))], axis=1)
        jt, jtrace = jcoord.solve_entity_bucket_indexmap_traced(
            jobj, jopt, jb.features, jb.labels, jb.weights, jb.sample_rows, jnp.asarray(rows),
            jb.col_index, jnp.asarray(full), jnp.asarray(table))
        tt, ttrace = tcoord.solve_entity_bucket_indexmap_traced(
            tobj, topt, tb.features, tb.labels, tb.weights, tb.sample_rows, t(rows),
            tb.col_index, t(full), t(table))
        assert (tt[:, -1] == 0).all()
        only = tcoord.solve_entity_bucket_indexmap(
            tobj, topt, tb.features, tb.labels, tb.weights, tb.sample_rows, t(rows),
            tb.col_index, t(full), t(table))
    else:
        table = rng.normal(size=(tr.num_entities, tr.dim))
        matrix = jr.projection.matrix.astype(np.float64)
        jt, jtrace = jcoord.solve_entity_bucket_random_traced(
            jobj, jopt, jb.features, jb.labels, jb.weights, jb.sample_rows, jnp.asarray(rows),
            jnp.asarray(matrix), jnp.asarray(full), jnp.asarray(table))
        tt, ttrace = tcoord.solve_entity_bucket_random_traced(
            tobj, topt, tb.features, tb.labels, tb.weights, tb.sample_rows, t(rows),
            t(matrix), t(full), t(table))
        only = tcoord.solve_entity_bucket_random(
            tobj, topt, tb.features, tb.labels, tb.weights, tb.sample_rows, t(rows),
            t(matrix), t(full), t(table))
    assert torch.equal(only, tt)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-9, atol=1e-10)
    assert np.array_equal(np.asarray(jtrace.valid), ttrace.valid.numpy())
    assert not bool(ttrace.valid[1]) and bool(ttrace.valid[0])
    untouched = np.setdiff1d(np.arange(tr.num_entities), rows[rows < tr.num_entities])
    np.testing.assert_array_equal(tt.numpy()[untouched, :tr.dim], table[untouched, :tr.dim])


@pytest.mark.parametrize("projector", ["INDEX_MAP", "RANDOM"])
def test_converted_projected_dataset_solves_alike(projector):
    """``convert.random_effect_dataset_from_numpy`` carries the column index,
    the matrix, the projector and the pre-normalization flag: the JAX
    package's buckets, converted, train to the same table."""
    a = projected_arrays(5, n=300)
    jd, td = datasets(a)
    build = {"projected_dim": 4} if projector == "RANDOM" else {}
    (jr, jn), (_, tn) = _build_pair(a, jd, td, projector, "STANDARDIZATION", **build)
    tr = convert.random_effect_dataset_from_numpy(
        random_effect_type=jr.random_effect_type, feature_shard_id=jr.feature_shard_id,
        buckets=[{f: None if getattr(b, f) is None else np.asarray(getattr(b, f))
                  for f in ("features", "labels", "weights", "entity_rows", "sample_rows",
                            "col_index")} for b in jr.buckets],
        num_entities=jr.num_entities, dim=jr.dim, projector_type=jr.projector_type,
        projection_matrix=None if jr.projection is None else jr.projection.matrix,
        pre_normalized=jr.pre_normalized, device="cpu")
    assert tr.projector_type.value == projector and tr.pre_normalized
    jc, tc = _coordinate_pair(a, jd, td, projector, "STANDARDIZATION", "NEWTON",
                              prebuilt=((jr, jn), (tr, tn)))
    _run_updates(jc, tc, td, sweeps=1)
