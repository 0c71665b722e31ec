"""The port's incremental refresh (``algorithm/refresh.py``,
``GameEstimator.refresh``) against the JAX package's, on the CPU in float64:
the selected entity sets equal, refreshed tables within 1e-8·max|w| with
unselected rows bitwise the resident rows, the fingerprints equal dicts and
the mismatch errors with the same message, and a refresh stopped after its
first coordinate and resumed bitwise the uninterrupted one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.algorithm import refresh as jrefresh
from photon_ml_torch import convert
from photon_ml_torch.algorithm import refresh as trefresh
from photon_ml_torch.algorithm.coordinates import RandomEffectCoordinate
from photon_ml_torch.io.checkpoint import TrainingCheckpointer
from photon_ml_torch.resilience import recovery
from photon_ml_torch.telemetry import refresh_counters
from tests.torch_game_parity import (
    assert_models_close,
    datasets,
    estimator_pair,
    game_arrays,
    model_to_plain,
)


@pytest.fixture(scope="module")
def resident():
    """A JAX-trained resident model (carried into the port), and the same
    data with the labels of users u1-u4 redrawn (the day's changes)."""
    a = game_arrays(11)
    jd, _ = datasets(a)
    je, te = estimator_pair(num_iterations=2, lane_iterations=12)
    jmodel = je.fit(jd).model
    tmodel = convert.game_model_from_numpy(model_to_plain(jmodel), device="cpu")
    b = dict(a)
    rng = np.random.default_rng(5)
    changed = np.isin(a["users"], ["u1", "u2", "u3", "u4"])
    b["labels"] = np.where(changed, (rng.uniform(size=len(changed)) < 0.5).astype(float),
                           a["labels"])
    return je, te, jmodel, tmodel, b


def _policies(kind):
    changed = {"user": ["u1", "u2", "u3", "u4", "u999"]}
    policy = {"declared": dict(changed_entities=changed, gradient_tolerance=None),
              "gradient": dict(gradient_tolerance=0.05),
              "both-fe": dict(changed_entities=changed, gradient_tolerance=None,
                              refresh_fixed_effects=True)}[kind]
    return jrefresh.RefreshPolicy(**policy), trefresh.RefreshPolicy(**policy)


@pytest.mark.parametrize("kind", ["declared", "gradient", "both-fe"])
def test_refresh_matches(resident, kind):
    je, te, jmodel, tmodel, b = resident
    jd, td = datasets(b)
    jp, tp = _policies(kind)
    refresh_counters.reset_refresh_metrics()
    jr = je.refresh(jd, jmodel, jp)
    tr = te.refresh(td, tmodel, tp)
    assert_models_close(jr.model, tr.model)
    for key in ("lanes_total", "lanes_solved", "lanes_changed", "lanes_gradient"):
        assert getattr(tr, key) == getattr(jr, key), key
    assert tr.coordinate_stats == jr.coordinate_stats
    assert 0 < tr.lanes_solved < tr.lanes_total
    ev = refresh_counters.selection_evidence()
    assert ev["lanes_solved"] == tr.lanes_solved and ev["lanes_total"] == tr.lanes_total
    # the rows the refresh did not select carry over bitwise
    for cid in ("per_user", "per_item"):
        old, new = tmodel.get(cid).coefficients, tr.model.get(cid).coefficients
        same = torch.all(old == new, dim=1).numpy()
        assert same.any() or cid == "per_item"
        if kind != "gradient" and cid == "per_item":
            assert same.all()  # no item was declared
    if kind != "both-fe":
        assert torch.equal(tr.model.get("fixed").glm.coefficients.means,
                           tmodel.get("fixed").glm.coefficients.means)


def test_selection_matches(resident):
    je, te, jmodel, tmodel, b = resident
    jd, td = datasets(b)
    jp, tp = _policies("declared")
    jp = dataclasses.replace(jp, gradient_tolerance=1e-4)
    tp = dataclasses.replace(tp, gradient_tolerance=1e-4)
    _, jcoords = je._build_coordinates(jd, jmodel)
    _, tcoords = te._build_coordinates(td, tmodel)
    for cid in ("per_user", "per_item"):
        jc, tc = jcoords[cid], tcoords[cid]
        jpartial = sum(jcoords[o].score(jmodel.get(o)) for o in jcoords if o != cid)
        tpartial = sum(tcoords[o].score(tmodel.get(o)) for o in tcoords if o != cid)
        jsel, jstats = jrefresh.select_refresh_entities(jc, jmodel.get(cid), jpartial, jp)
        tsel, tstats = trefresh.select_refresh_entities(tc, tmodel.get(cid), tpartial, tp)
        assert np.array_equal(jsel, tsel) and jstats == tstats
        ref = jc.refresh_gradient_norms(jmodel.get(cid), jnp.asarray(jpartial))
        got = tc.refresh_gradient_norms(tmodel.get(cid), tpartial)
        assert np.array_equal(np.isnan(ref), np.isnan(got))
        np.testing.assert_allclose(got[~np.isnan(got)], ref[~np.isnan(ref)], rtol=1e-8,
                                   atol=1e-12)


def test_fingerprints_and_mismatch_errors_match(resident):
    je, te, jmodel, tmodel, b = resident
    jd, td = datasets(b)
    seq = list(te.coordinate_configs)
    reg = {"fixed": 0.5, "per_user": 1.0, "per_item": 1.0}
    jexp = jrefresh.expected_fingerprint(jd, je.coordinate_configs, seq, reg)
    texp = trefresh.expected_fingerprint(td, te.coordinate_configs, seq, reg)
    assert jexp == texp
    jfp = jrefresh.model_fingerprint(jmodel, seq, reg)
    tfp = trefresh.model_fingerprint(tmodel, seq, reg)
    assert jfp == tfp == texp
    other = dict(reg, per_user=2.0)
    msgs = []
    for mod, fp in ((jrefresh, jfp), (trefresh, tfp)):
        with pytest.raises(mod.RefreshFingerprintError) as err:
            mod.check_refresh_fingerprint(fp, mod.expected_fingerprint(
                jd if mod is jrefresh else td,
                (je if mod is jrefresh else te).coordinate_configs, seq, other))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "per_user/lambda" in msgs[1]


def test_resume_is_bitwise_and_guarded(resident, tmp_path, monkeypatch):
    _, te, _, tmodel, b = resident
    _, td = datasets(b)
    _, tp = _policies("both-fe")
    seq = list(te.coordinate_configs)
    fp = trefresh.expected_fingerprint(td, te.coordinate_configs, seq, {"per_user": 1.0})
    whole = te.refresh(td, tmodel, tp, fingerprint=fp).model

    ck = TrainingCheckpointer(tmp_path / "ck")
    original = RandomEffectCoordinate.update_model

    def stop_at_the_second(self, model, extra=None):
        if self.coordinate_id == "per_user":
            raise KeyboardInterrupt("stopped")
        return original(self, model, extra)

    monkeypatch.setattr(RandomEffectCoordinate, "update_model", stop_at_the_second)
    with pytest.raises(KeyboardInterrupt):
        te.refresh(td, tmodel, tp, checkpointer=ck, fingerprint=fp)
    monkeypatch.setattr(RandomEffectCoordinate, "update_model", original)
    assert ck.latest_step() == 1
    recovery.reset_counts()
    resumed = te.refresh(td, tmodel, tp, checkpointer=ck, fingerprint=fp).model
    assert recovery.counts["checkpoint_restores"] == 1
    got, ref = convert.game_model_to_numpy(resumed), convert.game_model_to_numpy(whole)
    for cid in ref:
        for key, value in ref[cid].items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(got[cid][key], value), (cid, key)
    other = trefresh.expected_fingerprint(td, te.coordinate_configs, seq, {"per_user": 3.0})
    with pytest.raises(trefresh.RefreshFingerprintError, match="per_user/lambda"):
        te.refresh(td, tmodel, tp, checkpointer=ck, fingerprint=other)


def test_refresh_refusals(resident):
    _, te, _, tmodel, b = resident
    _, td = datasets(b)
    with pytest.raises(ValueError, match="single-process host path"):
        dataclasses.replace(te, mesh=object()).refresh(td, tmodel)
    partial = convert.game_model_from_numpy(
        {k: v for k, v in convert.game_model_to_numpy(tmodel).items() if k != "per_item"},
        device="cpu")
    with pytest.raises(trefresh.RefreshFingerprintError, match="no coordinate 'per_item'"):
        te.refresh(td, partial)
