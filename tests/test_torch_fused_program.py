"""The fused GAME training program (``photon_ml_torch.parallel.distributed``,
one device) held against the JAX package's ``GameTrainProgram`` and
``train_distributed`` with ``mesh=None``, on the CPU in float64: per-sweep
training losses and final state tensors at rel 1e-8 (TRON lanes 1e-5), the
variances, the model conversions both ways, and a warm start from a saved
and reloaded model onto a dataset whose vocab is reordered. The cases are
``tests/torch_fused_parity.CASES``; each is trained once a session."""

import numpy as np
import pytest
import torch

from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_torch import convert
from photon_ml_torch.io.index_map import IndexMap, feature_key
from photon_ml_torch.io.model_io import load_game_model, save_game_model
from photon_ml_torch.parallel import distributed as tdist
from tests.torch_fused_parity import CASES, assert_states_close, run
from tests.torch_game_parity import assert_models_close

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds


@pytest.mark.parametrize("name", CASES)
def test_fused_sweeps_match_the_jax_program(name):
    case, j, t = run(name)
    assert isinstance(t, tdist.DistributedTrainResult)
    state, losses = t
    assert state is t.state and losses is t.losses and len(losses) == case.sweeps
    np.testing.assert_allclose(t.losses, j.losses, rtol=case.rel)
    assert_states_close(j.state, t.state, case.rel)
    assert all(b <= a * (1 + 1e-9) for a, b in zip(t.losses, t.losses[1:])), t.losses
    # the programs resolved the same solvers and the same sweep order
    assert t.state.re_tables.keys() == j.state.re_tables.keys()
    assert case.tprog.update_order == case.jprog.update_order
    assert [s.optimizer.optimizer_type.name for s in case.tprog.re_specs] == \
        [s.optimizer.optimizer_type.name for s in case.jprog.re_specs]
    assert len(t.metric_history) == len(j.metric_history)
    for hj, ht in zip(j.metric_history, t.metric_history):
        assert ht.keys() == hj.keys() and ht["coordinate"] == "fused_sweep"
        for k in hj:
            if k.startswith("validate:"):
                assert ht[k] == pytest.approx(hj[k], rel=case.rel), k
    if case.jval is None:
        assert t.best_state is None and j.best_state is None
        assert np.isnan(t.best_metric) and np.isnan(j.best_metric)
    else:
        assert t.best_metric == pytest.approx(j.best_metric, rel=case.rel)
        assert (t.best_state is None) == (j.best_state is None)
        if j.best_state is not None:
            assert_states_close(j.best_state, t.best_state, case.rel)


def _carried(name):
    case, j, _ = run(name)
    return case, j.state, convert.train_state_from_numpy(j.state, device="cpu")


VARIANCES = [("standardized_re", "full"), ("standardized_re", "diagonal"),
             ("random_re", "full"), ("random_re", "diagonal"), ("compact_re", "auto"),
             ("sparse_fe_indexmap", "auto"), ("extra_fe", "full"), ("dryrun", "auto")]


@pytest.mark.parametrize("name,mode", VARIANCES, ids=[f"{n}-{m}" for n, m in VARIANCES])
def test_state_variances_match(name, mode):
    """compute_state_variances at the JAX program's final state, carried
    across: every coordinate's variances at rel 1e-8, NaN in the same
    places (entities no bucket trained)."""
    case, jstate, tstate = _carried(name)
    jfe, jre, jextra = jdist.compute_state_variances(case.jprog, jstate, case.jds, case.jre,
                                                     variance_mode=mode)
    tfe, tre, textra = tdist.compute_state_variances(case.tprog, tstate, case.tds, case.tre,
                                                     variance_mode=mode)
    assert tre.keys() == jre.keys() and textra.keys() == jextra.keys()
    for ref, got in [(jfe, tfe)] + [(jre[k], tre[k]) for k in jre] \
            + [(jextra[k], textra[k]) for k in jextra]:
        ref, got = np.asarray(ref), got.numpy()
        assert np.array_equal(np.isnan(ref), np.isnan(got))
        np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8 * np.nanmax(np.abs(ref)))
    # only the selected coordinates
    some = {case.tprog.re_specs[0].re_type}
    assert tdist.compute_state_variances(case.tprog, tstate, case.tds, case.tre,
                                         re_types=some)[1].keys() == some


MODELS = [("standardized_re", 5, True), ("compact_re", None, True), ("dryrun", None, False),
          ("extra_fe", None, True), ("random_re", None, False)]


@pytest.mark.parametrize("name,intercept,variance", MODELS, ids=[m[0] for m in MODELS])
def test_state_to_game_model_matches(name, intercept, variance):
    case, jstate, tstate = _carried(name)
    kw = dict(intercept_index=intercept, compute_variance=variance)
    jmodel = jdist.state_to_game_model(case.jprog, jstate, case.jds, re_datasets=case.jre, **kw)
    tmodel = tdist.state_to_game_model(case.tprog, tstate, case.tds, re_datasets=case.tre, **kw)
    assert_models_close(jmodel, tmodel)
    if name == "compact_re":
        got, ref = tmodel.get("user"), jmodel.get("user")
        assert np.array_equal(got.active_cols, np.asarray(ref.active_cols))
        assert got.feature_dim == ref.feature_dim
    # and back: the state again (the FE through the normalization)
    back = tdist.game_model_to_state(case.tprog, tmodel, case.tds, intercept_index=intercept,
                                     re_datasets=case.tre, mf_datasets=case.tmf or None)
    assert_states_close(jstate, back, 1e-10)
    np.testing.assert_allclose(
        case.tprog.fe_coefficients_model_space(tstate, intercept).numpy(),
        np.asarray(case.jprog.fe_coefficients_model_space(jstate, intercept)), rtol=1e-12)


def _index_maps(ds) -> dict:
    return {shard: IndexMap({feature_key(f"f{j}"): j for j in range(x.shape[1])})
            for shard, x in ds.feature_shards.items()}


def _reordered(case, side):
    """The case's training data again with every entity vocab reversed and
    one unseen key appended (it starts at zero)."""
    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_torch.data import game_data as tgd

    ds = (case.jds, case.tds)[side]
    host = (lambda k: np.asarray(getattr(ds, k))) if side == 0 else ds.host_array
    keys = {t: np.asarray(v)[(np.asarray(ds.entity_idx[t]) if side == 0
                              else ds.host_array(f"entity_idx/{t}"))]
            for t, v in ds.entity_vocabs.items()}
    vocabs = {t: np.append(np.asarray(v)[::-1], f"new-{t}") for t, v in ds.entity_vocabs.items()}
    shards = {k: np.asarray(v) if side == 0 else v.numpy() for k, v in ds.feature_shards.items()}
    kw = dict(labels=host("labels"), feature_shards=shards, entity_keys=keys,
              offsets=host("offsets"), weights=host("weights"), unique_ids=ds.unique_ids,
              entity_vocabs=vocabs, dtype=np.float64)
    return jgd.build_game_dataset(**kw) if side == 0 else tgd.build_game_dataset(**kw,
                                                                                  device="cpu")


@pytest.mark.parametrize("name", ["permuted_order", "standardized_re"])
def test_warm_start_from_a_reloaded_model_on_a_reordered_vocab(name, tmp_path):
    """state_to_game_model -> save_game_model -> load_game_model ->
    game_model_to_state onto a dataset whose vocabs are reversed (plus an
    unseen key): the tables follow the keys, as the JAX package's
    game_model_to_state of the same model does; one warm-started sweep then
    matches the JAX program's."""
    from photon_ml_tpu.algorithm import mf_coordinate as jmfc
    from photon_ml_tpu.data import game_data as jgd
    from photon_ml_torch.algorithm import mf_coordinate as tmfc
    from photon_ml_torch.data import game_data as tgd

    case, jstate, tstate = _carried(name)
    intercept = 5 if name == "standardized_re" else None
    jmodel = jdist.state_to_game_model(case.jprog, jstate, case.jds, intercept_index=intercept,
                                       re_datasets=case.jre)
    tmodel = tdist.state_to_game_model(case.tprog, tstate, case.tds, intercept_index=intercept,
                                       re_datasets=case.tre)
    maps = _index_maps(case.tds)
    save_game_model(tmp_path, tmodel, maps, sparsity_threshold=0.0)
    loaded = load_game_model(tmp_path, maps, dtype=np.float64, device="cpu")
    jds2, tds2 = _reordered(case, 0), _reordered(case, 1)
    types = [s.re_type for s in case.tprog.re_specs]
    jre2 = {t: jgd.build_random_effect_dataset(jds2, t, "per_entity", bucket_sizes=(8, 32, 128))
            for t in types}
    tre2 = {t: tgd.build_random_effect_dataset(tds2, t, "per_entity", bucket_sizes=(8, 32, 128))
            for t in types}
    jmf2 = {m.name: jmfc.build_mf_dataset(jds2, m.row_effect_type, m.col_effect_type,
                                          bucket_sizes=(8, 32, 128))
            for m in case.jprog.mf_specs}
    tmf2 = {m.name: tmfc.build_mf_dataset(tds2, m.row_effect_type, m.col_effect_type,
                                          bucket_sizes=(8, 32, 128))
            for m in case.tprog.mf_specs}
    jwarm = jdist.game_model_to_state(case.jprog, jmodel, jds2, intercept_index=intercept,
                                      re_datasets=jre2)
    twarm = tdist.game_model_to_state(case.tprog, loaded, tds2, intercept_index=intercept,
                                      re_datasets=tre2)
    assert_states_close(jwarm, twarm, 1e-10)
    for t in types:  # the appended key is unseen: its row starts at zero
        assert not twarm.re_tables[t][-1].any()
        vocab = tds2.entity_vocabs[t]
        row = int(np.flatnonzero(vocab == case.tds.entity_vocabs[t][0])[0])
        np.testing.assert_allclose(twarm.re_tables[t][row].numpy(),
                                   tstate.re_tables[t][0].numpy(), rtol=1e-10)
    j1 = jdist.train_distributed(case.jprog, jds2, jre2, mf_datasets=jmf2 or None, state=jwarm,
                                 num_iterations=1)
    t1 = tdist.train_distributed(case.tprog, tds2, tre2, mf_datasets=tmf2 or None, state=twarm,
                                 num_iterations=1)
    np.testing.assert_allclose(t1.losses, j1.losses, rtol=1e-8)
    assert t1.losses[0] <= run(name)[2].losses[-1] * (1 + 1e-9)
    assert_states_close(j1.state, t1.state, 1e-8)


def test_missing_ok_cold_starts_absent_coordinates():
    """A partial model warm-starts a program with more coordinates: the
    absent RE table starts at zero and the absent MF factors from
    init_factors with untrained rows zeroed; without missing_ok both
    packages raise KeyError; an MF model of another latent dimension
    raises the JAX package's ValueError."""
    import dataclasses

    from photon_ml_tpu.models.game import GameModel as JGameModel
    from photon_ml_torch.models.game import GameModel

    case, jstate, tstate = _carried("permuted_order")
    jmodel = jdist.state_to_game_model(case.jprog, jstate, case.jds, re_datasets=case.jre)
    tmodel = tdist.state_to_game_model(case.tprog, tstate, case.tds, re_datasets=case.tre)
    keep = ("global", "user")
    jpart = JGameModel(models={k: v for k, v in jmodel.models.items() if k in keep})
    tpart = GameModel(models={k: v for k, v in tmodel.models.items() if k in keep})
    for dist, prog, model, ds, re_ds, mf_ds in (
            (jdist, case.jprog, jpart, case.jds, case.jre, case.jmf),
            (tdist, case.tprog, tpart, case.tds, case.tre, case.tmf)):
        with pytest.raises(KeyError):
            dist.game_model_to_state(prog, model, ds, re_datasets=re_ds, mf_datasets=mf_ds)
        with pytest.raises(ValueError, match="cannot size"):
            dist.game_model_to_state(prog, model, ds, missing_ok=True)
    jwarm = jdist.game_model_to_state(case.jprog, jpart, case.jds, missing_ok=True,
                                      re_datasets=case.jre, mf_datasets=case.jmf)
    twarm = tdist.game_model_to_state(case.tprog, tpart, case.tds, missing_ok=True,
                                      re_datasets=case.tre, mf_datasets=case.tmf)
    assert not twarm.re_tables["item"].any()
    np.testing.assert_array_equal(twarm.re_tables["user"].numpy(),
                                  tstate.re_tables["user"].numpy())
    # the cold-started MF factors are each package's own init_factors draws
    # (threefry against a torch generator), so only their zero rows agree
    for side in ("mf_rows", "mf_cols"):
        ref, got = np.asarray(getattr(jwarm, side)["mf"]), getattr(twarm, side)["mf"].numpy()
        assert np.array_equal(ref == 0, got == 0) and got.any()
    mf = tmodel.get("mf")
    wide = dataclasses.replace(mf, row_factors=torch.cat([mf.row_factors] * 2, 1),
                               col_factors=torch.cat([mf.col_factors] * 2, 1))
    with pytest.raises(ValueError, match="latent dimension 4"):
        tdist.game_model_to_state(case.tprog, tmodel.updated("mf", wide), case.tds,
                                  re_datasets=case.tre)
