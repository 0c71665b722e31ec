"""The mesh layout's padding and refusals, in this process (no spawned
ranks; a group of one where a collective is needed).

Padded bucket lanes carry out-of-range entity rows: with non-zero values
planted in them they still write no table row, in the random-effect, the
INDEX_MAP and the MF solves and in the table exchange. Padded rows carry
weight 0 and query code Q: planted with large scores they move no metric.
The model axis's entry points in a group of one train, lay out or refuse as
the JAX package's do.
"""

import dataclasses

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_data as jgd
from photon_ml_torch.algorithm.coordinates import (
    _with_scratch_column,
    solve_entity_bucket,
    solve_entity_bucket_indexmap,
)
from photon_ml_torch.algorithm.mf_coordinate import build_mf_dataset, solve_mf_side_bucket
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data.batch import LabeledPointBatch as TBatch
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.evaluation import sharded as tsh
from photon_ml_torch.models.game import GameModel
from photon_ml_torch.ops.losses import LogisticLoss
from photon_ml_torch.ops.objective import GLMObjective
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.parallel import mesh as M
from photon_ml_torch.parallel import multihost
from photon_ml_torch.parallel.scoring import DistributedScorer
from photon_ml_torch.transformers import GameTransformer
from photon_ml_torch.types import TaskType
from tests import torch_mesh_parity as MP
from tests import torch_mesh_worker as W

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

OPT = OptimizerConfig(OptimizerType.LBFGS, max_iterations=10)


@pytest.fixture
def group_of_one():
    """A one-rank gloo group in this process, destroyed after the test."""
    multihost.initialize(device="cpu")
    try:
        yield M.make_mesh()
    finally:
        multihost.shutdown()


def _planted(b: dict, pad: int, rng) -> dict:
    """``b`` padded by ``pad`` lanes whose features, labels, weights, column
    indices and sample rows hold planted non-zero values (entity rows stay
    out of range)."""
    out = tgd.pad_lane_fields(b, int(b["entity_rows"].shape[0]) + pad)
    e = int(b["entity_rows"].shape[0])
    for k, v in out.items():
        if v is None or k == "entity_rows":
            continue
        tail = v[e:]
        if k in ("sample_rows", "col_index"):
            out[k] = torch.cat([v[:e], torch.zeros_like(tail)])
        else:
            out[k] = torch.cat([v[:e], torch.as_tensor(rng.uniform(0.5, 2.0, size=tail.shape),
                                                       dtype=v.dtype)])
    assert (out["entity_rows"][e:] == tgd.PAD_ENTITY_ROW).all()
    return out


def _dataset(projector=None):
    a = MP.arrays(4, zero_share=0.3 if projector else 0.0)
    ds = W.build_dataset(a)
    kw = {} if projector is None else {"projector_type": projector}
    return ds, tgd.build_random_effect_dataset(ds, "user", "per_entity", bucket_sizes=(8, 32, 128),
                                               **kw)


def _fields(b) -> dict:
    return {k: getattr(b, k) for k in ("features", "labels", "weights", "entity_rows",
                                       "sample_rows", "col_index")}


def test_planted_padding_lanes_write_no_table_row():
    rng = np.random.default_rng(0)
    ds, re_ds = _dataset()
    obj = GLMObjective(LogisticLoss(), l2_weight=1.0)
    offsets = ds.offsets
    table = torch.zeros((re_ds.num_entities, re_ds.dim), dtype=torch.float64)
    for b in re_ds.buckets:
        f = _fields(b)
        ref = solve_entity_bucket(obj, OPT, f["features"], f["labels"], f["weights"],
                                  f["sample_rows"], f["entity_rows"], offsets, table)
        p = _planted(f, 3, rng)
        got = solve_entity_bucket(obj, OPT, p["features"], p["labels"], p["weights"],
                                  p["sample_rows"], p["entity_rows"], offsets, table)
        assert torch.equal(got, ref)


def test_planted_padding_lanes_write_no_cell_of_an_index_map_table():
    from photon_ml_torch.projector.projectors import ProjectorType

    rng = np.random.default_rng(1)
    ds, re_ds = _dataset(ProjectorType.INDEX_MAP)
    obj = GLMObjective(LogisticLoss(), l2_weight=1.0)
    table = _with_scratch_column(torch.zeros((re_ds.num_entities, re_ds.dim),
                                             dtype=torch.float64))
    for b in re_ds.buckets:
        f = _fields(b)
        args = (f["sample_rows"], f["entity_rows"], f["col_index"], ds.offsets, table)
        ref = solve_entity_bucket_indexmap(obj, OPT, f["features"], f["labels"], f["weights"],
                                           *args)
        p = _planted(f, 2, rng)
        got = solve_entity_bucket_indexmap(obj, OPT, p["features"], p["labels"], p["weights"],
                                           p["sample_rows"], p["entity_rows"], p["col_index"],
                                           ds.offsets, table)
        assert torch.equal(got, ref)


def test_planted_padding_lanes_write_no_mf_factor():
    rng = np.random.default_rng(2)
    ds, _ = _dataset()
    mf = build_mf_dataset(ds, "user", "item", bucket_sizes=(8, 32, 128))
    obj = GLMObjective(LogisticLoss(), l2_weight=1.0)
    rows = torch.as_tensor(rng.normal(size=(mf.num_row_entities, 2)))
    cols = torch.as_tensor(rng.normal(size=(mf.num_col_entities, 2)))
    col_idx = ds.entity_idx["item"]
    for b in mf.row_buckets:
        f = {"labels": b.labels, "weights": b.weights, "entity_rows": b.entity_rows,
             "sample_rows": b.sample_rows}
        ref, _ = solve_mf_side_bucket(obj, OPT, f["labels"], f["weights"], f["entity_rows"],
                                      f["sample_rows"], col_idx, cols, ds.offsets, rows)
        p = _planted(f, 5, rng)
        got, _ = solve_mf_side_bucket(obj, OPT, p["labels"], p["weights"], p["entity_rows"],
                                      p["sample_rows"], col_idx, cols, ds.offsets, rows)
        assert torch.equal(got, ref)


def test_the_table_exchange_writes_only_owned_rows(group_of_one):
    """MeshLayout.share writes the rows a rank's lanes own and drops the
    padding lanes' out-of-range rows; the others keep their values."""
    table = torch.arange(12.0).reshape(6, 2)
    solved = table + 100.0
    pad = tgd.PAD_ENTITY_ROW
    owned = torch.tensor([4, 1, pad, pad])
    layout = tdist.MeshLayout(mesh=group_of_one, rows=slice(0, 6), num_rows=6,
                              owned={"user": (owned, owned)})
    got = layout.share("user", solved)
    assert torch.equal(got[[1, 4]], solved[[1, 4]])
    assert torch.equal(got, solved)  # a group of one gathers its own rows back
    layout.owned["user"] = (owned, torch.tensor([4, pad, pad, pad]))
    stale = layout.share("user", table.clone())
    assert torch.equal(stale, table)


def test_lane_multiple_pads_buckets_and_trains_the_same_table():
    ds, re_ds = _dataset()
    padded = tgd.build_random_effect_dataset(ds, "user", "per_entity", bucket_sizes=(8, 32, 128),
                                             lane_multiple=4)
    for a, b in zip(re_ds.buckets, padded.buckets):
        e = a.num_entities
        assert b.num_entities % 4 == 0 and b.num_entities - e < 4
        assert torch.equal(b.features[:e], a.features)
        assert (b.entity_rows[e:] == tgd.PAD_ENTITY_ROW).all()
        assert (b.sample_rows[e:] == -1).all() and (b.weights[e:] == 0).all()
    prog = tdist.GameTrainProgram(TaskType.LOGISTIC_REGRESSION,
                                  tdist.FixedEffectStepSpec("global", OPT, l2_weight=1.0),
                                  (tdist.RandomEffectStepSpec("user", "per_entity", OPT,
                                                              l2_weight=1.0),))
    one = tdist.train_distributed(prog, ds, {"user": re_ds}, num_iterations=2)
    two = tdist.train_distributed(prog, ds, {"user": padded}, num_iterations=2)
    assert torch.equal(one.state.re_tables["user"], two.state.re_tables["user"])


def test_pad_game_dataset_to_matches_the_jax_package():
    a = MP.arrays(5)
    jds, _ = jgd.pad_game_dataset_to(MP.jdataset(a), 211)
    tds, n = tgd.pad_game_dataset_to(W.build_dataset(a), 211)
    assert n == 203 and tds.num_samples == 211
    for name in ("labels", "offsets", "weights", "shard/per_entity", "entity_idx/user"):
        np.testing.assert_array_equal(tds.host_array(name), np.asarray(jds.host_array(name)))
    np.testing.assert_array_equal(tds.unique_ids, np.asarray(jds.unique_ids))
    with pytest.raises(ValueError, match="down to"):
        tgd.pad_game_dataset_to(tds, 100)


@pytest.mark.parametrize("world", [2, 4])
def test_padded_rows_move_no_metric(world):
    rng = np.random.default_rng(3)
    n = 97
    scores = np.round(rng.normal(size=n), 1)
    data = tev.EvaluationData(labels=(rng.uniform(size=n) < 0.5) * 1.0, offsets=np.zeros(n),
                              weights=rng.uniform(0.5, 1.5, size=n),
                              ids={"queryId": rng.integers(0, 5, size=n)})
    n_pad = n + (-n) % world + world
    padded = torch.as_tensor(np.concatenate([scores, np.full(n_pad - n, 1e3)]))
    specs = ["AUC", "AUPR", "RMSE", "LOGISTIC_LOSS", "AUC:queryId", "RMSE:queryId",
             "PRECISION@2:queryId"]
    evs = [tev.parse_evaluator(s) for s in specs]
    devs = tsh.prepare_device_evaluators(evs, data, n_pad=n_pad, device="cpu")
    got = tsh.evaluate_prepared(evs, devs, padded, data, lambda: scores)
    for spec, ev, v in zip(specs, evs, got):
        assert v == pytest.approx(ev.evaluate(scores, data), rel=1e-12, abs=1e-12), spec


def test_mesh_helpers_in_a_group_of_one(group_of_one):
    mesh = group_of_one
    assert (M.data_rank(mesh), M.data_size(mesh)) == (0, 1)
    x = torch.arange(6.0)
    assert torch.equal(M.all_reduce_sum(x, mesh), x)
    assert torch.equal(M.all_gather_rows(x, mesh), x)
    assert torch.equal(M.replicate({"a": [x]}, mesh)["a"][0], x)
    ds = W.build_dataset(MP.arrays(6))
    rows = M.shard_game_dataset(ds, mesh)
    assert torch.equal(rows.labels, ds.labels) and rows.entity_vocabs is ds.entity_vocabs
    assert isinstance(multihost.default_exchange(), multihost.SingleProcessExchange)
    assert multihost.initialize(device="cpu").world_size == 1  # idempotent


def test_initialize_refuses_what_it_cannot_build():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize()  # entry points run on the card unless asked
    with pytest.raises(ValueError, match="outside a world"):
        multihost.initialize(num_processes=2, process_id=2, device="cpu")
    with pytest.raises(ValueError, match="init_method"):
        multihost.initialize(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize(device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def _model():
    ds = W.build_dataset(MP.arrays(7))
    prog = tdist.GameTrainProgram(TaskType.LOGISTIC_REGRESSION,
                                  tdist.FixedEffectStepSpec("global", OPT))
    res = tdist.train_distributed(prog, ds, {}, num_iterations=1)
    return tdist.state_to_game_model(prog, res.state, ds), ds


@pytest.mark.parametrize("what", ["make_mesh(model=2)", "hybrid mesh model=2", "program",
                                  "train_distributed", "shard_batch", "scorer", "transformer",
                                  "score_partitioned", "estimator"])
def test_model_axis_entry_points_in_a_group_of_one(what, group_of_one):
    """The model axis's entry points in a group of one: a model axis wider
    than the group is a shape error; the program and train_distributed with
    ``fe_feature_sharded`` and no model axis train as without it (one column
    block); shard_batch's feature block of a 1x1 mesh is the whole batch;
    the scorer, the transformer and the estimator raise the JAX package's
    ValueError without a mesh, as score_partitioned does."""
    from photon_ml_torch import estimators as test_

    model, ds = _model()
    fe = tdist.FixedEffectStepSpec("global", OPT)
    if what in ("make_mesh(model=2)", "hybrid mesh model=2"):
        build = M.make_mesh if what.startswith("make_mesh") else multihost.make_hybrid_mesh
        with pytest.raises(ValueError, match="needs 2 ranks, the group has 1"):
            build(data=1, model=2)
        mesh = build(data=1, model=1)
        assert (M.data_size(mesh), M.model_size(mesh), M.model_rank(mesh)) == (1, 1, 0)
        return
    if what in ("program", "train_distributed"):
        plain = tdist.train_distributed(tdist.GameTrainProgram(TaskType.LOGISTIC_REGRESSION, fe),
                                        ds, {}, num_iterations=1)
        prog = tdist.GameTrainProgram(TaskType.LOGISTIC_REGRESSION, fe,
                                      fe_feature_sharded=what == "program")
        got = tdist.train_distributed(prog, ds, {}, num_iterations=1, fe_feature_sharded=True)
        assert got.losses == plain.losses and got.state.fe_columns is None
        assert torch.equal(got.state.fe_coefficients, plain.state.fe_coefficients)
        return
    if what == "shard_batch":
        x = torch.as_tensor(np.arange(12.0).reshape(4, 3))
        batch = TBatch(features=x, labels=torch.zeros(4), offsets=torch.zeros(4),
                       weights=torch.ones(4))
        local = M.shard_batch(batch, group_of_one, feature_sharded=True)
        assert torch.equal(local.features, x)
        return
    calls = {
        "scorer": lambda: DistributedScorer(model, None, fe_feature_sharded=True),
        "transformer": lambda: GameTransformer(model, fe_feature_sharded=True).transform(ds),
        "score_partitioned": lambda: DistributedScorer(model).score_partitioned({}, None),
        "estimator": lambda: test_.GameEstimator(TaskType.LOGISTIC_REGRESSION, {},
                                                 fe_feature_sharded=True).fit(None),
    }
    message = {"score_partitioned": "^score_partitioned requires a mesh$",
               "estimator": "^fe_feature_sharded requires a mesh"}.get(
        what, "^fe_feature_sharded requires a mesh$")
    with pytest.raises(ValueError, match=message):
        calls[what]()


def test_default_exchange_in_a_group_of_two(tmp_path):
    """A group of two gets the key-value exchange over the group's store (a
    group of one keeps the single-process one, above)."""
    got = W.spawn_ranks(2, [dict(kind="exchange", timeout=1.0)], tmp_path)[0]
    assert [g["type"] for g in got] == ["DistributedKVExchange"] * 2
    assert got[1]["second"] == [0, 10]


def test_scorer_swaps_a_model_of_the_same_layout_only():
    """swap_model_params takes a model whose parameter layout is the same
    (params_layout_fingerprint) and scores with it; another layout raises
    ValueError naming the field, and the scorer keeps its model."""
    from photon_ml_torch.parallel.scoring import params_layout_fingerprint

    model, ds = _model()
    scorer = DistributedScorer(model)
    before = scorer.score_dataset(ds)
    fe = model.get("global")
    doubled = GameModel(models={"global": dataclasses.replace(
        fe, glm=dataclasses.replace(fe.glm, coefficients=dataclasses.replace(
            fe.glm.coefficients, means=2 * fe.glm.coefficients.means)))})
    assert params_layout_fingerprint(doubled) == params_layout_fingerprint(model)
    scorer.swap_model_params(doubled)
    offsets = ds.host_array("offsets")
    np.testing.assert_allclose(scorer.score_dataset(ds) - offsets, 2 * (before - offsets),
                               rtol=1e-12, atol=1e-12)
    wider = GameModel(models={"global": dataclasses.replace(
        fe, glm=dataclasses.replace(fe.glm, coefficients=dataclasses.replace(
            fe.glm.coefficients, means=torch.zeros(fe.glm.coefficients.means.shape[0] + 1,
                                                   dtype=torch.float64))))})
    with pytest.raises(ValueError, match="global/w"):
        scorer.swap_model_params(wider)
    assert scorer.model is doubled
