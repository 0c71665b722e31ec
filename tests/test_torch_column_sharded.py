"""The port's column-sharded GLM (``parallel/column_sharded.py``) against the
JAX package's, in float64 on the CPU.

The builder's arrays are held array for array in this process; the
objective and the solvers over it run in spawned gloo ranks
(``tests/torch_mesh_worker.py``), one group of 2 ranks as a 1x2 mesh and
one of 4 as a 1x4 mesh for the whole file, against the JAX package's
``ColumnShardedGLMObjective`` on its 8-device virtual CPU mesh and its
one-device ``SparseGLMObjective`` (tests/test_column_sharded.py's bounds).
The width d = 37 divides neither 2 nor 4: the last block has padding lanes.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from photon_ml_tpu.data.sparse_batch import HybridPolicy as JHybrid
from photon_ml_tpu.data.sparse_batch import SparseLabeledPointBatch as JSparseBatch
from photon_ml_tpu.data.sparse_batch import SparseShard as JShard
from photon_ml_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_ml_tpu.ops.sparse_objective import SparseGLMObjective as JSparseObjective
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOptConfig
from photon_ml_tpu.optim.optimizer import OptimizerType as JOptType
from photon_ml_tpu.optim.optimizer import solve as jsolve
from photon_ml_tpu.parallel import column_sharded as jcs
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch.data.sparse_batch import HybridPolicy, SparseShard
from photon_ml_torch.parallel import column_sharded as tcs
from tests import torch_mesh_worker as W

L2 = 0.4
WORLDS = (2, 4)


def _problem(seed=0, n=120, d=37, nnz=600, skew=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=nnz)
    cols = (np.minimum(rng.zipf(1.6, size=nnz) - 1, d - 1) if skew
            else rng.integers(0, d, size=nnz))
    return dict(rows=rows, cols=cols, vals=rng.normal(size=nnz), num_samples=n, feature_dim=d,
                y=(rng.random(n) < 0.5).astype(np.float64), o=rng.normal(scale=0.1, size=n),
                w=rng.uniform(0.5, 2.0, size=n), coef=rng.normal(scale=0.1, size=d),
                vec=rng.normal(size=d))


PROBLEM = _problem()
HYBRID = dict(coverage=0.5, pad_multiple=4)
SKEWED = _problem(seed=30, n=96, d=48, nnz=700, skew=True)


def _coo(p, hybrid=None):
    coo = {k: p[k] for k in ("rows", "cols", "vals", "num_samples", "feature_dim")}
    return dict(coo, hybrid=hybrid) if hybrid else coo


def _task(p, hybrid=None, solvers=("LBFGS", "TRON")):
    return dict(kind="column_objective", shard=_coo(p, hybrid), y=p["y"], o=p["o"], w=p["w"],
                coef=p["coef"], vec=p["vec"], l2=L2, task="LOGISTIC_REGRESSION",
                solvers=solvers)


def _build_runs(base) -> dict:
    out = {}
    for world in WORLDS:
        tasks = [dict(_task(PROBLEM), mesh=(1, world)),
                 dict(_task(SKEWED, HYBRID, solvers=()), mesh=(1, world))]
        spawn_dir = base / f"cols{world}"
        spawn_dir.mkdir(parents=True)
        flat, hybrid = W.spawn_ranks(world, tasks, spawn_dir)
        out[world] = {"flat": flat, "hybrid": hybrid}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> {"flat": per-rank results, "hybrid": ...} for 1xK meshes,
    built once a test run (``torch_mesh_worker.run_once``)."""
    return W.run_once("column_sharded", _build_runs, tmp_path_factory.mktemp("cols"))


def _jshard(p, hybrid=None):
    return JShard(rows=p["rows"], cols=p["cols"], vals=p["vals"], num_samples=p["num_samples"],
                  feature_dim=p["feature_dim"],
                  hybrid_policy=None if hybrid is None else JHybrid(**hybrid))


def _tshard(p, hybrid=None):
    return SparseShard(rows=p["rows"], cols=p["cols"], vals=p["vals"],
                       num_samples=p["num_samples"], feature_dim=p["feature_dim"],
                       hybrid_policy=None if hybrid is None else HybridPolicy(**hybrid))


def _whole(results, key):
    """The ranks' blocks of ``key`` concatenated in model-rank order."""
    return np.concatenate([r[key] for r in sorted(results, key=lambda r: r["columns"][0])])


def _jax_objective(world):
    mesh = make_mesh(data=1, model=world)
    p = PROBLEM
    cb = jcs.shard_column_batch(jcs.build_column_sharded_batch(
        _jshard(p), p["y"], world, offsets=p["o"], weights=p["w"]), mesh)
    obj = jcs.ColumnShardedGLMObjective(jloss_for_task(JTask.LOGISTIC_REGRESSION), mesh,
                                        l2_weight=L2)

    def put(x):
        padded = np.zeros(cb.padded_dim)
        padded[:p["feature_dim"]] = x
        return jax.device_put(jnp.asarray(padded), NamedSharding(mesh, P("model")))

    return obj, cb, put


def _jax_one_device(p, **kw):
    batch = JSparseBatch.from_shard(_jshard(p), jnp.asarray(p["y"]), jnp.asarray(p["o"]),
                                    jnp.asarray(p["w"]), **kw)
    return JSparseObjective(jloss_for_task(JTask.LOGISTIC_REGRESSION), l2_weight=L2), batch


FIELDS = ("values", "local_cols", "row_ids", "vals_by_col", "rows_by_col", "local_bounds")


@pytest.mark.parametrize("hybrid", [False, True], ids=["flat", "hybrid"])
@pytest.mark.parametrize("blocks", [2, 4])
def test_builder_matches_the_jax_package(blocks, hybrid):
    """build_column_sharded_batch: every [K, m] entry array, the run bounds,
    the per-sample vectors and the per-block hybrid head and hot ids equal
    the JAX package's, array for array."""
    p = SKEWED if hybrid else PROBLEM
    policy = HYBRID if hybrid else None
    j = jcs.build_column_sharded_batch(_jshard(p, policy), p["y"], blocks, offsets=p["o"],
                                       weights=p["w"])
    t = tcs.build_column_sharded_batch(_tshard(p, policy), p["y"], blocks, offsets=p["o"],
                                       weights=p["w"], device="cpu")
    assert (t.dim, t.block, t.num_blocks, t.padded_dim) == (j.dim, j.block, j.num_blocks,
                                                           j.padded_dim)
    for f in FIELDS + ("labels", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    assert t.has_hot_head == j.has_hot_head == hybrid
    if hybrid:
        np.testing.assert_array_equal(t.hot_vals.numpy(), np.asarray(j.hot_vals))
        np.testing.assert_array_equal(t.hot_local_cols.numpy(), np.asarray(j.hot_local_cols))


@pytest.mark.parametrize("blocks", [2, 4])
def test_one_block_build_is_that_block_of_the_whole_build(blocks):
    """``only_block=k`` (a rank's own build) holds block k of the whole
    build: its entries and pads up to its own count, the same run bounds
    and hot head."""
    p = SKEWED
    whole = tcs.build_column_sharded_batch(_tshard(p, HYBRID), p["y"], blocks, device="cpu")
    for k in range(blocks):
        one = tcs.build_column_sharded_batch(_tshard(p, HYBRID), p["y"], blocks, only_block=k,
                                             device="cpu")
        assert one.block_index == k and one.num_blocks == blocks
        m = one.values.shape[1]
        for f in FIELDS[:-1]:
            np.testing.assert_array_equal(getattr(one, f)[0].numpy(),
                                          getattr(whole, f)[k, :m].numpy(), f)
        np.testing.assert_array_equal(one.local_bounds[0].numpy(), whole.local_bounds[k].numpy())
        np.testing.assert_array_equal(one.hot_vals[0].numpy(), whole.hot_vals[k].numpy())


def test_a_clustered_hot_head_warns(caplog):
    """Hot ids clustered into one block pad every block to its width: the
    builder warns (the JAX package's warning)."""
    p = dict(PROBLEM, cols=np.where(PROBLEM["cols"] < 30, PROBLEM["cols"] % 3, PROBLEM["cols"]))
    with caplog.at_level(logging.WARNING, logger="photon_ml_torch.parallel.column_sharded"):
        tcs.build_column_sharded_batch(_tshard(p, HYBRID), p["y"], 4, device="cpu")
    assert "clustered across column blocks" in caplog.text


@pytest.mark.parametrize("world", WORLDS)
def test_value_and_gradient_match_the_jax_package(runs, world):
    """Value at rel 1e-12 and gradient at rel 1e-9 of the JAX column-sharded
    objective over 1xK and of its one-device sparse objective; each rank
    returns only its block; padding lanes see the L2 term alone."""
    got = runs[world]["flat"]
    d = PROBLEM["feature_dim"]
    obj, cb, put = _jax_objective(world)
    jv, jg = obj.value_and_gradient(put(PROBLEM["coef"]), cb)
    ref, batch = _jax_one_device(PROBLEM)
    rv, rg = ref.value_and_gradient(jnp.asarray(PROBLEM["coef"]), batch)
    for r in got:
        assert r["grad"].shape == (cb.block,)
        for v in (r["value"], r["value_only"]):
            assert v == pytest.approx(float(jv), rel=1e-12)
            assert v == pytest.approx(float(rv), rel=1e-12)
    g = _whole(got, "grad")
    np.testing.assert_allclose(g, np.asarray(jg), rtol=1e-9, atol=1e-15)
    np.testing.assert_allclose(g[:d], np.asarray(rg), rtol=1e-9, atol=1e-15)
    pad = _whole(got, "pad_grad")[d:]
    np.testing.assert_allclose(pad, L2 * _whole(got, "block_w_pad")[d:], rtol=1e-12)
    assert len(pad) == cb.padded_dim - d > 0


@pytest.mark.parametrize("world", WORLDS)
def test_hessian_vector_matches_the_jax_package(runs, world):
    """Hv at rel 1e-8 of the JAX column-sharded and one-device objectives."""
    d = PROBLEM["feature_dim"]
    obj, cb, put = _jax_objective(world)
    jhv = obj.hessian_vector(put(PROBLEM["coef"]), put(PROBLEM["vec"]), cb)
    ref, batch = _jax_one_device(PROBLEM)
    rhv = ref.hessian_vector(jnp.asarray(PROBLEM["coef"]), jnp.asarray(PROBLEM["vec"]), batch)
    hv = _whole(runs[world]["flat"], "hv")
    np.testing.assert_allclose(hv, np.asarray(jhv), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(hv[:d], np.asarray(rhv), rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", ["LBFGS", "TRON"])
def test_solvers_over_the_blocks_match_one_device(runs, world, kind):
    """L-BFGS and TRON over the rank blocks land within atol 2e-5 of the
    JAX package's one-device solve (its own bound); every rank's
    coefficients and L-BFGS history are d/K long, and every rank takes the
    same iterations with bitwise equal values."""
    d = PROBLEM["feature_dim"]
    got = runs[world]["flat"]
    ref, batch = _jax_one_device(PROBLEM)
    rr = jsolve(JOptConfig(optimizer_type=JOptType[kind], max_iterations=40), ref.bind(batch),
                jnp.zeros(d))
    coef = np.concatenate([r[kind]["coef"] for r in sorted(got, key=lambda r: r["columns"][0])])
    np.testing.assert_allclose(coef[:d], np.asarray(rr.coefficients), atol=2e-5)
    np.testing.assert_array_equal(coef[d:], 0.0)  # padding lanes stay 0
    block = got[0]["columns"][1] - got[0]["columns"][0]
    for r in got:
        assert r[kind]["coef"].shape == (block,)
        assert (r[kind]["iterations"], r[kind]["reason"]) == (got[0][kind]["iterations"],
                                                              got[0][kind]["reason"])
        np.testing.assert_array_equal(r[kind]["values"], got[0][kind]["values"])
        assert r["history_shapes"] == [((10, block), (10, block))]


def test_two_and_four_blocks_agree(runs):
    """The partition never changes the math: 2 and 4 blocks give the value
    at rel 1e-12 and the gradient at rel 1e-9."""
    d = PROBLEM["feature_dim"]
    two, four = runs[2]["flat"], runs[4]["flat"]
    assert two[0]["value"] == pytest.approx(four[0]["value"], rel=1e-12)
    np.testing.assert_allclose(_whole(two, "grad")[:d], _whole(four, "grad")[:d], rtol=1e-9,
                               atol=1e-15)


@pytest.mark.parametrize("world", WORLDS)
def test_a_batch_of_other_blocks_is_rejected(runs, world):
    """A batch of 2K column blocks on a model axis of K would drop entries:
    the objective raises the JAX package's "column blocks" ValueError."""
    for r in runs[world]["flat"]:
        assert f"batch has {2 * world} column blocks" in r["mismatch"]
        assert f"model' axis is {world}" in r["mismatch"]


@pytest.mark.parametrize("world", WORLDS)
def test_hybrid_blocks_match_one_device(runs, world):
    """With each block's dense hot head: value at rel 1e-10, gradient and Hv
    at rel 1e-9 of the JAX package's one-device flat objective (its
    test_sparse_hybrid bounds)."""
    p = SKEWED
    d = p["feature_dim"]
    got = runs[world]["hybrid"]
    assert all(r["has_hot_head"] for r in got)
    ref, batch = _jax_one_device(p, ell=False, hybrid=False)
    rv, rg = ref.value_and_gradient(jnp.asarray(p["coef"]), batch)
    rhv = ref.hessian_vector(jnp.asarray(p["coef"]), jnp.asarray(p["vec"]), batch)
    for r in got:
        assert r["value"] == pytest.approx(float(rv), rel=1e-10)
    np.testing.assert_allclose(_whole(got, "grad")[:d], np.asarray(rg), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_whole(got, "hv")[:d], np.asarray(rhv), rtol=1e-9, atol=1e-12)
