"""What the fused program refuses, held against the JAX package on the CPU:
every ValueError of its input preparation (``_data_pytree``,
``_buckets_pytree``, the compact entry mappings) and of
``GameTrainProgram.__init__`` with the JAX message's key words; a foreign
checkpoint refused before any data is touched, and a scheduled spec (the
lane scheduler, ported) going on to the data;
``DivergenceError`` on a non-finite loss; AUTO resolution; and the
observers of ``train_distributed`` (``on_sweep``, the training evaluator)."""

import dataclasses

import numpy as np
import pytest

from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.io.checkpoint import DivergenceError as JDivergence
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.projector.projectors import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch.algorithm.coordinate_descent import DivergenceError as TDivergence
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.optim.optimizer import LaneSchedulerConfig as TLaneSched
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.projector.projectors import ProjectorType as TProj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_fused_parity import sparse_shards
from tests.torch_game_parity import game_arrays, optimizer_pair
from tests.torch_parity import normalizations

pytest_plugins = ("tests.torch_jax_maps",)  # keeps a worker's memory maps in bounds

SIDES = {"jax": (jdist, jgd, JTask, JProj, 0), "torch": (tdist, tgd, TTask, TProj, 1)}


@pytest.fixture(scope="module")
def small():
    a = game_arrays(21, n=120, d_fe=4, d_re=3, n_users=6, n_items=4)
    rng = np.random.default_rng(2)
    shards = sparse_shards(rng.normal(size=(120, 9)), rng)
    out = {}
    for side, (dist, gd, *_rest) in SIDES.items():
        kw = dict(labels=a["labels"], entity_keys={"user": a["users"], "item": a["items"]},
                  offsets=a["offsets"], weights=a["weights"], unique_ids=a["unique_ids"],
                  feature_shards={"global": a["xg"], "per_entity": a["xr"],
                                  "wide": shards[SIDES[side][4]]}, dtype=np.float64)
        out[side] = gd.build_game_dataset(**kw) if side == "jax" else \
            gd.build_game_dataset(**kw, device="cpu")
    out["arrays"] = a
    return out


def _specs(side, *, re=("user",), projector="IDENTITY", intercept=None, kind="LBFGS"):
    dist, _, _, proj, i = SIDES[side]
    opt = optimizer_pair(kind, 3)[i]
    fe = dist.FixedEffectStepSpec("global", opt, l2_weight=1.0)
    res = tuple(dist.RandomEffectStepSpec(t, "per_entity", opt, l2_weight=1.0,
                                          projector=proj[projector], intercept_index=intercept)
                for t in re)
    return fe, res, opt


def _program(side, **kw):
    dist, _, task, *_ = SIDES[side]
    fe, res, opt = _specs(side)
    args = dict(re_specs=res)
    args.update(kw)
    return dist.GameTrainProgram(task.LOGISTIC_REGRESSION, fe, **args)


def _init_errors(side, arrays):
    dist, _, task, _, i = SIDES[side]
    fe, res, opt = _specs(side)
    norms = normalizations("STANDARDIZATION", arrays["xr"], intercept_index=2)
    mf = dist.MatrixFactorizationStepSpec("user", "user", "item", 2, opt)
    return {
        "unique": (lambda: _program(side, mf_specs=(mf,)), "must be unique"),
        "permutation": (lambda: _program(side, update_order=("user",)),
                        "must be a permutation"),
        "reserved": (lambda: dist.GameTrainProgram(
            task.LOGISTIC_REGRESSION, fe, (dataclasses.replace(res[0], re_type="__mf__"),)),
            "reserved"),
        "extra-fe-intercept": (lambda: _program(
            side, extra_fes=(dist.FixedEffectStepSpec("per_entity", opt),),
            extra_fe_normalizations={"per_entity": norms[i]}), "requires the spec's intercept"),
        "re-intercept": (lambda: _program(side, re_normalizations={"user": norms[i]}),
                         "requires the spec's intercept_index"),
    }


@pytest.mark.parametrize("error", ["unique", "permutation", "reserved", "extra-fe-intercept",
                                   "re-intercept"])
def test_program_init_errors_match(small, error):
    for side in SIDES:
        build, words = _init_errors(side, small["arrays"])[error]
        with pytest.raises(ValueError, match=words):
            build()


def _input_errors(side, small):
    """name -> (callable raising, key words) over the prepared inputs."""
    dist, gd, task, proj, i = SIDES[side]
    ds = small[side]
    fe, res, opt = _specs(side)
    norms = normalizations("SCALE_WITH_STANDARD_DEVIATION", small["arrays"]["xr"],
                           intercept_index=None)
    ident = {"user": gd.build_random_effect_dataset(ds, "user", "per_entity")}
    index = {"user": gd.build_random_effect_dataset(ds, "user", "per_entity",
                                                    projector_type=proj.INDEX_MAP)}
    pre = {"user": gd.build_random_effect_dataset(ds, "user", "per_entity",
                                                  projector_type=proj.INDEX_MAP,
                                                  normalization=norms[i])}
    compact = {"user": gd.build_random_effect_dataset(ds, "user", "wide")}

    def index_program(**kw):
        return _program(side, re_specs=_specs(side, projector="INDEX_MAP")[1], **kw)

    wide_re = (dataclasses.replace(res[0], feature_shard_id="wide",
                                   projector=proj.INDEX_MAP),)
    wide = _program(side, re_specs=wide_re)
    return {
        "sparse-not-primary": (lambda: _program(
            side, extra_fes=(dist.FixedEffectStepSpec("wide", opt),)).prepare_inputs(ds, ident),
            "is sparse"),
        "not-pre-normalized": (lambda: index_program(re_normalizations={"user": norms[i]})
                               .prepare_inputs(ds, index), "built with the same normalization"),
        "pre-normalized-without-context": (lambda: index_program().prepare_inputs(ds, pre),
                                           "was built pre-normalized"),
        "projector-mismatch": (lambda: _program(side).prepare_inputs(ds, index), "uses projector"),
        "compact-needs-datasets": (lambda: wide.prepare_scoring_inputs(ds),
                                   "is required to prepare inputs"),
        "variances-need-datasets": (lambda: dist.compute_state_variances(
            _program(side), _program(side).init_state(ds, ident), ds, None), "missing"),
        "model-needs-compact-datasets": (lambda: dist.state_to_game_model(
            wide, wide.init_state(ds, compact), ds), "pass its RandomEffectDataset"),
        "no-shared-keys": (lambda: dist.game_model_to_state(
            _program(side), _renamed_model(side, ds, ident), ds), "shares no entity keys"),
        "variance-mode": (lambda: dist.compute_state_variances(
            _program(side), _program(side).init_state(ds, ident), ds, ident,
            variance_mode="exact"), "variance mode must be one of"),
    }


def _renamed_model(side, ds, ident):
    """The program's initial model with every user key renamed."""
    prog = _program(side)
    model = SIDES[side][0].state_to_game_model(prog, prog.init_state(ds, ident), ds)
    user = model.get("user")
    renamed = dataclasses.replace(user, entity_keys=np.char.add("x", np.asarray(
        user.entity_keys).astype(str)))
    return model.updated("user", renamed)


INPUT_ERRORS = ["sparse-not-primary", "not-pre-normalized", "pre-normalized-without-context",
                "projector-mismatch", "compact-needs-datasets", "variances-need-datasets",
                "model-needs-compact-datasets", "no-shared-keys", "variance-mode"]


@pytest.mark.parametrize("error", INPUT_ERRORS)
def test_input_errors_match(small, error):
    for side in SIDES:
        raise_it, words = _input_errors(side, small)[error]
        with pytest.raises(ValueError, match=words):
            raise_it()


class _Untouchable:
    """A dataset that fails any use: a refusal must come before the data."""

    def __getattr__(self, name):
        raise AssertionError(f"the dataset was used ({name}) before the refusal")


class _ModelAxisMesh:
    """A ("data", "model") mesh shape with a model axis of 2 (no group: the
    checks below come before any collective)."""

    mesh_dim_names = ("data", "model")

    def size(self, dim=None):
        return 2

    def get_local_rank(self, name):
        return 0


# a model-axis mesh the program was not built for, fe_feature_sharded that
# the program was not built with, put_fn without a mesh, and a checkpoint
# that is not the fused program's (checkpoints are ported, item 16) are
# usage errors; a scheduled spec (item 18, ported) is no longer refused: it
# reads the data
REFUSALS = [({"mesh": _ModelAxisMesh()}, "the same mesh"),
            ({"mesh": _ModelAxisMesh(), "fe_feature_sharded": True}, "the same mesh and flag"),
            ({"put_fn": lambda a, s: a}, "put_fn"),
            ("checkpointer", "not a distributed-training checkpoint"), ("scheduler", "item 18")]


@pytest.mark.parametrize("option,item", REFUSALS,
                         ids=["mesh", "fe_feature_sharded", "put_fn", "checkpointer",
                              "scheduler"])
def test_refusals_come_before_any_data(option, item, tmp_path):
    opt = optimizer_pair("LBFGS", 3)[1]
    kw = {}
    if option == "scheduler":
        opt = dataclasses.replace(opt, scheduler=TLaneSched())
    elif option == "checkpointer":
        from photon_ml_torch.io.checkpoint import TrainingCheckpointer

        kw = {"checkpointer": TrainingCheckpointer(tmp_path)}
        kw["checkpointer"].save(1, {"model/fixed/means": np.zeros(2)}, {})
    else:
        kw = option
    prog = tdist.GameTrainProgram(
        TTask.LOGISTIC_REGRESSION, tdist.FixedEffectStepSpec("global", opt),
        (tdist.RandomEffectStepSpec("user", "per_entity", opt),))
    if not item.startswith("item"):
        with pytest.raises(ValueError, match=item):
            tdist.train_distributed(prog, _Untouchable(), _Untouchable(), **kw)
        return
    with pytest.raises(AssertionError, match="the dataset was used"):
        tdist.train_distributed(prog, _Untouchable(), _Untouchable(), **kw)


@pytest.mark.parametrize("option,model_axis", [
    ({"mesh": _ModelAxisMesh()}, False), ({"fe_feature_sharded": True}, False),
    ({"mesh": _ModelAxisMesh(), "fe_feature_sharded": True}, True)])
def test_program_over_a_model_axis_mesh_builds(option, model_axis):
    """A program over a mesh with a model axis builds; it lays the fixed
    effect over that axis only with fe_feature_sharded (without a mesh the
    flag leaves one column block)."""
    opt = optimizer_pair("LBFGS", 3)[1]
    prog = tdist.GameTrainProgram(TTask.LOGISTIC_REGRESSION,
                                  tdist.FixedEffectStepSpec("global", opt), **option)
    assert prog._model_axis is model_axis
    assert prog.fe_feature_sharded is bool(option.get("fe_feature_sharded"))


def test_non_finite_loss_raises_divergence(small):
    """A non-finite training loss raises each package's DivergenceError at
    that sweep, before any observer runs."""
    a = dict(small["arrays"])
    a["offsets"] = a["offsets"].copy()
    a["offsets"][3] = np.inf
    seen = []
    for side, (dist, gd, _, _, _) in SIDES.items():
        kw = dict(labels=a["labels"], entity_keys={"user": a["users"]}, offsets=a["offsets"],
                  feature_shards={"global": a["xg"], "per_entity": a["xr"]}, dtype=np.float64)
        ds = gd.build_game_dataset(**kw) if side == "jax" else \
            gd.build_game_dataset(**kw, device="cpu")
        prog = _program(side)
        re_ds = {"user": gd.build_random_effect_dataset(ds, "user", "per_entity")}
        with pytest.raises(JDivergence if side == "jax" else TDivergence,
                           match="non-finite loss .* at sweep 0"):
            dist.train_distributed(prog, ds, re_ds, num_iterations=2,
                                   on_sweep=lambda *s: seen.append(s))
        out = dist.train_distributed(prog, ds, re_ds, num_iterations=1, check_finite=False)
        assert not np.isfinite(out.losses[0])
    assert seen == []


def test_auto_resolution_matches(small):
    """AUTO resolves once at program build: LBFGS on the fixed effects,
    NEWTON on the random effects and MF (a twice-differentiable loss)."""
    types = {}
    for side, (dist, _, task, _, i) in SIDES.items():
        auto = optimizer_pair("AUTO", 5)[i]
        prog = dist.GameTrainProgram(
            task.LOGISTIC_REGRESSION, dist.FixedEffectStepSpec("global", auto),
            (dist.RandomEffectStepSpec("user", "per_entity", auto),),
            mf_specs=(dist.MatrixFactorizationStepSpec("mf", "user", "item", 2, auto),),
            extra_fes=(dist.FixedEffectStepSpec("per_entity", auto),))
        types[side] = [s.optimizer.optimizer_type.name
                       for s in (prog.fe, *prog.extra_fes, *prog.re_specs, *prog.mf_specs)]
    assert types["torch"] == types["jax"] == ["LBFGS", "LBFGS", "NEWTON", "NEWTON"]


def test_observers_and_training_metric_match(small):
    """on_sweep sees (sweeps done, total, loss) after every sweep, and the
    per-sweep ``train:<name>`` metric equals the JAX package's."""
    rows = {}
    calls = {}
    for side, (dist, gd, _, _, i) in SIDES.items():
        ds = small[side]
        host = (lambda k: np.asarray(getattr(ds, k))) if side == "jax" else ds.host_array
        ev = (jev, tev)[i]
        data = ev.EvaluationData(labels=host("labels"), offsets=host("offsets"),
                                 weights=host("weights"))
        prog = _program(side)
        re_ds = {"user": gd.build_random_effect_dataset(ds, "user", "per_entity")}
        calls[side] = []
        out = dist.train_distributed(
            prog, ds, re_ds, num_iterations=2, training_evaluator=ev.parse_evaluator("AUC"),
            training_eval_data=data, on_sweep=lambda *s, c=calls[side]: c.append(s))
        rows[side] = out.metric_history
        assert [c[:2] for c in calls[side]] == [(1, 2), (2, 2)]
        assert [c[2] for c in calls[side]] == out.losses
    assert [r["coordinate"] for r in rows["torch"]] == ["fused_sweep"] * 2
    for rj, rt in zip(rows["jax"], rows["torch"]):
        assert rt.keys() == rj.keys()
        assert rt["train:AUC"] == pytest.approx(rj["train:AUC"], rel=1e-10)
