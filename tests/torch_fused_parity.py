"""Shared cases of the fused-program parity tests: one numpy fixture, made
from a seed, builds the JAX package's GameTrainProgram inputs and the
port's, both on the CPU in float64; each case trains through both
packages' ``train_distributed``. Where MF is present both start from the
JAX package's initial state, carried across by
``photon_ml_torch.convert.train_state_from_numpy``."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from photon_ml_tpu.algorithm import mf_coordinate as jmfc
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.data import sparse_batch as jsb
from photon_ml_tpu.evaluation import evaluators as jev
from photon_ml_tpu.parallel import distributed as jdist
from photon_ml_tpu.projector.projectors import ProjectorType as JProj
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch.algorithm import mf_coordinate as tmfc
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.data import sparse_batch as tsb
from photon_ml_torch.evaluation import evaluators as tev
from photon_ml_torch.parallel import distributed as tdist
from photon_ml_torch.projector.projectors import ProjectorType as TProj
from photon_ml_torch.types import TaskType as TTask
from tests.torch_game_parity import game_arrays, optimizer_pair
from tests.torch_parity import normalizations


def dryrun_arrays(n_devices: int = 8) -> dict:
    """``__graft_entry__._dryrun_impl``'s fixture (its first program's
    data), drawn exactly as there for an ``n_devices`` mesh."""
    model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    data = n_devices // model
    rng = np.random.default_rng(0)
    n = 16 * data
    d_fe = 8 * model
    users = np.array([f"u{i}" for i in rng.integers(0, 2 * data, size=n)])
    items = np.array([f"i{i}" for i in rng.integers(0, 2 * data, size=n)])
    x_fe = rng.normal(size=(n, d_fe)).astype(np.float32)
    x_re = rng.normal(size=(n, 4)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return dict(labels=y, xg=x_fe, xr=x_re, users=users, items=items, bucket=16 * data)


def sparse_shards(x: np.ndarray, rng, drop: float = 0.5):
    """(JAX SparseShard, port SparseShard) of ``x`` with a share of its
    entries zeroed."""
    x = x.copy()
    x[rng.uniform(size=x.shape) < drop] = 0.0
    rows, cols = np.nonzero(x)
    kw = dict(rows=rows, cols=cols, vals=x[rows, cols], num_samples=x.shape[0],
              feature_dim=x.shape[1])
    return jsb.SparseShard(**kw), tsb.SparseShard(**kw)


@dataclasses.dataclass
class Case:
    """One configuration of both programs and their inputs."""

    jds: object
    tds: object
    jprog: object
    tprog: object
    jre: dict
    tre: dict
    jmf: dict
    tmf: dict
    jval: object = None
    tval: object = None
    train_kw: dict = dataclasses.field(default_factory=dict)
    rel: float = 1e-8
    sweeps: int = 3


def _opt(kind: str, iters: int, **kw):
    return optimizer_pair(kind, iters, **kw)


def build_case(name: str) -> Case:
    lbfgs_j, lbfgs_t = _opt("LBFGS", 10)
    if name == "dryrun":
        a = dryrun_arrays()
        opt_j, opt_t = _opt("LBFGS", 3)
        shards = {"global": a["xg"], "per_entity": a["xr"]}
        kw = dict(labels=a["labels"], feature_shards=shards,
                  entity_keys={"user": a["users"], "item": a["items"]}, dtype=np.float64)
        jds, tds = jgd.build_game_dataset(**kw), tgd.build_game_dataset(**kw, device="cpu")
        b = (a["bucket"],)
        jre = {t: jgd.build_random_effect_dataset(jds, t, "per_entity", bucket_sizes=b)
               for t in ("user", "item")}
        tre = {t: tgd.build_random_effect_dataset(tds, t, "per_entity", bucket_sizes=b)
               for t in ("user", "item")}
        jmf = {"user-item-mf": jmfc.build_mf_dataset(jds, "user", "item", bucket_sizes=b)}
        tmf = {"user-item-mf": tmfc.build_mf_dataset(tds, "user", "item", bucket_sizes=b)}
        progs = []
        for dist, opt, task in ((jdist, opt_j, JTask), (tdist, opt_t, TTask)):
            progs.append(dist.GameTrainProgram(
                task.LOGISTIC_REGRESSION,
                dist.FixedEffectStepSpec(feature_shard_id="global", optimizer=opt, l2_weight=1.0),
                (dist.RandomEffectStepSpec("user", "per_entity", opt, l2_weight=1.0),
                 dist.RandomEffectStepSpec("item", "per_entity", opt, l2_weight=1.0)),
                mf_specs=(dist.MatrixFactorizationStepSpec(
                    "user-item-mf", "user", "item", num_latent_factors=2, optimizer=opt,
                    l2_weight=1.0),)))
        return Case(jds, tds, *progs, jre, tre, jmf, tmf)

    held = 200 if name == "validation" else 0
    task = "LINEAR_REGRESSION" if name in ("tron_lanes", "extra_fe") else "LOGISTIC_REGRESSION"
    arrays = game_arrays(11, n=500, d_fe=6, d_re=3, n_users=18, n_items=6, task=task,
                         held_out=held)
    a, v = arrays if held else (arrays, None)
    rng = np.random.default_rng(5)
    shards_j = {"global": a["xg"], "per_entity": a["xr"]}
    shards_t = dict(shards_j)
    if name in ("sparse_fe_indexmap", "compact_re"):
        wide = np.concatenate([a["xg"], rng.normal(size=(len(a["labels"]), 10))], axis=1)
        js, ts = sparse_shards(wide, rng)
        shards_j["global"], shards_t["global"] = js, ts
        if name == "compact_re":
            shards_j["per_entity"], shards_t["per_entity"] = js, ts
    if name == "sparse_fe_indexmap":
        xr = a["xr"].copy()
        xr[rng.uniform(size=xr.shape) < 0.4] = 0.0
        shards_j["per_entity"] = shards_t["per_entity"] = xr
    if name == "extra_fe":
        shards_j["extra"] = shards_t["extra"] = rng.normal(size=(len(a["labels"]), 4))
    common = dict(labels=a["labels"], entity_keys={"user": a["users"], "item": a["items"]},
                  offsets=a["offsets"], weights=a["weights"], unique_ids=a["unique_ids"],
                  dtype=np.float64)
    jds = jgd.build_game_dataset(feature_shards=shards_j, **common)
    tds = tgd.build_game_dataset(feature_shards=shards_t, **common, device="cpu")
    jval = tval = None
    if v is not None:
        vkw = dict(labels=v["labels"], feature_shards={"global": v["xg"], "per_entity": v["xr"]},
                   entity_keys={"user": v["users"], "item": v["items"]}, offsets=v["offsets"],
                   weights=v["weights"], unique_ids=v["unique_ids"], dtype=np.float64)
        jval = jgd.build_game_dataset(**vkw, entity_vocabs=jds.entity_vocabs)
        tval = tgd.build_game_dataset(**vkw, entity_vocabs=tds.entity_vocabs, device="cpu")

    re_types = ("user",) if name in ("sparse_fe_indexmap", "compact_re", "random_re") \
        else ("user", "item")
    lanes = {"newton_lanes": "NEWTON", "owlqn_lanes": "OWLQN", "tron_lanes": "TRON"}.get(
        name, "LBFGS")
    lane_kw = {"OWLQN": dict(l1_weight=0.05), "TRON": dict(tolerance=1e-5)}.get(lanes, {})
    re_j, re_t = _opt(lanes, 10, **lane_kw)
    proj = {"sparse_fe_indexmap": "INDEX_MAP", "random_re": "RANDOM",
            "compact_re": "INDEX_MAP"}.get(name, "IDENTITY")
    norm_kind = "STANDARDIZATION" if name == "standardized_re" else None
    rel = 1e-5 if lanes == "TRON" else 1e-8

    def re_builds(gd, ds, proj_enum):
        kw = dict(bucket_sizes=(8, 32, 128))
        if proj != "IDENTITY":
            kw["projector_type"] = proj_enum[proj]
        if proj == "RANDOM":
            kw["projected_dim"] = 2
        return {t: gd.build_random_effect_dataset(ds, t, "per_entity", **kw) for t in re_types}

    jre, tre = re_builds(jgd, jds, JProj), re_builds(tgd, tds, TProj)
    jmf, tmf = {}, {}
    with_mf = name in ("permuted_order", "newton_lanes", "validation", "down_sampling")
    if with_mf:
        jmf = {"mf": jmfc.build_mf_dataset(jds, "user", "item", bucket_sizes=(8, 32, 128))}
        tmf = {"mf": tmfc.build_mf_dataset(tds, "user", "item", bucket_sizes=(8, 32, 128))}
    norms = {}
    if norm_kind:
        norms = {
            "fe": normalizations(norm_kind, a["xg"], intercept_index=5),
            "re": normalizations(norm_kind, a["xr"], intercept_index=2),
        }
    progs = []
    for side, (dist, task_t, proj_t, fe_opt, re_opt) in enumerate(
            ((jdist, JTask, JProj, lbfgs_j, re_j), (tdist, TTask, TProj, lbfgs_t, re_t))):
        rate = 0.5 if name == "down_sampling" else 1.0
        fe = dist.FixedEffectStepSpec("global", fe_opt, l2_weight=0.5, down_sampling_rate=rate)
        res = tuple(dist.RandomEffectStepSpec(
            t, "per_entity", re_opt, l2_weight=1.0, projector=proj_t[proj],
            intercept_index=2 if norm_kind else None) for t in re_types)
        mfs = ()
        if with_mf:
            mf_opt = _opt("NEWTON" if lanes == "NEWTON" else "LBFGS", 10)[side]
            mfs = (dist.MatrixFactorizationStepSpec("mf", "user", "item", num_latent_factors=2,
                                                    optimizer=mf_opt, l2_weight=2.0,
                                                    num_alternations=2),)
        kw = {}
        if name == "extra_fe":
            kw["extra_fes"] = (dist.FixedEffectStepSpec("extra", fe_opt, l2_weight=0.3),)
        if name == "permuted_order":
            kw["update_order"] = ("mf", "user", "global", "item")
        if norm_kind:
            kw["normalization"] = norms["fe"][side]
            kw["re_normalizations"] = {"user": norms["re"][side], "item": norms["re"][side]}
        progs.append(dist.GameTrainProgram(task_t[task], fe, res, mf_specs=mfs, **kw))
    case = Case(jds, tds, *progs, jre, tre, jmf, tmf, jval=jval, tval=tval, rel=rel)
    if name == "down_sampling":
        case.train_kw = {"down_sampling_seed": 3}
    return case


CASES = ("dryrun", "permuted_order", "newton_lanes", "owlqn_lanes", "tron_lanes",
         "sparse_fe_indexmap", "random_re", "compact_re", "standardized_re", "extra_fe",
         "down_sampling", "validation")


def _validation_kw(case: Case, side: int) -> dict:
    if case.jval is None:
        return {}
    ev = (jev, tev)[side]
    ds = (case.jval, case.tval)[side]
    host = (lambda k: np.asarray(getattr(ds, k))) if side == 0 else ds.host_array
    data = ev.EvaluationData(labels=host("labels"), offsets=host("offsets"),
                             weights=host("weights"))
    return dict(validation_dataset=ds, validation_evaluators=(ev.parse_evaluator("AUC"),
                                                              ev.parse_evaluator("RMSE")),
                validation_eval_data=data)


@functools.lru_cache(maxsize=None)
def run(name: str):
    """(case, JAX result, port result) of one case, trained once a session."""
    case = build_case(name)
    jstate = case.jprog.init_state(case.jds, case.jre, case.jmf or None)
    tstate = convert.train_state_from_numpy(jstate, device="cpu")
    jres = jdist.train_distributed(case.jprog, case.jds, case.jre, mf_datasets=case.jmf or None,
                                   num_iterations=case.sweeps, state=jstate,
                                   **case.train_kw, **_validation_kw(case, 0))
    tres = tdist.train_distributed(case.tprog, case.tds, case.tre, mf_datasets=case.tmf or None,
                                   num_iterations=case.sweeps, state=tstate,
                                   **case.train_kw, **_validation_kw(case, 1))
    return case, jres, tres


def assert_states_close(jstate, tstate, rel: float) -> None:
    """Every tensor of the two states agrees within ``rel`` of its largest
    magnitude; the same groups and names on both sides."""
    ref = convert.train_state_to_numpy(convert.train_state_from_numpy(jstate, device="cpu"))
    got = convert.train_state_to_numpy(tstate)
    assert set(ref) == set(got)
    np.testing.assert_allclose(got["fe_coefficients"], ref["fe_coefficients"], rtol=rel,
                               atol=rel * np.abs(ref["fe_coefficients"]).max())
    for group in ("re_tables", "mf_rows", "mf_cols", "extra_fe"):
        assert sorted(got[group]) == sorted(ref[group]), group
        for k, r in ref[group].items():
            scale = np.nanmax(np.abs(r)) if r.size else 1.0
            np.testing.assert_allclose(got[group][k], r, rtol=rel, atol=rel * scale,
                                       err_msg=f"{group}/{k}")
