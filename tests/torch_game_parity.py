"""Shared fixtures of the GAME parity tests: one numpy fixture, made from a
seed, builds the JAX package's dataset, estimator and models and the port's
(through the port's own builders or ``photon_ml_torch.convert``), all on the
CPU in float64."""

from __future__ import annotations

import numpy as np

from photon_ml_tpu import estimators as jest
from photon_ml_tpu.algorithm import coordinates as jcoord
from photon_ml_tpu.data import game_data as jgd
from photon_ml_tpu.models import game as jgame
from photon_ml_tpu.models import matrix_factorization as jmf
from photon_ml_tpu.ops.normalization import NormalizationType as JNormType
from photon_ml_tpu.optim.optimizer import OptimizerConfig as JOptConfig
from photon_ml_tpu.optim.optimizer import OptimizerType as JOptType
from photon_ml_tpu.types import TaskType as JTask
from photon_ml_torch import convert
from photon_ml_torch import estimators as test_
from photon_ml_torch.algorithm import coordinates as tcoord
from photon_ml_torch.data import game_data as tgd
from photon_ml_torch.ops.normalization import NormalizationType as TNormType
from photon_ml_torch.optim.optimizer import OptimizerConfig as TOptConfig
from photon_ml_torch.optim.optimizer import OptimizerType as TOptType
from photon_ml_torch.types import TaskType as TTask


def game_arrays(seed: int = 0, *, n: int = 700, d_fe: int = 6, d_re: int = 3, n_users: int = 24,
                n_items: int = 7, task: str = "LOGISTIC_REGRESSION", held_out: int = 0):
    """Numpy GAME data with planted fixed, per-user and per-item effects:
    skewed user counts (several buckets, a user above the largest bucket's
    cap and users with one or two samples), an intercept last in both
    shards, offsets, weights with zeros, a query id column. With
    ``held_out`` > 0 the last rows are split off, some of unseen users."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    p = rng.dirichlet(np.full(n_users, 0.35))
    users = rng.choice(n_users, size=total, p=p)
    users[:150] = 0  # one large entity: a reservoir cap below 150 samples it
    items = rng.integers(0, n_items, size=total)
    if held_out:
        users[n + held_out // 2:] += n_users  # unseen at training time
    xg = rng.normal(size=(total, d_fe)) * rng.uniform(0.5, 2.0, size=d_fe) + rng.normal(size=d_fe)
    xr = rng.normal(size=(total, d_re))
    xg[:, -1] = 1.0
    xr[:, -1] = 1.0
    w_g = rng.normal(size=d_fe) / np.sqrt(d_fe)
    w_u = 0.7 * rng.normal(size=(2 * n_users, d_re))
    w_i = 0.5 * rng.normal(size=(n_items, d_re))
    z = (xg - xg.mean(0)) @ w_g + np.einsum("nd,nd->n", xr, w_u[users]) \
        + np.einsum("nd,nd->n", xr, w_i[items])
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    elif task == "POISSON_REGRESSION":
        y = rng.poisson(np.exp(np.clip(0.3 * z, -3, 2))).astype(np.float64)
    else:
        y = z + 0.1 * rng.normal(size=total)
    offsets = 0.05 * rng.normal(size=total)
    weights = rng.uniform(0.5, 1.5, size=total)
    weights[::11] = 0.0
    arrays = dict(labels=y, xg=xg, xr=xr, users=np.array([f"u{u}" for u in users]),
                  items=np.array([f"i{i}" for i in items]), offsets=offsets, weights=weights,
                  query=rng.integers(0, 9, size=total),
                  unique_ids=rng.permutation(total).astype(np.int64) + 1000)
    if not held_out:
        return arrays
    return ({k: v[:n] for k, v in arrays.items()}, {k: v[n:] for k, v in arrays.items()})


def projected_arrays(seed: int = 0, *, n: int = 600, d_fe: int = 5, d_re: int = 12,
                     n_users: int = 20, n_items: int = 6, task: str = "LOGISTIC_REGRESSION",
                     held_out: int = 0):
    """:func:`game_arrays`' layout with a wide per-entity shard in which each
    user owns a few columns: column 0 a constant-1 intercept, each user 2-5
    of columns 1..d_re-1 with N(0, 1) values there and zeros elsewhere;
    skewed user counts (several buckets, two users with two samples each);
    labels from a planted fixed effect plus a per-user model over its
    columns. The per-item effect reads the same shard. With ``held_out`` > 0
    the last rows are split off, half of them of unseen users."""
    rng = np.random.default_rng(seed)
    total = n + held_out
    users = rng.choice(n_users, size=total, p=rng.dirichlet(np.full(n_users, 0.5)))
    users[:2], users[2:4] = n_users, n_users + 1  # two 2-sample users
    users[4:n][np.isin(users[4:n], (n_users, n_users + 1))] = 0
    n_all = n_users + 2
    items = rng.integers(0, n_items, size=total)
    support = np.zeros((n_all, d_re), dtype=bool)
    support[:, 0] = True
    for u in range(n_all):
        support[u, 1 + rng.choice(d_re - 1, size=rng.integers(2, 6), replace=False)] = True
    xr = rng.normal(size=(total, d_re)) * support[users]
    xr[:, 0] = 1.0
    xg = rng.normal(size=(total, d_fe))
    xg[:, -1] = 1.0
    w_g = rng.normal(size=d_fe) / np.sqrt(d_fe)
    w_u = rng.normal(size=(n_all, d_re)) * support
    z = xg @ w_g + np.einsum("nd,nd->n", xr, w_u[users])
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=total) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = z + 0.1 * rng.normal(size=total)
    weights = rng.uniform(0.5, 1.5, size=total)
    keys = users.copy()
    if held_out:
        keys[n + held_out // 2:] += n_all  # unseen at training time
    arrays = dict(labels=y, xg=xg, xr=xr, users=np.array([f"u{u}" for u in keys]),
                  items=np.array([f"i{i}" for i in items]), offsets=0.05 * rng.normal(size=total),
                  weights=weights, query=rng.integers(0, 9, size=total),
                  unique_ids=rng.permutation(total).astype(np.int64) + 1000)
    if not held_out:
        return arrays
    return ({k: v[:n] for k, v in arrays.items()}, {k: v[n:] for k, v in arrays.items()})


def datasets(a, vocabs=None, dtype=np.float64):
    """(JAX GameDataset, port GameDataset on the CPU) of one array dict."""
    kw = dict(labels=a["labels"], feature_shards={"global": a["xg"], "per_entity": a["xr"]},
              entity_keys={"user": a["users"], "item": a["items"]}, offsets=a["offsets"],
              weights=a["weights"], unique_ids=a["unique_ids"], ids={"queryId": a["query"]},
              entity_vocabs=vocabs, dtype=dtype)
    return jgd.build_game_dataset(**kw), tgd.build_game_dataset(**kw, device="cpu")


def optimizer_pair(kind: str, max_iterations: int = 10, **kw):
    return (JOptConfig(optimizer_type=JOptType[kind], max_iterations=max_iterations, **kw),
            TOptConfig(optimizer_type=TOptType[kind], max_iterations=max_iterations, **kw))


def estimator_pair(task: str = "LOGISTIC_REGRESSION", *, lanes: str = "LBFGS",
                   normalization: str = "NONE", down_sampling_rate: float = 1.0,
                   num_iterations: int = 3, compute_variance: bool = False,
                   validation_evaluators=(), lower_bound=None, upper_bound=None,
                   fe_iterations: int = 30, lane_iterations: int = 10, **extra):
    """The same GAME configuration as a JAX estimator (kernel off: f64 parity)
    and a port estimator: a fixed effect on "global", per-user and per-item
    random effects on "per_entity"."""
    port_only = {k: extra.pop(k) for k in ("on_update",) if k in extra}
    jfe, tfe = optimizer_pair("LBFGS", fe_iterations)
    jre, tre = optimizer_pair(lanes, lane_iterations)

    def configs(mod_est, mod_coord, fe_opt, re_opt):
        def opt(o, l2, rate=1.0):
            return mod_coord.CoordinateOptimizationConfig(
                optimizer=o, l2_weight=l2, compute_variance=compute_variance,
                down_sampling_rate=rate)

        def re(t):
            kw = dict(active_data_lower_bound=lower_bound, active_data_upper_bound=upper_bound)
            return mod_est.RandomEffectCoordinateConfig(t, "per_entity", opt(re_opt, 1.0), **kw)

        return {"fixed": mod_est.FixedEffectCoordinateConfig("global",
                                                             opt(fe_opt, 0.5, down_sampling_rate)),
                "per_user": re("user"), "per_item": re("item")}

    common = dict(num_iterations=num_iterations,
                  validation_evaluators=tuple(validation_evaluators),
                  intercept_indices={"global": -1 % 6, "per_entity": 2}, **extra)
    je = jest.GameEstimator(task=JTask[task], coordinate_configs=configs(jest, jcoord, jfe, jre),
                            normalization=JNormType[normalization], use_pallas=False, **common)
    te = test_.GameEstimator(task=TTask[task], coordinate_configs=configs(test_, tcoord, tfe, tre),
                             normalization=TNormType[normalization], **common, **port_only)
    return je, te


def model_to_plain(jmodel) -> dict:
    """A JAX GameModel as the plain values ``convert.game_model_from_numpy`` takes."""
    out = {}
    for cid, m in jmodel.models.items():
        if isinstance(m, jgame.FixedEffectModel):
            c = m.glm.coefficients
            out[cid] = {"kind": "fixed", "means": np.asarray(c.means),
                        "variances": None if c.variances is None else np.asarray(c.variances),
                        "task": m.task.value, "feature_shard_id": m.feature_shard_id}
        elif isinstance(m, jmf.MatrixFactorizationModel):
            out[cid] = {"kind": "matrix_factorization", "row_factors": np.asarray(m.row_factors),
                        "col_factors": np.asarray(m.col_factors),
                        "row_effect_type": m.row_effect_type, "col_effect_type": m.col_effect_type,
                        "row_keys": np.asarray(m.row_keys), "col_keys": np.asarray(m.col_keys),
                        "task": m.task.value}
        else:
            out[cid] = {"kind": "random", "coefficients": np.asarray(m.coefficients),
                        "variances": None if m.variances is None else np.asarray(m.variances),
                        "entity_keys": np.asarray(m.entity_keys),
                        "random_effect_type": m.random_effect_type,
                        "feature_shard_id": m.feature_shard_id, "task": m.task.value}
    return out


def assert_models_close(jmodel, tmodel, rtol=1e-8):
    """Every coordinate's coefficients (and variances) agree: ``rtol``
    relative to the largest coefficient of the coordinate."""
    ref, got = model_to_plain(jmodel), convert.game_model_to_numpy(tmodel)
    assert list(ref) == list(got)
    for cid in ref:
        for key in ("means", "coefficients", "variances", "row_factors", "col_factors"):
            r, g = ref[cid].get(key), got[cid].get(key)
            assert (r is None) == (g is None), (cid, key)
            if r is not None:
                scale = np.nanmax(np.abs(r)) if r.size else 1.0
                np.testing.assert_allclose(g, r, rtol=rtol, atol=rtol * scale,
                                           err_msg=f"{cid} {key}")
