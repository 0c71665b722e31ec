"""Shared inputs of the driver parity tests (``tests/test_torch_avro_io.py``,
``tests/test_torch_model_io.py``, ``tests/test_torch_drivers.py``).

The Yahoo-Music-like recommender fixture of ``tests/test_driver_integ.py``
(schema and generator copied here, so that file stays as it is): per-(user,
song) ratings from global features plus per-user and per-song coefficient
vectors, with frozen metric bounds. Plus a logistic TrainingExampleAvro set
for the GLM driver. Records are written with the JAX package's Avro writer,
so both packages read the same bytes.
"""

from __future__ import annotations

import os

import numpy as np

from photon_ml_tpu.io import avro as avro_io
from photon_ml_tpu.io import photon_schemas as schemas

D_GLOBAL = 6
D_ENTITY = 4
N_USERS = 25
N_SONGS = 18
NOISE = 0.1

#: TrainingExampleAvro extended with two extra feature bags, mirroring the
#: reference fixture's userFeatures/songFeatures bags (GameIntegTest data).
MUSIC_SCHEMA = {
    "name": "MusicTrainingExampleAvro",
    "type": "record",
    "fields": [
        {"name": "uid", "type": ["string", "null"]},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": schemas.FEATURE_AVRO}},
        {"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "songFeatures", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "weight", "type": ["double", "null"], "default": None},
        {"name": "offset", "type": ["double", "null"], "default": None},
        {
            "name": "metadataMap",
            "type": [{"type": "map", "values": "string"}, "null"],
            "default": None,
        },
    ],
}


def make_music_records(n, seed, mf_rank: int = 0):
    """Deterministic synthetic ratings. Ground truth fixed across splits.
    ``mf_rank`` > 0 adds a planted user·song term of that rank (the MF
    coordinate's signal)."""
    truth = np.random.default_rng(20260730)
    w_global = truth.normal(size=D_GLOBAL)
    w_user = truth.normal(scale=0.8, size=(N_USERS, D_ENTITY))
    w_song = truth.normal(scale=0.6, size=(N_SONGS, D_ENTITY))
    u_user = truth.normal(scale=1.2, size=(N_USERS, mf_rank))
    v_song = truth.normal(scale=1.2, size=(N_SONGS, mf_rank))

    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        ui = int(rng.integers(0, N_USERS))
        si = int(rng.integers(0, N_SONGS))
        xg = rng.normal(size=D_GLOBAL)
        xu = rng.normal(size=D_ENTITY)
        xs = rng.normal(size=D_ENTITY)
        y = xg @ w_global + xu @ w_user[ui] + xs @ w_song[si] + NOISE * rng.normal()
        y += u_user[ui] @ v_song[si]
        records.append({
            "uid": str(i),
            "label": float(y),
            "features": [{"name": f"g{j}", "term": "", "value": float(xg[j])}
                         for j in range(D_GLOBAL)],
            "userFeatures": [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                             for j in range(D_ENTITY)],
            "songFeatures": [{"name": f"s{j}", "term": "", "value": float(xs[j])}
                             for j in range(D_ENTITY)],
            "weight": 1.0,
            "offset": 0.0,
            "metadataMap": {"userId": f"user{ui}", "songId": f"song{si}",
                            "queryId": f"q{i % 11}"},
        })
    return records


def write_music(base, mf_rank: int = 0) -> None:
    """``base/train`` (1500 rows) and ``base/test`` (400 rows)."""
    for split, n, seed in (("train", 1500, 1), ("test", 400, 2)):
        os.makedirs(os.path.join(base, split), exist_ok=True)
        avro_io.write_container(os.path.join(base, split, "part-00000.avro"), MUSIC_SCHEMA,
                                make_music_records(n, seed, mf_rank))


SHARD_ARGS = [
    "--feature-shard-configurations", "name=global,feature.bags=features,intercept=true",
    "--feature-shard-configurations", "name=userShard,feature.bags=userFeatures,intercept=false",
    "--feature-shard-configurations", "name=songShard,feature.bags=songFeatures,intercept=false",
]
FE_ARGS = ["--coordinate-configurations",
           "name=fe,feature.shard=global,reg.weights=0.1,max.iter=40"]
PER_USER_ARGS = ["--coordinate-configurations",
                 "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                 "reg.weights=1,max.iter=25"]
PER_SONG_ARGS = ["--coordinate-configurations",
                 "name=per-song,feature.shard=songShard,random.effect.type=songId,"
                 "reg.weights=1,max.iter=25"]
NEWTON_USER_ARGS = ["--coordinate-configurations",
                    "name=per-user,feature.shard=userShard,random.effect.type=userId,"
                    "reg.weights=1,optimizer=NEWTON,max.iter=10"]


def training_args(base, out, extra, validation=True) -> list[str]:
    """The JAX driver test's argument list (``tests/test_driver_integ.py``
    ``_train``), linear regression on the music fixture."""
    args = ["--input-data-path", str(os.path.join(base, "train")), "--root-output-dir", str(out),
            "--task-type", "LINEAR_REGRESSION", *SHARD_ARGS]
    if validation:
        args += ["--validation-data-path", str(os.path.join(base, "test")),
                 "--evaluators", "RMSE"]
    return args + list(extra)


def make_logistic_records(n: int, d: int, seed: int) -> list[dict]:
    """TrainingExampleAvro rows of a planted logistic model over a
    ``features`` bag of ``d`` features (ids ``f0``..), a few of each row's
    features left out so rows are sparse, non-unit weights and offsets."""
    truth = np.random.default_rng(7)
    w = truth.normal(size=d) / np.sqrt(d)
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        x = rng.normal(size=d)
        keep = rng.uniform(size=d) > 0.2
        offset = float(0.1 * rng.normal())
        p = 1.0 / (1.0 + np.exp(-(x[keep] @ w[keep] + offset)))
        records.append({
            "uid": str(i),
            "label": float(rng.uniform() < p),
            "features": [{"name": f"f{j}", "term": "t" if j % 3 == 0 else "",
                          "value": float(x[j])} for j in np.flatnonzero(keep)],
            "weight": float(rng.uniform(0.5, 2.0)),
            "offset": offset,
            "foldId": None,
            "metadataMap": None,
        })
    return records


def write_logistic(base, n_train=600, n_test=300, d=12) -> None:
    """``base/train`` and ``base/test`` of :func:`make_logistic_records`."""
    for split, n, seed in (("train", n_train, 11), ("test", n_test, 12)):
        os.makedirs(os.path.join(base, split), exist_ok=True)
        avro_io.write_container(os.path.join(base, split, "part-00000.avro"),
                                schemas.TRAINING_EXAMPLE_AVRO, make_logistic_records(n, d, seed))


def make_sparse_records(n: int, seed: int, *, d: int = 3000, users: int = 20,
                        per_row: int = 8) -> list[dict]:
    """TrainingExampleAvro rows whose ``features`` bag is a name-term bag
    over a power-law column space of ``d`` terms (the hot terms in most
    rows, repeated terms adding up), linear labels from a planted global
    model plus per-user effects on each user's terms, user ids."""
    truth = np.random.default_rng(31)
    w = truth.normal(size=d)
    w_user = 0.5 * truth.normal(size=(users, d))
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        cols = ((rng.random(per_row) ** 4 * d).astype(np.int64) * 7919) % d
        vals = rng.normal(size=per_row) / np.sqrt(per_row)
        u = int(rng.integers(0, users))
        y = vals @ (w[cols] + w_user[u, cols]) + 0.1 * rng.normal()
        records.append({
            "uid": str(i), "label": float(y),
            "features": [{"name": "term", "term": str(c), "value": float(v)}
                         for c, v in zip(cols, vals)],
            "weight": 1.0, "offset": 0.0, "foldId": None,
            "metadataMap": {"userId": f"user{u}"}})
    return records


def write_sparse(base, n_train=900, n_test=300) -> None:
    """``base/train`` and ``base/test`` of :func:`make_sparse_records`."""
    for split, n, seed in (("train", n_train, 21), ("test", n_test, 22)):
        os.makedirs(os.path.join(base, split), exist_ok=True)
        avro_io.write_container(os.path.join(base, split, "part-00000.avro"),
                                schemas.TRAINING_EXAMPLE_AVRO, make_sparse_records(n, seed))


def write_libsvm(path, n: int, seed: int, *, d: int = 120, per_row: int = 14,
                 task: str = "LOGISTIC_REGRESSION") -> None:
    """LibSVM text of a planted model over ``d`` features, ``per_row`` of them
    a row (1-based indices): ±1 labels for a logistic task, real ones else."""
    truth = np.random.default_rng(41)
    w = truth.normal(size=d)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("# planted model\n")
        for _ in range(n):
            cols = np.sort(rng.choice(d, size=per_row, replace=False))
            vals = np.round(rng.normal(size=per_row), 4)
            z = vals @ w[cols]
            if task == "LOGISTIC_REGRESSION":
                label = "+1" if rng.uniform() < 1.0 / (1.0 + np.exp(-z)) else "-1"
            else:
                label = repr(float(np.round(z + 0.1 * rng.normal(), 6)))
            f.write(label + " " + " ".join(f"{c + 1}:{float(v)!r}" for c, v in zip(cols, vals))
                    + "\n")
