"""Fixtures of the port's partitioned I/O tests: Avro inputs written from a
numpy seed, and the JAX package's partitioned reader, rank-local RE builder
and training run on virtual ranks (threads and its ``InProcessExchange``) on
the 8-device virtual CPU mesh, all in float64."""

from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import numpy as np

from photon_ml_torch.io import avro as tavro
from photon_ml_torch.io import photon_schemas as tschemas

SCHEMA = {
    "name": "PartitionedIoExampleAvro", "type": "record",
    "fields": [
        {"name": "uid", "type": ["string", "null"]},
        {"name": "label", "type": "double"},
        {"name": "features", "type": {"type": "array", "items": tschemas.FEATURE_AVRO}},
        {"name": "entityFeatures", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "wideFeatures", "type": {"type": "array", "items": "FeatureAvro"}},
        {"name": "weight", "type": ["double", "null"], "default": None},
        {"name": "offset", "type": ["double", "null"], "default": None},
        {"name": "metadataMap", "type": [{"type": "map", "values": "string"}, "null"],
         "default": None},
    ],
}

#: the shard layouts of the tests, as FeatureShardConfiguration kwargs
CONFIGS = {
    "dense": {"global": dict(feature_bags=("features",)),
              "perUser": dict(feature_bags=("entityFeatures",), has_intercept=False)},
    "sparse": {"global": dict(feature_bags=("features", "wideFeatures"), sparse=True),
               "perUser": dict(feature_bags=("entityFeatures",), has_intercept=False)},
    "hybrid": {"global": dict(feature_bags=("features", "wideFeatures"), sparse=True,
                              hybrid=True, hybrid_hot_cols=6),
               "perUser": dict(feature_bags=("entityFeatures",), has_intercept=False)},
}


def write_input(base, *, num_files: int = 4, rows_per_file: int = 40, seed: int = 1,
                block_records: int = 4096, clustered: bool = True, uid: bool = True,
                users_per_file: int = 4, task: str = "LINEAR_REGRESSION",
                uneven: bool = False) -> str:
    """Avro part files under ``base``: 4 dense global columns, 2 per-user
    columns, a Zipf-wide bag over 60 names (1-11 draws a row), planted fixed
    and per-user effects. ``clustered`` gives each file users of its own, so
    a contiguous file assignment keeps every user on one rank; otherwise
    every file draws from one pool and users span ranks. ``uneven`` skews
    the users' row counts, another user most in each file (several bucket
    capacities, and a spanning user in a different bucket on each rank)."""
    base = Path(base)
    base.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pool = 4 * users_per_file
    effects = 0.8 * rng.normal(size=(num_files * pool + pool, 2))
    schema = SCHEMA if uid else dict(SCHEMA, fields=[f for f in SCHEMA["fields"]
                                                     if f["name"] != "uid"])
    row = 0
    for part in range(num_files):
        recs = []
        for _ in range(rows_per_file):
            xg = rng.normal(size=4)
            xu = rng.normal(size=2)
            if uneven:  # each file favours another user
                u = int((min(rng.geometric(0.4) - 1, users_per_file - 1) + part)
                        % users_per_file)
            else:
                u = int(rng.integers(0, users_per_file))
            user = part * users_per_file + u if clustered else u
            wide = sorted(set((rng.zipf(1.6, size=int(rng.integers(1, 12))) - 1) % 60))
            z = xg.sum() * 0.5 + xu @ effects[user]
            y = z + 0.1 * rng.normal() if task == "LINEAR_REGRESSION" \
                else float(rng.uniform() < 1 / (1 + np.exp(-z)))
            rec = {
                "label": float(y),
                "features": [{"name": f"g{j}", "term": "", "value": float(xg[j])}
                             for j in range(4)],
                "entityFeatures": [{"name": f"u{j}", "term": "", "value": float(xu[j])}
                                   for j in range(2)],
                "wideFeatures": [{"name": f"w{j}", "term": "t", "value": float(rng.normal())}
                                 for j in wide],
                "weight": float(rng.uniform(0.5, 1.5)), "offset": float(0.05 * rng.normal()),
                "metadataMap": {"userId": f"user{user:03d}", "queryId": str(row % 7)},
            }
            if uid:
                rec["uid"] = str(1000 + row)
            recs.append(rec)
            row += 1
        tavro.write_container(str(base / f"part-{part:05d}.avro"), schema, recs,
                              block_records=block_records)
    return str(base)


def on_threads(num_ranks: int, fn) -> list:
    """``fn(rank)`` on one thread a rank; the results in rank order."""
    out = [None] * num_ranks
    errors = []

    def run(r):
        try:
            out[r] = fn(r)
        except BaseException as e:  # surfaced below
            errors.append((r, e))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(num_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors:
        raise errors[0][1]
    return out


def jconfigs(spec: dict) -> dict:
    from photon_ml_tpu.io.data_reader import FeatureShardConfiguration

    return {k: FeatureShardConfiguration(**v) for k, v in spec.items()}


def jread_ranks(path, spec: dict, num_ranks: int, *, re_columns=("userId",), **kw) -> tuple:
    """The JAX package's read_partitioned on ``num_ranks`` virtual ranks:
    (results, exchanges)."""
    from photon_ml_tpu.io.partitioned_reader import read_partitioned
    from photon_ml_tpu.parallel.multihost import InProcessExchange

    exchanges = InProcessExchange.create_group(num_ranks)
    kw.setdefault("dtype", np.float64)
    parts = on_threads(num_ranks, lambda r: read_partitioned(
        path, jconfigs(spec), exchange=exchanges[r], random_effect_id_columns=re_columns, **kw))
    return parts, exchanges


def tread_ranks(path, spec: dict, num_ranks: int, *, re_columns=("userId",), **kw) -> tuple:
    """The port's read_partitioned on ``num_ranks`` virtual ranks."""
    from photon_ml_torch.io.partitioned_reader import read_partitioned
    from photon_ml_torch.parallel.multihost import InProcessExchange
    from tests.torch_mesh_worker import shard_configs

    exchanges = InProcessExchange.create_group(num_ranks)
    kw.setdefault("dtype", np.float64)
    parts = on_threads(num_ranks, lambda r: read_partitioned(
        path, shard_configs(spec), exchange=exchanges[r], random_effect_id_columns=re_columns,
        device="cpu", **kw))
    return parts, exchanges


def jread_numpy(part) -> dict:
    """A JAX PartitionedReadResult (or ReadResult) as the worker's
    ``read_numpy`` dict."""
    from photon_ml_tpu.data.sparse_batch import SparseShard

    result = getattr(part, "result", part)
    ds = result.dataset
    out = {"labels": np.asarray(ds.host_array("labels")),
           "offsets": np.asarray(ds.host_array("offsets")),
           "weights": np.asarray(ds.host_array("weights")),
           "unique_ids": np.asarray(ds.unique_ids),
           "vocabs": {k: np.asarray(v) for k, v in ds.entity_vocabs.items()},
           "entity_idx": {k: np.asarray(ds.host_array(f"entity_idx/{k}")) for k in ds.entity_idx},
           "ids": {k: np.asarray(v) for k, v in ds.ids.items()},
           "maps": {k: dict(m) for k, m in result.index_maps.items()},
           "intercepts": dict(result.intercept_indices), "shards": {}, "sparse": {}}
    for k, v in ds.feature_shards.items():
        if isinstance(v, SparseShard):
            r, c, x = (np.asarray(a) for a in v.coalesced())
            policy = v.hybrid_policy
            out["sparse"][k] = {"rows": r, "cols": c, "vals": x, "n": v.num_samples,
                                "dim": v.feature_dim, "ell_width": v.ell_width,
                                "flat_block_nnz": v.flat_block_nnz,
                                "hot_ids": None if policy is None else policy.hot_ids}
        else:
            out["shards"][k] = np.asarray(ds.host_array(f"shard/{k}"))
    if hasattr(part, "partition"):
        import os

        out.update(partition=dataclasses.astuple(part.partition), mode=part.mode,
                   bytes_decoded=part.bytes_decoded, input_bytes_total=part.input_bytes_total,
                   local_files=[os.path.basename(f) for f in part.local_files],
                   presence={k: np.asarray(v) for k, v in part.entity_rank_presence.items()})
    return out


def assert_reads_equal(got: dict, ref: dict, *, layout: bool = True) -> None:
    """Every array, map, vocabulary and the partition equal (``layout``:
    the sparse shards' agreed ELL width, flat length and hot ids too)."""
    for k in ("labels", "offsets", "weights", "unique_ids"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for group in ("vocabs", "entity_idx", "ids", "shards"):
        assert sorted(got[group]) == sorted(ref[group]), group
        for k in ref[group]:
            np.testing.assert_array_equal(got[group][k], ref[group][k], err_msg=f"{group}/{k}")
    assert got["maps"] == ref["maps"] and got["intercepts"] == ref["intercepts"]
    assert sorted(got["sparse"]) == sorted(ref["sparse"])
    for k, r in ref["sparse"].items():
        g = got["sparse"][k]
        for f in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{k}/{f}")
        fields = ("n", "dim") + (("ell_width", "flat_block_nnz", "hot_ids") if layout else ())
        for f in fields:
            assert g[f] == r[f], (k, f, g[f], r[f])
    for k in ("partition", "mode", "bytes_decoded", "input_bytes_total", "local_files"):
        if k in ref:
            assert got[k] == ref[k], (k, got[k], ref[k])
    if "presence" in ref:
        assert sorted(got["presence"]) == sorted(ref["presence"])
        for k in ref["presence"]:
            np.testing.assert_array_equal(got["presence"][k], ref["presence"][k])


def program(task: str = "LINEAR_REGRESSION", *, bucket_sizes=(8, 32, 128), res=True,
            scheduler: dict | None = None) -> dict:
    """A worker program spec: a fixed effect on ``global`` and a per-user
    effect on ``perUser`` (L-BFGS, a few iterations); ``scheduler`` (the
    LaneSchedulerConfig fields) schedules the per-user lanes."""
    lbfgs = ("LBFGS", 8, {})
    re_opt = lbfgs if scheduler is None else (
        "LBFGS", 8, {"rel_function_tolerance": 1e-6, "scheduler": dict(scheduler)})
    return dict(task=task, fe_shard="global", fe_opt=lbfgs, fe_l2=0.5,
                res=[dict(type="userId", shard="perUser", opt=re_opt, l2=1.0)] if res else [],
                bucket_sizes=tuple(bucket_sizes))


def jtrain_partitioned(path, spec: dict, p: dict, *, num_ranks: int = 2, sweeps: int = 2):
    """The JAX package's read_partitioned -> build_random_effect_dataset_
    partitioned -> train_partitioned on virtual ranks over a data=num_ranks
    mesh: (result, program, parts, re_parts)."""
    from photon_ml_tpu.data.game_data import build_random_effect_dataset_partitioned
    from tests import torch_mesh_parity as MP

    parts, exchanges = jread_ranks(path, spec, num_ranks)
    mesh = MP.jmesh(num_ranks)

    def build(r):
        return {x["type"]: build_random_effect_dataset_partitioned(
            parts[r].result.dataset, x["type"], x["shard"], partition=parts[r].partition,
            exchange=exchanges[r], bucket_sizes=p["bucket_sizes"],
            entity_rank_presence=parts[r].entity_rank_presence.get(x["type"]))
            for x in p["res"]}

    re_parts = on_threads(num_ranks, build)
    from photon_ml_tpu.parallel.distributed import train_partitioned

    from photon_ml_tpu.algorithm.lane_scheduler import make_schedulers

    prog = MP.jprogram(p, mesh)
    res = train_partitioned(prog, {r: (parts[r].result.dataset, re_parts[r])
                                   for r in range(num_ranks)}, mesh, num_ranks,
                            num_iterations=sweeps,
                            schedulers=make_schedulers(prog.re_specs, mesh=mesh) or None)
    return res, prog, parts, re_parts
