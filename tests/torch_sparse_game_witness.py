"""Phase 9's scaled GAME fit (``chip_smoke.py`` ``_sparse_game_slice``, fit c:
SCALE_WITH_MAX_MAGNITUDE) on the CPU, in the JAX package and in the port, at
the phase's own size or a fraction of its rows: what each package's training
loss and held-out RMSE do over the sweeps, beside the fixed effect's alone.

Both packages take the same numpy data (``chip_smoke._sparse_game_arrays``:
bench.py:721's shapes, d = 10^6, 16 Zipf columns a row, 2000 users) and the
same model (``_sparse_game_estimator``: L-BFGS fixed effect and per-user
L-BFGS lanes, 10 iterations each, L2 weight 1, 4 sweeps) in float32, as the
card runs it. The random effect lives on the fixed effect's sparse shard, so
it is compact in both. Variances are left out: they do not change a fit.

Run from the repository root (about 1.1 GiB of memory at full size):

    JAX_PLATFORMS=cpu python -m tests.torch_sparse_game_witness [--rows-divisor 16]

It prints one JSON line a package: the training loss after each sweep, the
held-out RMSE after each sweep and that of the first update (the fixed
effect alone, the random effect at 0).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from chip_smoke import SPARSE_GAME, _sparse_game_arrays  # noqa: E402
from photon_ml_tpu import estimators as jest  # noqa: E402
from photon_ml_tpu.algorithm import coordinates as jcoord  # noqa: E402
from photon_ml_tpu.data import game_data as jgd  # noqa: E402
from photon_ml_tpu.data.sparse_batch import SparseShard as JShard  # noqa: E402
from photon_ml_tpu.ops.normalization import NormalizationType as JNorm  # noqa: E402
from photon_ml_tpu.types import TaskType as JTask  # noqa: E402
from photon_ml_torch import estimators as test_  # noqa: E402
from photon_ml_torch.algorithm import coordinates as tcoord  # noqa: E402
from photon_ml_torch.data import game_data as tgd  # noqa: E402
from photon_ml_torch.data.sparse_batch import SparseShard as TShard  # noqa: E402
from photon_ml_torch.ops.normalization import NormalizationType as TNorm  # noqa: E402
from photon_ml_torch.types import TaskType as TTask  # noqa: E402
from tests.torch_game_parity import optimizer_pair  # noqa: E402


def _datasets(part, d: int, build, shard_cls, vocabs=None, **kw):
    shard = shard_cls(rows=part["rows"].astype(np.int64), cols=part["cols"].astype(np.int64),
                      vals=part["vals"].astype(np.float32), num_samples=part["n"],
                      feature_dim=d)
    return build(labels=part["labels"], feature_shards={"global": shard},
                 entity_keys={"user": part["users"]}, entity_vocabs=vocabs, dtype=np.float32,
                 **kw)


def _estimator(est, coord, task, norm, opts, sweeps: int, **kw):
    fe_opt, re_opt = opts

    def cfg(opt):
        return coord.CoordinateOptimizationConfig(optimizer=opt, l2_weight=1.0)

    return est.GameEstimator(
        task=task.LINEAR_REGRESSION,
        coordinate_configs={
            "fixed": est.FixedEffectCoordinateConfig("global", cfg(fe_opt)),
            "per_user": est.RandomEffectCoordinateConfig("user", "global", cfg(re_opt))},
        num_iterations=sweeps, normalization=norm.SCALE_WITH_MAX_MAGNITUDE,
        validation_evaluators=("RMSE",), **kw)


def _summary(package: str, result, seconds: float) -> dict:
    history = result.metric_history
    loss_name = next(k for k in history[0] if k.startswith("train:"))
    last = [h for h in history if h["coordinate"] == history[-1]["coordinate"]]
    return {"package": package, "seconds": seconds,
            "loss_per_sweep": [float(h[loss_name]) for h in last],
            "held_out_rmse_per_sweep": [float(h["validate:RMSE"]) for h in last],
            "fe_alone_held_out_rmse": float(history[0]["validate:RMSE"])}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows-divisor", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    cfg = SPARSE_GAME
    n, held_out = cfg["n"] // args.rows_divisor, cfg["held_out"] // args.rows_divisor
    train, held = _sparse_game_arrays(np, args.seed, n, cfg["d"], cfg["per_row"], cfg["users"],
                                      held_out)
    print(json.dumps({"rows": n, "held_out": held_out, "d": cfg["d"], "sweeps": cfg["sweeps"]}),
          flush=True)
    jfe, tfe = optimizer_pair("LBFGS", 10)
    jre, tre = optimizer_pair("LBFGS", 10)
    for package in ("jax", "torch"):
        if package == "jax":
            ds = _datasets(train, cfg["d"], jgd.build_game_dataset, JShard)
            held_ds = _datasets(held, cfg["d"], jgd.build_game_dataset, JShard,
                                vocabs=ds.entity_vocabs)
            est = _estimator(jest, jcoord, JTask, JNorm, (jfe, jre), cfg["sweeps"],
                             use_pallas=False)
        else:
            ds = _datasets(train, cfg["d"], tgd.build_game_dataset, TShard, device="cpu")
            held_ds = _datasets(held, cfg["d"], tgd.build_game_dataset, TShard,
                                vocabs=ds.entity_vocabs, device="cpu")
            est = _estimator(test_, tcoord, TTask, TNorm, (tfe, tre), cfg["sweeps"])
        t0 = time.perf_counter()
        result = est.fit(ds, validation_dataset=held_ds)
        print(json.dumps(_summary(package, result, time.perf_counter() - t0)), flush=True)
        del ds, held_ds, est, result


if __name__ == "__main__":
    main()
