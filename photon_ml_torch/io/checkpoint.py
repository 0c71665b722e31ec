"""Mid-training checkpoints and resume.

Counterpart of ``photon_ml_tpu/io/checkpoint.py``, with the same layout,
array keys and ``meta.json`` fields, so a checkpoint written by either
package restores in the other:

- :class:`TrainingCheckpointer` writes one step directory per save
  (``step_XXXXXXXX/arrays.npz`` + ``meta.json``) through a temporary
  directory and ``os.replace``, prunes to ``max_to_keep``, and restores the
  newest step that loads (a damaged step falls back to the one before).
- ``run_coordinate_descent(checkpointer=)`` saves coordinate-descent
  progress (:func:`pack_cd_state`); ``train_distributed`` and
  ``train_partitioned`` save the fused program's ``GameTrainState`` per
  sweep through :func:`commit_checkpoint`, the one write site of a training
  loop (rank 0 writes; with an exchange, between two barriers).
- :class:`SolverCheckpointer` saves a streamed GLM solve
  (``estimators.train_glm_streaming``): the solver's state, the λ-grid
  position, the epoch cursor and the finished λs' coefficients.

State reaches the host by ``.cpu().numpy()`` on the caller's thread, never
through a CUDA tensor in a worker thread. A compact random-effect model
(``[E, K]`` over each entity's active columns) also saves its
``{cid}/active_cols`` and ``feature_dim``, which the JAX package leaves out
and ignores on restore.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
import time
import zipfile
from typing import Any, Mapping

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import (
    DatumScoringModel,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)

_STEP_PREFIX = "step_"
_META_FILE = "meta.json"
_ARRAYS_FILE = "arrays.npz"


def host_array(v) -> np.ndarray:
    """``v`` as a host numpy array (a tensor through ``.cpu().numpy()``)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class DivergenceError(RuntimeError):
    """Training state went non-finite (a coordinate update's scores, a fused
    sweep's loss). With a checkpoint to restore, ``run_with_recovery``
    resumes from it instead of training on NaNs."""


@dataclasses.dataclass
class Checkpoint:
    """One restored checkpoint: step id, flat arrays, JSON metadata."""

    step: int
    arrays: dict[str, np.ndarray]
    meta: dict[str, Any]


class TrainingCheckpointer:
    """Atomic, pruned, numbered checkpoints under one directory::

        <directory>/step_00000007/{arrays.npz, meta.json}

    ``save`` writes a ``tmp.*`` sibling and renames it into place, then
    prunes older steps down to ``max_to_keep``. ``last_save`` holds the
    bytes and seconds of the newest save."""

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3):
        self.directory = str(directory)
        self.max_to_keep = max(1, int(max_to_keep))
        self.last_save: dict | None = None
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:08d}")

    def save(self, step: int, arrays: Mapping[str, Any], meta: dict) -> str:
        t0 = time.perf_counter()
        step_dir = self._step_dir(step)
        tmp_dir = tempfile.mkdtemp(prefix="tmp.", dir=self.directory)
        try:
            host = {k: host_array(v) for k, v in arrays.items()}
            np.savez(os.path.join(tmp_dir, _ARRAYS_FILE), **host)
            with open(os.path.join(tmp_dir, _META_FILE), "w") as f:
                json.dump({"step": step, **meta}, f, indent=2, default=str)
            if os.path.isdir(step_dir):
                shutil.rmtree(step_dir)
            os.replace(tmp_dir, step_dir)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            raise
        self._prune()
        self.last_save = {"step": step, "seconds": time.perf_counter() - t0,
                          "bytes": os.path.getsize(os.path.join(step_dir, _ARRAYS_FILE))}
        return step_dir

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith(_STEP_PREFIX):
                continue
            path = os.path.join(self.directory, name)
            # intact = both files present
            if os.path.isfile(os.path.join(path, _META_FILE)) and \
                    os.path.isfile(os.path.join(path, _ARRAYS_FILE)):
                try:
                    out.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def newest_loadable_step(self) -> int | None:
        """Newest step that passes the cheap integrity probe, or None."""
        for step in reversed(self.steps()):
            if self._loadable(step):
                return step
        return None

    #: what a truncated or garbled step file raises on load
    _CORRUPT_ERRORS = (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile)

    def _load(self, step: int) -> Checkpoint:
        step_dir = self._step_dir(step)
        with open(os.path.join(step_dir, _META_FILE)) as f:
            meta = json.load(f)
        with np.load(os.path.join(step_dir, _ARRAYS_FILE), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        return Checkpoint(step=step, arrays=arrays, meta=meta)

    def restore(self, step: int | None = None) -> Checkpoint | None:
        """Restore ``step`` (default: the newest step that loads; a damaged
        one falls back to the one before, with a warning). None when no
        step loads; ValueError for a requested step that is missing."""
        if step is not None:
            if step not in self.steps():
                raise ValueError(f"checkpoint step {step} not found (intact steps: "
                                 f"{self.steps()})")
            return self._load(step)
        for candidate in reversed(self.steps()):
            try:
                return self._load(candidate)
            except self._CORRUPT_ERRORS as e:
                logger.warning("checkpoint step %d at %s is corrupt (%s: %s); falling back "
                               "to the previous step", candidate, self.directory,
                               type(e).__name__, e)
        return None

    def _loadable(self, step: int) -> bool:
        """Meta parses and the npz's zip directory reads (no array is read)."""
        step_dir = self._step_dir(step)
        try:
            with open(os.path.join(step_dir, _META_FILE)) as f:
                json.load(f)
            with zipfile.ZipFile(os.path.join(step_dir, _ARRAYS_FILE)) as z:
                z.namelist()
            return True
        except self._CORRUPT_ERRORS:
            return False

    def _prune(self) -> None:
        steps = self.steps()
        doomed = steps[: -self.max_to_keep]
        if not doomed:
            return
        kept = steps[-self.max_to_keep:]
        if not any(self._loadable(s) for s in kept):
            # every kept step is damaged: keep the newest loadable older one
            for s in reversed(doomed):
                if self._loadable(s):
                    logger.warning("keeping checkpoint step %d beyond max_to_keep=%d: it is "
                                   "the newest loadable step (%s newer steps are corrupt)",
                                   s, self.max_to_keep, len(kept))
                    doomed = [d for d in doomed if d != s]
                    break
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def _process_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def commit_checkpoint(checkpointer, step: int, arrays: Mapping[str, Any], meta: dict, *,
                      exchange=None) -> str | None:
    """The one checkpoint write site of a training loop. Every rank calls
    it. Without an exchange, the process of rank 0 writes; with one, a
    barrier before (the step commits only when every rank reached it), rank
    0's write, and a barrier after (no rank runs ahead of the publish).
    Returns the step directory on the writing rank, None elsewhere."""
    from photon_ml_torch.telemetry import tracing

    if checkpointer is None:
        return None
    if exchange is None:
        if _process_rank() != 0:
            return None
        with tracing.span("checkpoint/write", cat="checkpoint", step=step):
            return checkpointer.save(step, arrays, meta)
    # the commit span brackets both barriers (whose waits the exchange's
    # own spans record) and the write; the barriers are the same untraced
    with tracing.span("checkpoint/commit", cat="checkpoint", step=step, rank=exchange.rank):
        exchange.barrier(f"checkpoint_commit/{step}/ready")
        # the exchange's rank 0 (a data-axis exchange has one per model
        # rank: of those, the process of rank 0)
        path = None
        if exchange.rank == 0 and _process_rank() == 0:
            with tracing.span("checkpoint/write", cat="checkpoint", step=step,
                              rank=exchange.rank):
                path = checkpointer.save(step, arrays, meta)
        exchange.barrier(f"checkpoint_commit/{step}/published")
        return path


# -- GAME models as flat arrays ------------------------------------------------


def game_model_to_arrays(model: GameModel) -> tuple[dict[str, np.ndarray], dict]:
    """(arrays, structure metadata) of a GameModel."""
    arrays: dict[str, np.ndarray] = {}
    coords_meta: dict[str, dict] = {}
    for cid, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            arrays[f"{cid}/means"] = host_array(sub.glm.coefficients.means)
            if sub.glm.coefficients.variances is not None:
                arrays[f"{cid}/variances"] = host_array(sub.glm.coefficients.variances)
            coords_meta[cid] = {"kind": "fixed", "feature_shard_id": sub.feature_shard_id,
                                "task": sub.glm.task.name}
        elif isinstance(sub, RandomEffectModel):
            arrays[f"{cid}/coefficients"] = host_array(sub.coefficients)
            arrays[f"{cid}/entity_keys"] = np.asarray(sub.entity_keys)
            if sub.variances is not None:
                arrays[f"{cid}/variances"] = host_array(sub.variances)
            coords_meta[cid] = {"kind": "random", "random_effect_type": sub.random_effect_type,
                                "feature_shard_id": sub.feature_shard_id,
                                "task": sub.task.name}
            if sub.active_cols is not None:
                arrays[f"{cid}/active_cols"] = np.asarray(sub.active_cols)
                coords_meta[cid]["feature_dim"] = int(sub.feature_dim)
        elif isinstance(sub, MatrixFactorizationModel):
            arrays[f"{cid}/row_factors"] = host_array(sub.row_factors)
            arrays[f"{cid}/col_factors"] = host_array(sub.col_factors)
            arrays[f"{cid}/row_keys"] = np.asarray(sub.row_keys)
            arrays[f"{cid}/col_keys"] = np.asarray(sub.col_keys)
            coords_meta[cid] = {"kind": "matrix_factorization",
                                "row_effect_type": sub.row_effect_type,
                                "col_effect_type": sub.col_effect_type, "task": sub.task.name}
        else:
            raise TypeError(f"Cannot checkpoint sub-model type {type(sub)!r}")
    return arrays, {"coordinates": coords_meta, "order": list(model.models)}


def game_model_from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any], *,
                           device=None) -> GameModel:
    """Inverse of :func:`game_model_to_arrays`, its tables on ``device``
    (CUDA unless ``"cpu"``)."""
    device = resolve_device(device)

    def tensor(a):
        return None if a is None else torch.as_tensor(np.asarray(a), device=device)

    models: dict[str, DatumScoringModel] = {}
    coords_meta = meta["coordinates"]
    for cid in meta["order"]:
        info = coords_meta[cid]
        task = TaskType[info["task"]]
        variances = tensor(arrays.get(f"{cid}/variances"))
        if info["kind"] == "fixed":
            glm = GeneralizedLinearModel(
                coefficients=Coefficients(means=tensor(arrays[f"{cid}/means"]),
                                          variances=variances), task=task)
            models[cid] = FixedEffectModel(glm=glm, feature_shard_id=info["feature_shard_id"])
        elif info["kind"] == "random":
            active = arrays.get(f"{cid}/active_cols")
            models[cid] = RandomEffectModel(
                coefficients=tensor(arrays[f"{cid}/coefficients"]),
                entity_keys=arrays[f"{cid}/entity_keys"],
                random_effect_type=info["random_effect_type"],
                feature_shard_id=info["feature_shard_id"], task=task, variances=variances,
                active_cols=None if active is None else np.asarray(active),
                feature_dim=info.get("feature_dim"))
        elif info["kind"] == "matrix_factorization":
            models[cid] = MatrixFactorizationModel(
                row_factors=tensor(arrays[f"{cid}/row_factors"]),
                col_factors=tensor(arrays[f"{cid}/col_factors"]),
                row_effect_type=info["row_effect_type"], col_effect_type=info["col_effect_type"],
                row_keys=arrays[f"{cid}/row_keys"], col_keys=arrays[f"{cid}/col_keys"],
                task=task)
        else:
            raise ValueError(f"Unknown checkpoint coordinate kind {info['kind']!r}")
    return GameModel(models=models)


def _with_prefix(arrays: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    return {f"{prefix}{k}": v for k, v in arrays.items()}


def _strip_prefix(arrays: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def pack_cd_state(model: GameModel, best_model: GameModel | None, best_metric: float,
                  metric_history: list[dict]) -> tuple[dict[str, np.ndarray], dict]:
    """Coordinate-descent progress (current and best model) as flat arrays."""
    arrays, model_meta = game_model_to_arrays(model)
    out = _with_prefix(arrays, "model/")
    meta: dict[str, Any] = {
        "model": model_meta,
        "best_metric": None if np.isnan(best_metric) else float(best_metric),
        "metric_history": metric_history,
    }
    if best_model is not None:
        best_arrays, best_meta = game_model_to_arrays(best_model)
        out.update(_with_prefix(best_arrays, "best/"))
        meta["best"] = best_meta
    return out, meta


def unpack_cd_state(ckpt: Checkpoint, *, device=None
                    ) -> tuple[GameModel, GameModel | None, float, list[dict]]:
    """Inverse of :func:`pack_cd_state`."""
    model = game_model_from_arrays(_strip_prefix(ckpt.arrays, "model/"), ckpt.meta["model"],
                                   device=device)
    best_model = None
    if ckpt.meta.get("best") is not None:
        best_model = game_model_from_arrays(_strip_prefix(ckpt.arrays, "best/"),
                                            ckpt.meta["best"], device=device)
    raw = ckpt.meta.get("best_metric")
    best_metric = float("nan") if raw is None else float(raw)
    return model, best_model, best_metric, list(ckpt.meta.get("metric_history", []))


def latest_trained_model(checkpointer: TrainingCheckpointer, *, device=None
                         ) -> "tuple[GameModel, int] | None":
    """(current GameModel, step) of the newest intact checkpoint: a
    coordinate-descent checkpoint (the "model/" prefix) or an
    incremental-refresh one (bare layout). None when no step loads;
    ValueError for a checkpoint that holds no model (a streamed solve's)."""
    ckpt = checkpointer.restore()
    if ckpt is None:
        return None
    if ckpt.meta.get("kind") == "incremental_refresh":
        return game_model_from_arrays(ckpt.arrays, ckpt.meta["model"], device=device), ckpt.step
    if "model" in ckpt.meta and any(k.startswith("model/") for k in ckpt.arrays):
        return game_model_from_arrays(_strip_prefix(ckpt.arrays, "model/"), ckpt.meta["model"],
                                      device=device), ckpt.step
    raise ValueError(
        f"checkpoint step {ckpt.step} at {checkpointer.directory} carries "
        f"no GAME model (kind={ckpt.meta.get('kind')!r}); point the "
        "refresh at the training run's coordinate-descent checkpoint "
        "directory or pass a saved model directory")


def fingerprint_mismatch(saved: dict | None, expected: dict) -> str | None:
    """None when the fingerprints agree; otherwise a clause naming the
    differing fields with both sides' values."""
    saved = saved or {}
    if saved == expected:
        return None
    diff = sorted(k for k in set(saved) | set(expected) if saved.get(k) != expected.get(k))
    return (f"differs on {diff}: checkpoint={ {k: saved.get(k) for k in diff} }, "
            f"this run={ {k: expected.get(k) for k in diff} }")


# -- streamed solver-state checkpoints ----------------------------------------


@dataclasses.dataclass
class SolverProgress:
    """One restored streamed-solve position.

    lam_index: index into the sorted λ grid of the solve in flight
        (``len(grid)`` when the run ended after the last λ).
    iteration: the outer solver iteration the state was saved at.
    epochs_total: epochs spent by finished λs; epochs_lambda: by the λ in
        flight up to the save.
    completed: [(λ, solve-space coefficients)] of the finished λs.
    state_arrays: the solver state's fields (None on a λ boundary).
    """

    lam_index: int
    iteration: int
    epochs_total: int
    epochs_lambda: int
    completed: list
    state_arrays: dict | None


class SolverCheckpointer:
    """Iteration-granular checkpoints of streamed GLM solves, through a
    :class:`TrainingCheckpointer`. A ``fingerprint`` (λ grid, optimizer,
    dimensions, chunk plan, input) rides every save, and a restore under
    another fingerprint fails fast naming the differing fields. Step ids are
    ``lam_index * STEP_STRIDE + iteration + 1``, monotone over the run."""

    STEP_STRIDE = 1_000_000

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3,
                 save_every: int = 1):
        #: iteration cadence of mid-solve saves (λ-boundary saves always run):
        #: the state is d·(2m+4) values for L-BFGS
        self.save_every = max(1, int(save_every))
        self._inner = TrainingCheckpointer(directory, max_to_keep=max_to_keep)
        self.directory = self._inner.directory
        #: (bytes, seconds) of every save this object made
        self.saves: list[tuple[int, float]] = []

    def latest_step(self) -> int | None:
        return self._inner.latest_step()

    def newest_loadable_step(self) -> int | None:
        return self._inner.newest_loadable_step()

    def save_progress(self, *, fingerprint: dict, lam_index: int, iteration: int,
                      epochs_total: int, epochs_lambda: int, completed,
                      solver_state=None) -> str:
        """Persist one snapshot. Each is self-contained (the finished λs'
        coefficients are written every time), so pruning and the
        corrupt-step fallback never break a newer snapshot."""
        arrays: dict[str, np.ndarray] = {}
        lams = []
        for i, (lam, w) in enumerate(completed):
            lams.append(float(lam))
            arrays[f"completed/{i:04d}"] = host_array(w)
        state_fields: list[str] = []
        if solver_state is not None:
            for name, value in solver_state.to_arrays().items():
                state_fields.append(name)
                arrays[f"state/{name}"] = value
        meta = {
            "kind": "solver_progress",
            "fingerprint": fingerprint,
            "lam_index": int(lam_index),
            "iteration": int(iteration),
            "epochs_total": int(epochs_total),
            "epochs_lambda": int(epochs_lambda),
            "completed_lambdas": lams,
            "state_fields": state_fields,
        }
        step = int(lam_index) * self.STEP_STRIDE + int(iteration) + 1
        path = self._inner.save(step, arrays, meta)
        self.saves.append((self._inner.last_save["bytes"], self._inner.last_save["seconds"]))
        return path

    def restore_progress(self, fingerprint: dict) -> SolverProgress | None:
        """Newest intact snapshot, or None; ValueError naming the differing
        fields when it was written under another fingerprint."""
        ckpt = self._inner.restore()
        if ckpt is None:
            return None
        if ckpt.meta.get("kind") != "solver_progress":
            raise ValueError(
                f"checkpoint at {self.directory} is not a streaming-solver "
                f"checkpoint (kind={ckpt.meta.get('kind')!r}); use a fresh "
                "checkpoint directory")
        mismatch = fingerprint_mismatch(ckpt.meta.get("fingerprint"), fingerprint)
        if mismatch is not None:
            raise ValueError(
                f"streaming checkpoint at {self.directory} was written "
                f"under a different solve fingerprint ({mismatch}); resume "
                "with the original λ grid/optimizer/input, or use a fresh "
                "checkpoint directory")
        completed = [(float(lam), ckpt.arrays[f"completed/{i:04d}"])
                     for i, lam in enumerate(ckpt.meta.get("completed_lambdas", []))]
        state_fields = ckpt.meta.get("state_fields") or []
        state_arrays = ({name: ckpt.arrays[f"state/{name}"] for name in state_fields}
                        if state_fields else None)
        return SolverProgress(
            lam_index=int(ckpt.meta["lam_index"]), iteration=int(ckpt.meta["iteration"]),
            epochs_total=int(ckpt.meta.get("epochs_total", 0)),
            epochs_lambda=int(ckpt.meta.get("epochs_lambda", 0)),
            completed=completed, state_arrays=state_arrays)
