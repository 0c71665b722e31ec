"""Incremental GAME retrain: solve again only what changed, carry the rest.

Counterpart of ``photon_ml_tpu/algorithm/refresh.py``; reference partial
retraining through locked coordinates (photon-lib
algorithm/CoordinateDescent.scala:44-49) and warm starts between
configurations (GameEstimator.scala:352-366). The reference stops at the
coordinate; a refresh here goes down to the entity: a daily refresh solves
again only the random-effect entities whose data changed or whose gradient
at the resident solution exceeds a tolerance, against residuals frozen at
the resident model's scores, warm-started from its coefficients.

- **Selection** (:func:`select_refresh_entities`): the entities declared
  changed (``RefreshPolicy.changed_entities``), together with those whose
  solve-space gradient norm at the resident coefficients exceeds
  ``gradient_tolerance`` (one lane-batched gradient per bucket).
- **Solve**: the lane scheduler's active set chosen from outside
  (``LaneScheduler.freeze_rows``): unselected lanes are frozen and skipped,
  selected lanes solve with the whole iteration budget from their resident
  rows, and the other table rows carry over bitwise.
- **Frozen residuals**: each coordinate solves against the resident model's
  partial score (its full score less the coordinate's own), the residual
  offsets of the coordinate-descent loop taken once at the resident state.
- **Resume**: a checkpointer commits after every coordinate through
  ``io/checkpoint.commit_checkpoint``; a refresh stopped and started again
  skips the coordinates it finished and ends bitwise where an uninterrupted
  one ends. A checkpoint written under another layout or λ fails fast,
  naming the fields that differ. A restore counts in
  ``resilience.recovery.counts``.

Nothing here runs unless asked (``GameEstimator.refresh``, the training
driver's ``--incremental-refresh``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_ml_torch.algorithm.coordinates import (
    Coordinate,
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_torch.models.game import GameModel
from photon_ml_torch.telemetry import refresh_counters

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """What a refresh solves again.

    gradient_tolerance: entities whose solve-space gradient norm at the
        resident solution exceeds this (None: declared entities only).
    changed_entities: RE type -> entity keys that saw new data since the
        resident fit (may be empty: new rows move the gradient too).
    refresh_fixed_effects: also solve the fixed-effect coordinates again,
        warm-started, against the refreshed residuals.
    """

    gradient_tolerance: float | None = 1e-4
    changed_entities: Mapping[str, Sequence] = dataclasses.field(default_factory=dict)
    refresh_fixed_effects: bool = False


@dataclasses.dataclass
class RefreshResult:
    """One incremental refresh's model and its selection."""

    model: GameModel
    coordinate_stats: dict
    lanes_total: int = 0
    lanes_solved: int = 0
    lanes_changed: int = 0
    lanes_gradient: int = 0


class RefreshFingerprintError(ValueError):
    """A refresh (or its checkpoint) against a resident model trained under
    another layout or λ, raised with the differing fields named."""


def _shard_dim(shard) -> int:
    return int(getattr(shard, "feature_dim", None) or shard.shape[1])


def _vocab_digest(keys) -> str:
    """Content digest of an entity vocab: keys through ``str``, so a string
    vocab and an integer one with equal keys digest equal."""
    h = hashlib.sha1()
    for k in np.asarray(keys).tolist():
        h.update(str(k).encode())
        h.update(b"\x00")
    return h.hexdigest()[:12]


def expected_fingerprint(dataset, coordinate_configs, sequence,
                         reg_weights: Mapping[str, float] | None = None) -> dict:
    """This run's side of the refresh agreement: per coordinate its kind,
    feature shard and width, entity vocab (size and digest) and λ."""
    from photon_ml_torch.estimators import (
        FixedEffectCoordinateConfig,
        MatrixFactorizationCoordinateConfig,
        RandomEffectCoordinateConfig,
    )

    fp: dict = {"sequence": ",".join(sequence)}
    for cid in sequence:
        cfg = coordinate_configs[cid]
        if isinstance(cfg, FixedEffectCoordinateConfig):
            fp[f"{cid}/kind"] = "fixed"
            fp[f"{cid}/shard"] = cfg.feature_shard_id
            fp[f"{cid}/dim"] = _shard_dim(dataset.feature_shards[cfg.feature_shard_id])
        elif isinstance(cfg, RandomEffectCoordinateConfig):
            fp[f"{cid}/kind"] = "random"
            fp[f"{cid}/shard"] = cfg.feature_shard_id
            fp[f"{cid}/re_type"] = cfg.random_effect_type
            fp[f"{cid}/dim"] = _shard_dim(dataset.feature_shards[cfg.feature_shard_id])
            vocab = dataset.entity_vocabs[cfg.random_effect_type]
            fp[f"{cid}/entities"] = len(vocab)
            fp[f"{cid}/vocab"] = _vocab_digest(vocab)
        elif isinstance(cfg, MatrixFactorizationCoordinateConfig):
            fp[f"{cid}/kind"] = "matrix_factorization"
            fp[f"{cid}/re_type"] = f"{cfg.row_effect_type}x{cfg.col_effect_type}"
        if reg_weights is not None and cid in reg_weights:
            fp[f"{cid}/lambda"] = float(reg_weights[cid])
    return fp


def model_fingerprint(model: GameModel, sequence=None,
                      reg_weights: Mapping[str, float] | None = None) -> dict:
    """The resident model's side of the agreement (the keys of
    :func:`expected_fingerprint`); ``reg_weights`` from the saved model's
    metadata where known."""
    from photon_ml_torch.models.game import FixedEffectModel, RandomEffectModel
    from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel

    sequence = list(sequence if sequence is not None else model.models)
    fp: dict = {"sequence": ",".join(sequence)}
    for cid in sequence:
        m = model.models.get(cid)
        if m is None:
            continue  # the missing key shows in the comparison
        if isinstance(m, FixedEffectModel):
            fp[f"{cid}/kind"] = "fixed"
            fp[f"{cid}/shard"] = m.feature_shard_id
            fp[f"{cid}/dim"] = int(m.glm.coefficients.means.shape[0])
        elif isinstance(m, RandomEffectModel):
            fp[f"{cid}/kind"] = "random"
            fp[f"{cid}/shard"] = m.feature_shard_id
            fp[f"{cid}/re_type"] = m.random_effect_type
            fp[f"{cid}/dim"] = int(m.feature_dim if m.is_compact else m.coefficients.shape[1])
            fp[f"{cid}/entities"] = int(m.coefficients.shape[0])
            fp[f"{cid}/vocab"] = _vocab_digest(m.entity_keys)
        elif isinstance(m, MatrixFactorizationModel):
            fp[f"{cid}/kind"] = "matrix_factorization"
            fp[f"{cid}/re_type"] = f"{m.row_effect_type}x{m.col_effect_type}"
        if reg_weights is not None and cid in reg_weights:
            fp[f"{cid}/lambda"] = float(reg_weights[cid])
    return fp


def check_refresh_fingerprint(resident_fp: dict, expected_fp: dict) -> None:
    """Fail fast, naming the differing fields, when the resident model was
    trained under another layout or λ than this refresh."""
    from photon_ml_torch.io.checkpoint import fingerprint_mismatch

    mismatch = fingerprint_mismatch(resident_fp, expected_fp)
    if mismatch is not None:
        raise RefreshFingerprintError(
            "resident model is incompatible with this refresh "
            f"configuration ({mismatch}); refresh with the layout/λ-grid "
            "it was trained under, or run a full fit")


def select_refresh_entities(coord: RandomEffectCoordinate, model, extra_offsets,
                            policy: RefreshPolicy) -> tuple[np.ndarray, dict]:
    """(bool [num_entities] selection, {"changed": n, "gradient": n}): the
    declared-changed entities with the gradient-screened ones."""
    re_type = coord.re_dataset.random_effect_type
    num = int(coord.re_dataset.num_entities)
    changed = np.zeros(num, dtype=bool)
    keys = policy.changed_entities.get(re_type)
    if keys is not None and len(keys):
        vocab = np.asarray(coord.dataset.entity_vocabs[re_type])
        keys_arr = np.asarray(list(keys))
        if vocab.dtype.kind in "iu" and keys_arr.dtype.kind in "US":
            # declared keys from the command line are strings
            keys_arr = keys_arr.astype(vocab.dtype)
        elif vocab.dtype.kind in "US" and keys_arr.dtype.kind in "iu":
            keys_arr = keys_arr.astype(vocab.dtype)
        changed = np.isin(vocab, keys_arr)
        missing = np.unique(keys_arr[~np.isin(keys_arr, vocab)])
        if len(missing):
            logger.warning(
                "refresh policy declares %d changed %r entit%s not in the "
                "resident vocab (%s): nothing re-solves for them — a NEW "
                "entity needs a full fit, a typo needs fixing",
                len(missing), re_type, "y" if len(missing) == 1 else "ies",
                ", ".join(repr(str(k)) for k in missing[:5])
                + (", ..." if len(missing) > 5 else ""))
    graded = np.zeros(num, dtype=bool)
    if policy.gradient_tolerance is not None:
        norms = coord.refresh_gradient_norms(model, extra_offsets)
        # NaN: an entity in no bucket, never selected
        graded = np.nan_to_num(norms, nan=0.0) > policy.gradient_tolerance
    return changed | graded, {"changed": int(changed.sum()), "gradient": int(graded.sum())}


def run_incremental_refresh(coordinates: Mapping[str, Coordinate], sequence: Sequence[str],
                            resident_model: GameModel, policy: RefreshPolicy, *,
                            checkpointer=None, resume: bool = True, check_finite: bool = True,
                            telemetry=None, fingerprint: dict | None = None) -> RefreshResult:
    """One incremental refresh over ``sequence`` (see the module docstring).
    ``fingerprint`` rides every checkpoint and guards the resume.
    ``telemetry`` is ROADMAP.md item 19."""
    from photon_ml_torch.io.checkpoint import (
        DivergenceError,
        commit_checkpoint,
        fingerprint_mismatch,
        game_model_from_arrays,
        game_model_to_arrays,
    )
    from photon_ml_torch.resilience import recovery

    if telemetry is not None:
        from photon_ml_torch.estimators import _not_ported

        raise _not_ported("refresh telemetry (heartbeats)", 19)
    sequence = list(sequence)
    models: dict = {}
    for cid in sequence:
        if cid not in resident_model.models:
            raise RefreshFingerprintError(
                f"resident model has no coordinate '{cid}' — refresh runs "
                "under the layout the model was trained with (coordinates: "
                f"{list(resident_model.models)})")
        models[cid] = resident_model.get(cid)

    if policy.changed_entities:
        consumed = {coordinates[cid].re_dataset.random_effect_type for cid in sequence
                    if isinstance(coordinates[cid], RandomEffectCoordinate)}
        unconsumed = sorted(set(policy.changed_entities) - consumed)
        if unconsumed:
            logger.warning(
                "refresh policy declares changed entities for effect "
                "type(s) %s, but no refreshable random-effect coordinate "
                "consumes them — fixed-effect and MF coordinates carry "
                "over (entity-granular MF refresh is a ROADMAP rider)", unconsumed)

    coordinate_stats: dict = {}
    totals = {"lanes_total": 0, "lanes_solved": 0, "lanes_changed": 0, "lanes_gradient": 0}
    start_pos = 0
    if checkpointer is not None and resume:
        ckpt = checkpointer.restore()
        if ckpt is not None:
            if ckpt.meta.get("kind") != "incremental_refresh":
                raise ValueError(
                    f"checkpoint at {checkpointer.directory} is not an "
                    f"incremental-refresh checkpoint "
                    f"(kind={ckpt.meta.get('kind')!r}); use a fresh "
                    "checkpoint directory")
            saved = ckpt.meta.get("refresh", {})
            if list(saved.get("sequence", [])) != sequence:
                raise ValueError(
                    "refresh checkpoint is incompatible with this run: it "
                    f"covers coordinates {saved.get('sequence')} but the "
                    f"update sequence is {sequence}; pass resume=False or "
                    "a fresh checkpoint directory")
            if fingerprint is not None:
                mismatch = fingerprint_mismatch(saved.get("fingerprint"), fingerprint)
                if mismatch is not None:
                    raise RefreshFingerprintError(
                        f"refresh checkpoint at {checkpointer.directory} "
                        f"was written under a different agreement "
                        f"({mismatch}); resume with the original "
                        "layout/λ-grid, or use a fresh checkpoint directory")
            device = next(iter(coordinates.values())).dataset.device
            restored = game_model_from_arrays(ckpt.arrays, ckpt.meta["model"], device=device)
            models.update(restored.models)
            coordinate_stats = dict(saved.get("stats", {}))
            totals.update(saved.get("totals", {}))
            start_pos = int(saved.get("position", 0))
            recovery.counts["checkpoint_restores"] += 1
            if start_pos >= len(sequence):
                logger.warning(
                    "refresh checkpoint at %s already covers the whole "
                    "update sequence — returning the checkpointed model "
                    "WITHOUT re-reading today's data; pass resume=False "
                    "(--no-resume) or a fresh checkpoint directory to "
                    "refresh against new data", checkpointer.directory)
            logger.info("Resuming incremental refresh from coordinate %d/%d", start_pos,
                        len(sequence))

    scores = {cid: coordinates[cid].score(models[cid]) for cid in sequence}

    def full_score():
        it = iter(scores.values())
        total = next(it).clone()
        for s in it:
            total = total + s
        return total

    def commit(position: int) -> None:
        if checkpointer is None:
            return
        arrays, model_meta = game_model_to_arrays(GameModel(models=dict(models)))
        meta = {"kind": "incremental_refresh", "model": model_meta,
                "refresh": {"fingerprint": fingerprint, "position": position,
                            "sequence": sequence, "stats": coordinate_stats,
                            "totals": totals}}
        commit_checkpoint(checkpointer, position, arrays, meta)

    for position, cid in enumerate(sequence):
        if position < start_pos:
            continue  # finished before the restored checkpoint
        coord = coordinates[cid]
        if not isinstance(coord, RandomEffectCoordinate):
            if policy.refresh_fixed_effects and isinstance(coord, FixedEffectCoordinate):
                partial = full_score() - scores[cid]
                models[cid], _info = coord.update_model(models[cid], partial)
                scores[cid] = coord.score(models[cid])
                coordinate_stats[cid] = {"refreshed": True, "kind": "fe"}
            else:
                # fixed effects, MF and locked coordinates carry over (their
                # scores still anchor the residuals)
                refresh_counters.record_carried_coordinate()
                coordinate_stats[cid] = {"refreshed": False}
                commit(position + 1)
                continue
        else:
            partial = full_score() - scores[cid]
            selection, sel_stats = select_refresh_entities(coord, models[cid], partial, policy)
            coord.set_refresh_selection(selection)
            try:
                models[cid], _info = coord.update_model(models[cid], partial)
            finally:
                coord.set_refresh_selection(None)
            scores[cid] = coord.score(models[cid])
            sched = coord.last_refresh_stats
            stats = {"refreshed": True, "kind": "re", "lanes_total": int(sched.lanes_total),
                     "lanes_solved": int(sched.lanes_probed),
                     "lanes_changed": sel_stats["changed"],
                     "lanes_gradient": sel_stats["gradient"]}
            coordinate_stats[cid] = stats
            for key in totals:
                totals[key] += stats[key]
            refresh_counters.record_selection(
                lanes_total=stats["lanes_total"], lanes_solved=stats["lanes_solved"],
                lanes_changed=stats["lanes_changed"], lanes_gradient=stats["lanes_gradient"])
        if check_finite and not bool(torch.isfinite(scores[cid]).all()):
            raise DivergenceError(
                f"coordinate '{cid}' produced non-finite scores during incremental refresh"
                + (f"; last good checkpoint: step {checkpointer.latest_step()} in "
                   f"{checkpointer.directory}" if checkpointer is not None else ""))
        commit(position + 1)

    return RefreshResult(model=GameModel(models=dict(models)),
                         coordinate_stats=coordinate_stats, **totals)
