"""Carry data, normalization and models into the port from numpy arrays.

The port never imports the JAX package, so what crosses between the two
crosses as numpy: a caller holding JAX objects passes ``np.asarray`` of
their fields. Every converter takes ``device=`` with the port's policy
(CUDA unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch, device_tensor
from photon_ml_torch.data.game_data import EntityBucket, GameDataset, RandomEffectDataset
from photon_ml_torch.data.sparse_batch import SparseLabeledPointBatch
from photon_ml_torch.device import resolve_device
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_torch.ops.normalization import NormalizationContext
from photon_ml_torch.projector.projectors import ProjectorType, RandomProjectionMatrix
from photon_ml_torch.types import TaskType


def _opt_tensor(a, device) -> torch.Tensor | None:
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def batch_from_numpy(features, labels, offsets=None, weights=None, *,
                     dtype: torch.dtype | None = None, device=None) -> LabeledPointBatch:
    """A LabeledPointBatch from numpy columns (``dtype=None`` keeps the
    features' dtype; ``torch.bfloat16`` rounds the feature block)."""
    return LabeledPointBatch.create(np.asarray(features), np.asarray(labels),
                                    None if offsets is None else np.asarray(offsets),
                                    None if weights is None else np.asarray(weights),
                                    dtype=dtype, device=device)


def sparse_batch_from_numpy(rows, cols, vals, labels, *, dim: int, offsets=None, weights=None,
                            dtype: torch.dtype | None = None, ell="auto", hybrid=None,
                            column_sorted_gradient: bool = False,
                            device=None) -> SparseLabeledPointBatch:
    """A SparseLabeledPointBatch from numpy COO triples, built like the JAX
    package's ``from_coo`` (``dtype=None`` keeps the values' float dtype;
    ``torch.bfloat16`` rounds them)."""
    vals = np.asarray(vals)
    if dtype is None:
        dtype = torch.from_numpy(vals[:0]).dtype
    return SparseLabeledPointBatch.from_coo(
        np.asarray(rows), np.asarray(cols), vals, np.asarray(labels), dim=dim,
        offsets=None if offsets is None else np.asarray(offsets),
        weights=None if weights is None else np.asarray(weights), dtype=dtype, ell=ell,
        hybrid=hybrid, column_sorted_gradient=column_sorted_gradient, device=device)


def normalization_from_numpy(factors, shifts, *, device=None) -> NormalizationContext:
    """A NormalizationContext from numpy factors/shifts (None = identity)."""
    device = resolve_device(device)
    return NormalizationContext(factors=_opt_tensor(factors, device),
                                shifts=_opt_tensor(shifts, device))


def coefficients_from_numpy(means, variances=None, *, device=None) -> Coefficients:
    device = resolve_device(device)
    return Coefficients(means=_opt_tensor(means, device),
                        variances=_opt_tensor(variances, device))


def glm_from_numpy(means, variances, task, *, device=None) -> GeneralizedLinearModel:
    """A GeneralizedLinearModel; ``task`` is a TaskType, its name, or any
    enum whose value is the name."""
    return GeneralizedLinearModel(coefficients_from_numpy(means, variances, device=device),
                                  _task(task))


def _task(task) -> TaskType:
    return task if isinstance(task, TaskType) else TaskType(getattr(task, "value", task))


def game_dataset_from_numpy(*, unique_ids, labels, offsets, weights, feature_shards,
                            entity_idx, entity_vocabs, ids=None, device=None) -> GameDataset:
    """A GameDataset from the fields of another package's dataset as numpy
    arrays: dense [n, d] shards (a bf16 shard passes as float32 values and
    ``torch.bfloat16`` is not restored), [n] int entity indices, key vocabs."""
    device = resolve_device(device)
    # copies: the arrays of another framework may be read-only views
    host = {"labels": np.array(labels), "offsets": np.array(offsets),
            "weights": np.array(weights)}
    shards = {}
    for k, v in feature_shards.items():
        host[f"shard/{k}"] = np.array(v)
        shards[k] = device_tensor(host[f"shard/{k}"], None, device)
    idx = {}
    for t, v in entity_idx.items():
        host[f"entity_idx/{t}"] = np.asarray(v).astype(np.int32)
        idx[t] = device_tensor(host[f"entity_idx/{t}"], torch.int32, device)
    return GameDataset(
        unique_ids=np.asarray(unique_ids),
        labels=device_tensor(host["labels"], None, device),
        offsets=device_tensor(host["offsets"], None, device),
        weights=device_tensor(host["weights"], None, device),
        feature_shards=shards, entity_idx=idx,
        entity_vocabs={t: np.asarray(v) for t, v in entity_vocabs.items()},
        ids={k: np.asarray(v) for k, v in (ids or {}).items()}, host_cache=host)


def random_effect_dataset_from_numpy(*, random_effect_type: str, feature_shard_id: str, buckets,
                                     num_entities: int, dim: int, projector_type="IDENTITY",
                                     projection_matrix=None, pre_normalized: bool = False,
                                     active_cols=None, device=None) -> RandomEffectDataset:
    """A RandomEffectDataset from bucket fields as numpy arrays: ``buckets``
    is a sequence of mappings with features [e, cap, k], labels, weights
    [e, cap], entity_rows [e], sample_rows [e, cap] and, for INDEX_MAP,
    col_index [e, k]. ``projector_type`` is a ProjectorType, its name, or an
    enum whose value is the name; ``projection_matrix`` is RANDOM's [d, k];
    ``active_cols`` [E, K] makes the dataset compact."""
    device = resolve_device(device)
    out = []
    for b in buckets:
        col_index = b.get("col_index")
        out.append(EntityBucket(
            features=device_tensor(np.array(b["features"]), None, device),
            labels=device_tensor(np.array(b["labels"]), None, device),
            weights=device_tensor(np.array(b["weights"]), None, device),
            entity_rows=device_tensor(np.array(b["entity_rows"]), torch.int32, device),
            sample_rows=device_tensor(np.array(b["sample_rows"]), torch.int32, device),
            col_index=None if col_index is None
            else device_tensor(np.array(col_index), torch.int32, device)))
    projection = None if projection_matrix is None \
        else RandomProjectionMatrix(matrix=np.array(projection_matrix))
    return RandomEffectDataset(random_effect_type=random_effect_type,
                               feature_shard_id=feature_shard_id, buckets=out,
                               num_entities=int(num_entities), dim=int(dim),
                               projector_type=ProjectorType(
                                   getattr(projector_type, "value", projector_type)),
                               projection=projection, pre_normalized=bool(pre_normalized),
                               active_cols=None if active_cols is None
                               else np.asarray(active_cols, dtype=np.int32))


def game_model_from_numpy(models, *, device=None) -> GameModel:
    """A GameModel from an ordered mapping coordinate id -> plain values: a
    fixed effect is ``{"kind": "fixed", "means", "variances", "task",
    "feature_shard_id"}``, a random effect ``{"kind": "random",
    "coefficients", "variances", "entity_keys", "random_effect_type",
    "feature_shard_id", "task"}``, plus ``"active_cols"`` and ``"feature_dim"``
    for a compact one, a matrix factorization ``{"kind": "matrix_factorization",
    "row_factors", "col_factors", "row_effect_type", "col_effect_type",
    "row_keys", "col_keys", "task"}``."""
    device = resolve_device(device)
    out = {}
    for cid, m in models.items():
        if m["kind"] == "fixed":
            out[cid] = FixedEffectModel(
                glm=glm_from_numpy(m["means"], m.get("variances"), m["task"], device=device),
                feature_shard_id=m["feature_shard_id"])
        elif m["kind"] == "random":
            out[cid] = RandomEffectModel(
                coefficients=_opt_tensor(m["coefficients"], device),
                variances=_opt_tensor(m.get("variances"), device),
                entity_keys=np.asarray(m["entity_keys"]),
                random_effect_type=m["random_effect_type"],
                feature_shard_id=m["feature_shard_id"], task=_task(m["task"]),
                active_cols=None if m.get("active_cols") is None
                else np.asarray(m["active_cols"], dtype=np.int32),
                feature_dim=m.get("feature_dim"))
        elif m["kind"] == "matrix_factorization":
            out[cid] = MatrixFactorizationModel(
                row_factors=_opt_tensor(m["row_factors"], device),
                col_factors=_opt_tensor(m["col_factors"], device),
                row_effect_type=m["row_effect_type"], col_effect_type=m["col_effect_type"],
                row_keys=np.asarray(m["row_keys"]), col_keys=np.asarray(m["col_keys"]),
                task=_task(m["task"]))
        else:
            raise ValueError(f"coordinate '{cid}': unknown model kind {m['kind']!r}")
    return GameModel(models=out)


def game_model_to_numpy(model: GameModel) -> dict:
    """The inverse of :func:`game_model_from_numpy`: numpy arrays and plain
    Python values (task names as strings)."""

    def arr(t):
        return None if t is None else t.detach().cpu().numpy()

    out = {}
    for cid, m in model.models.items():
        if isinstance(m, FixedEffectModel):
            out[cid] = {"kind": "fixed", "means": arr(m.glm.coefficients.means),
                        "variances": arr(m.glm.coefficients.variances), "task": m.task.value,
                        "feature_shard_id": m.feature_shard_id}
        elif isinstance(m, RandomEffectModel):
            out[cid] = {"kind": "random", "coefficients": arr(m.coefficients),
                        "variances": arr(m.variances), "entity_keys": np.asarray(m.entity_keys),
                        "random_effect_type": m.random_effect_type,
                        "feature_shard_id": m.feature_shard_id, "task": m.task.value}
            if m.is_compact:
                out[cid].update(active_cols=np.asarray(m.active_cols),
                                feature_dim=int(m.feature_dim))
        elif isinstance(m, MatrixFactorizationModel):
            out[cid] = {"kind": "matrix_factorization", "row_factors": arr(m.row_factors),
                        "col_factors": arr(m.col_factors), "row_effect_type": m.row_effect_type,
                        "col_effect_type": m.col_effect_type, "row_keys": np.asarray(m.row_keys),
                        "col_keys": np.asarray(m.col_keys), "task": m.task.value}
        else:
            raise TypeError(f"coordinate '{cid}': cannot convert {type(m).__name__}")
    return out
