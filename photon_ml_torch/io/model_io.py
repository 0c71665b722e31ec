"""GAME model persistence in the reference's on-disk layout (the port's copy).

Counterpart of ``photon_ml_tpu/io/model_io.py``, writing the same bytes: a
model saved by either package loads in the other. Reference parity:
photon-client data/avro/ModelProcessingUtils.scala — save (:75-128) / load
(:141-254) of:

    <dir>/model-metadata.json                      {"modelType": ..., ...}
    <dir>/fixed-effect/<name>/id-info              [featureShardId]
    <dir>/fixed-effect/<name>/coefficients/*.avro  BayesianLinearModelAvro
    <dir>/random-effect/<name>/id-info             [reType, featureShardId]
    <dir>/random-effect/<name>/coefficients/*.avro one record per entity

plus the text model writer (photon-client util/IOUtils writeModelsInText),
the feature-stats writer (:515-586, FeatureSummarizationResultAvro), and the
score writer (ScoreProcessingUtils.scala, ScoringResultAvro).

Coefficients leave the device as numpy arrays of the tensor's own dtype
(f32 values are written as the doubles they are), so the Avro bytes match
the JAX package's for the same model. Matrix-factorization coordinates are
not ported (ROADMAP.md item 13).
"""

from __future__ import annotations

import io
import json
import logging
import os
from typing import Iterable, Mapping

import numpy as np
import torch

from photon_ml_torch.device import resolve_device
from photon_ml_torch.io import avro as avro_io
from photon_ml_torch.io import photon_schemas as schemas
from photon_ml_torch.io.index_map import IndexMap, feature_key, split_feature_key
from photon_ml_torch.models.coefficients import Coefficients
from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_torch.models.glm import GeneralizedLinearModel
from photon_ml_torch.types import TaskType

logger = logging.getLogger(__name__)


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array of its own dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
MATRIX_FACTORIZATION = "matrix-factorization"
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"
METADATA_FILE = "model-metadata.json"

#: Default sparsity threshold below which coefficients are not persisted
#: (reference VectorUtils.DEFAULT_SPARSITY_THRESHOLD).
DEFAULT_SPARSITY_THRESHOLD = 1e-4

#: Random-effect coordinates whose feature space exceeds this load as
#: compact per-entity tables (the ONE default shared by the library loaders
#: and both CLI drivers — keep them from drifting).
DEFAULT_COMPACT_RE_THRESHOLD = 1_000_000

#: JVM class names used in the modelClass field, for interchange with the
#: reference's loader (supervised/model hierarchy).
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
_CLASS_TO_TASK = {v: k for k, v in _MODEL_CLASS.items()}


def _coefficients_to_name_term_values(
    means: np.ndarray, index_map: IndexMap, threshold: float
) -> list[dict]:
    out = []
    for j, v in enumerate(means):
        if abs(v) >= threshold or threshold == 0.0:
            key = index_map.get_feature_name(j)
            if key is None:
                continue
            name, term = split_feature_key(key)
            out.append({"name": name, "term": term, "value": float(v)})
    return out


def _compact_row_to_record(
    model_id: str,
    values: np.ndarray,  # [K]
    cols: np.ndarray,  # [K] global columns, pad = dim
    var_row: np.ndarray | None,
    task,
    index_map: IndexMap,
    threshold: float,
    dim: int,
) -> dict:
    """One compact (giant-d_re) entity row as the standard per-feature
    name-term-value record — on disk it matches a dense row exactly."""
    def ntv(vals: np.ndarray, thr: float) -> list[dict]:
        out = []
        for j, v in zip(cols.tolist(), np.asarray(vals).tolist()):
            if j >= dim or (thr != 0.0 and abs(v) < thr):
                continue
            key = index_map.get_feature_name(int(j))
            if key is None:
                continue
            name, term = split_feature_key(key)
            out.append({"name": name, "term": term, "value": float(v)})
        return out

    return {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS.get(task),
        "means": ntv(values, threshold),
        "variances": None if var_row is None else ntv(var_row, 0.0),
        "lossFunction": None,
    }


def _glm_to_record(
    model_id: str,
    glm: GeneralizedLinearModel,
    index_map: IndexMap,
    threshold: float,
) -> dict:
    means = _host(glm.coefficients.means)
    record = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS.get(glm.task),
        "means": _coefficients_to_name_term_values(means, index_map, threshold),
        "variances": None,
        "lossFunction": None,
    }
    if glm.coefficients.variances is not None:
        record["variances"] = _coefficients_to_name_term_values(
            _host(glm.coefficients.variances), index_map, 0.0
        )
    return record


def _coordinate_dirs(base: str) -> list[str]:
    """Coordinate subdirectory names under a fixed-effect/random-effect/
    matrix-factorization level, skipping stray files and Spark/OS markers
    (_SUCCESS, .crc, .DS_Store) that a reference-written directory may hold."""
    return sorted(
        name
        for name in os.listdir(base)
        if os.path.isdir(os.path.join(base, name))
        and not name.startswith(("_", "."))
    )


def _read_id_info(base: str, n_lines: int) -> list[str]:
    """Read ``<base>/id-info`` and require at least ``n_lines`` lines,
    raising an error that names the malformed coordinate directory."""
    with open(os.path.join(base, ID_INFO)) as f:
        lines = f.read().strip().splitlines()
    if len(lines) < n_lines:
        raise ValueError(
            f"malformed id-info in '{base}': expected at least {n_lines} "
            f"line(s), got {len(lines)}"
        )
    return lines


def _has_part_files(directory: str) -> bool:
    """True if the directory holds at least one .avro part file (Spark may
    leave empty dirs with only _SUCCESS markers for untrained coordinates).
    Same filter as avro.read_directory, so emptiness test and reader agree."""
    return os.path.isdir(directory) and any(
        f.endswith(".avro") and not f.startswith(("_", "."))
        for f in os.listdir(directory)
    )


def _write_chunked(
    directory: str, schema: dict, records: Iterable[dict], per_file: int
) -> None:
    """Write records into part-NNNNN.avro files of at most per_file records
    (reference randomEffectModelFileLimit). Always emits at least one
    (possibly empty) part file so the directory stays readable."""
    it = iter(records)
    part = 0
    while True:
        chunk = []
        for record in it:
            chunk.append(record)
            if len(chunk) >= per_file:
                break
        if not chunk and part > 0:
            break
        avro_io.write_container(
            os.path.join(directory, f"part-{part:05d}.avro"), schema, chunk
        )
        part += 1
        if len(chunk) < per_file:
            break


def _load_compact_random_effect(
    records: list[dict], re_type: str, shard_id: str,
    index_map: IndexMap, task, dtype, device,
) -> RandomEffectModel:
    """Decode per-entity records into the compact [E, K] layout (sorted
    active global columns per entity; K = widest entity; pad = dim)."""
    dim = index_map.size
    keys = sorted(r["modelId"] for r in records)
    row = {k: i for i, k in enumerate(keys)}
    per_entity: list[tuple[np.ndarray, np.ndarray, np.ndarray | None]] = [
        (np.zeros(0, np.int64), np.zeros(0, dtype), None)
    ] * len(keys)
    model_task = task
    any_var = False
    for record in records:
        cols, vals = [], []
        for ntv in record["means"]:
            j = index_map.get_index(
                feature_key(ntv["name"], ntv.get("term") or "")
            )
            if j >= 0:
                cols.append(j)
                vals.append(ntv["value"])
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        order = np.argsort(cols)
        cols, vals = cols[order], vals[order]
        var = None
        if record.get("variances"):
            vmap = {}
            for ntv in record["variances"]:
                j = index_map.get_index(
                    feature_key(ntv["name"], ntv.get("term") or "")
                )
                if j >= 0:
                    vmap[j] = ntv["value"]
            # unlisted active columns default to 0.0, matching the dense
            # loader (_record_to_arrays); NaN stays reserved for pad
            # slots / entities without the field
            var = np.asarray([vmap.get(int(c), 0.0) for c in cols], dtype)
            any_var = True
        per_entity[row[record["modelId"]]] = (cols, vals, var)
        model_task = _CLASS_TO_TASK.get(record.get("modelClass"), model_task)
    k_width = max((len(c) for c, _, _ in per_entity), default=0) or 1
    e = len(keys)
    active = np.full((e, k_width), dim, dtype=np.int32)
    table = np.zeros((e, k_width), dtype=dtype)
    var_table = np.full((e, k_width), np.nan, dtype=dtype) if any_var else None
    for i, (cols, vals, var) in enumerate(per_entity):
        active[i, : len(cols)] = cols
        table[i, : len(cols)] = vals
        if var is not None:
            var_table[i, : len(cols)] = var
    return RandomEffectModel(
        coefficients=torch.from_numpy(table).to(device),
        entity_keys=np.asarray(keys),
        random_effect_type=re_type,
        feature_shard_id=shard_id,
        task=model_task,
        variances=None if var_table is None else torch.from_numpy(var_table).to(device),
        active_cols=active,
        feature_dim=dim,
    )


def _record_to_arrays(record: dict, index_map: IndexMap, dtype):
    """(means [d], variances [d] or None) of one record as numpy arrays."""
    d = index_map.size
    means = np.zeros((d,), dtype=dtype)
    # `or ""`: a null term must map to the empty term, matching
    # index_maps_from_model's key harvesting
    for ntv in record["means"]:
        j = index_map.get_index(feature_key(ntv["name"], ntv.get("term") or ""))
        if j >= 0:
            means[j] = ntv["value"]
    variances = None
    if record.get("variances"):
        variances = np.zeros((d,), dtype=dtype)
        for ntv in record["variances"]:
            j = index_map.get_index(feature_key(ntv["name"], ntv.get("term") or ""))
            if j >= 0:
                variances[j] = ntv["value"]
    return means, variances


def save_game_model(
    output_dir: str | os.PathLike,
    game_model: GameModel,
    index_maps: Mapping[str, IndexMap],
    *,
    optimization_configurations: dict | None = None,
    sparsity_threshold: float = DEFAULT_SPARSITY_THRESHOLD,
    random_effect_records_per_file: int = 65536,
) -> None:
    """Save a GAME model in the reference directory layout."""
    output_dir = str(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    task = game_model.task
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump(
            {
                "modelType": task.value,
                "optimizationConfigurations": optimization_configurations or {},
            },
            f,
            indent=2,
        )

    for name, model in game_model.models.items():
        if isinstance(model, FixedEffectModel):
            base = os.path.join(output_dir, FIXED_EFFECT, name)
            os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(base, ID_INFO), "w") as f:
                f.write(model.feature_shard_id + "\n")
            index_map = index_maps[model.feature_shard_id]
            avro_io.write_container(
                os.path.join(base, COEFFICIENTS, "part-00000.avro"),
                schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                [_glm_to_record(name, model.glm, index_map, sparsity_threshold)],
            )
        elif isinstance(model, RandomEffectModel):
            base = os.path.join(output_dir, RANDOM_EFFECT, name)
            os.makedirs(os.path.join(base, COEFFICIENTS), exist_ok=True)
            with open(os.path.join(base, ID_INFO), "w") as f:
                f.write(model.random_effect_type + "\n")
                f.write(model.feature_shard_id + "\n")
            index_map = index_maps[model.feature_shard_id]
            table = _host(model.coefficients)
            var_table = _host(model.variances) if model.variances is not None else None
            keys = [str(k) for k in np.asarray(model.entity_keys).tolist()]
            active_cols = (
                np.asarray(model.active_cols)
                if model.active_cols is not None else None
            )

            def records() -> Iterable[dict]:
                for i, key in enumerate(keys):
                    # NaN rows mark "no variance computed" for this entity
                    # (e.g. below active_data_lower_bound) — drop the field
                    # rather than persist a false number. Compact rows check
                    # only the ACTIVE slots (their pad slots are NaN by
                    # construction and are never written to disk anyway).
                    var_row = None
                    if var_table is not None:
                        if active_cols is not None:
                            live = active_cols[i] < model.dim
                            finite = bool(
                                np.all(np.isfinite(var_table[i][live]))
                            ) if live.any() else False
                        else:
                            finite = bool(np.all(np.isfinite(var_table[i])))
                        if finite:
                            var_row = var_table[i]
                    if active_cols is not None:
                        # compact rows: table slot j is GLOBAL column
                        # active_cols[i, j]; the wire format is already
                        # per-feature name-term-value, so compact and dense
                        # models are indistinguishable on disk
                        yield _compact_row_to_record(
                            key, table[i], active_cols[i], var_row,
                            model.task, index_map, sparsity_threshold,
                            model.dim,
                        )
                        continue
                    glm = GeneralizedLinearModel(
                        Coefficients(means=table[i], variances=var_row),
                        model.task,
                    )
                    yield _glm_to_record(key, glm, index_map, sparsity_threshold)

            _write_chunked(
                os.path.join(base, COEFFICIENTS),
                schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                records(),
                random_effect_records_per_file,
            )
        else:
            raise TypeError(f"cannot save coordinate '{name}' of type {type(model)}")


def load_game_model(
    models_dir: str | os.PathLike,
    index_maps: Mapping[str, IndexMap] | None = None,
    *,
    coordinates_to_load: set[str] | None = None,
    dtype=np.float32,
    compact_random_effect_threshold: int = DEFAULT_COMPACT_RE_THRESHOLD,
    device=None,
) -> GameModel:
    """Load a GAME model saved in the reference layout onto ``device`` (CUDA
    unless "cpu"); ``dtype`` is the tables' numpy dtype.

    ``index_maps=None`` reconstructs per-shard index maps from the model's
    own coefficient records in the same pass (each part file is decoded
    exactly once; the keys come from the cached records rather than a
    second read) — the way to load a reference-written model whose index
    stores are JVM-only PalDB.
    """
    return load_game_model_and_index_maps(
        models_dir, index_maps,
        coordinates_to_load=coordinates_to_load, dtype=dtype,
        compact_random_effect_threshold=compact_random_effect_threshold, device=device,
    )[0]


def load_game_model_and_index_maps(
    models_dir: str | os.PathLike,
    index_maps: Mapping[str, IndexMap] | None = None,
    *,
    coordinates_to_load: set[str] | None = None,
    dtype=np.float32,
    compact_random_effect_threshold: int = DEFAULT_COMPACT_RE_THRESHOLD,
    device=None,
) -> tuple[GameModel, dict[str, IndexMap]]:
    """Like :func:`load_game_model` but also returns the index maps in use —
    callers that need the maps afterwards (e.g. to read scoring data in the
    model's feature space) avoid a second decode pass."""
    device = resolve_device(device)
    models_dir = str(models_dir)
    if os.path.isdir(os.path.join(models_dir, MATRIX_FACTORIZATION)):
        raise NotImplementedError(
            f"{models_dir} holds matrix-factorization coordinates, which are not "
            "ported yet: ROADMAP.md item 13")

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)
    meta_path = os.path.join(models_dir, METADATA_FILE)
    task = TaskType.NONE
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        task = TaskType(meta.get("modelType", "NONE"))

    record_cache: dict[str, list[dict]] = {}

    def read_records(coeff_dir: str) -> list[dict]:
        if coeff_dir not in record_cache:
            record_cache[coeff_dir] = list(avro_io.read_directory(coeff_dir))
        return record_cache[coeff_dir]

    if index_maps is None:
        # single pass: decode every coordinate's records once (cached for
        # the table-filling loops below) and harvest per-shard feature keys
        index_maps = _harvest_index_maps(models_dir, read_records)

    models: dict[str, object] = {}

    fe_dir = os.path.join(models_dir, FIXED_EFFECT)
    if os.path.isdir(fe_dir):
        for name in _coordinate_dirs(fe_dir):
            if coordinates_to_load is not None and name not in coordinates_to_load:
                continue
            base = os.path.join(fe_dir, name)
            shard_id = _read_id_info(base, 1)[0]
            if shard_id not in index_maps:
                raise ValueError(
                    f"missing feature shard definition '{shard_id}' for coordinate '{name}'"
                )
            index_map = index_maps[shard_id]
            records = read_records(os.path.join(base, COEFFICIENTS))
            if len(records) != 1:
                raise ValueError(f"expected 1 fixed-effect record for '{name}', got {len(records)}")
            record = records[0]
            model_task = _CLASS_TO_TASK.get(record.get("modelClass"), task)
            means, variances = _record_to_arrays(record, index_map, dtype)
            glm = GeneralizedLinearModel(
                Coefficients(means=tensor(means),
                             variances=None if variances is None else tensor(variances)),
                model_task,
            )
            models[name] = FixedEffectModel(glm=glm, feature_shard_id=shard_id)

    re_dir = os.path.join(models_dir, RANDOM_EFFECT)
    if os.path.isdir(re_dir):
        for name in _coordinate_dirs(re_dir):
            if coordinates_to_load is not None and name not in coordinates_to_load:
                continue
            base = os.path.join(re_dir, name)
            lines = _read_id_info(base, 2)
            re_type, shard_id = lines[0], lines[1]
            if shard_id not in index_maps:
                raise ValueError(
                    f"missing feature shard definition '{shard_id}' for coordinate '{name}'"
                )
            index_map = index_maps[shard_id]
            coeff_dir = os.path.join(base, COEFFICIENTS)
            if not _has_part_files(coeff_dir):
                # a random-effect coordinate with no trained entities (seen
                # in reference fixtures): empty table, still scorable (every
                # entity is "unseen" and scores 0)
                logger.warning(
                    "random-effect coordinate '%s' has no coefficients "
                    "directory; loading as an empty (0-entity) model", name,
                )
                models[name] = RandomEffectModel(
                    coefficients=tensor(np.zeros((0, index_map.size), dtype=dtype)),
                    entity_keys=np.asarray([], dtype=str),
                    random_effect_type=re_type,
                    feature_shard_id=shard_id,
                    task=task,
                )
                continue
            records = read_records(coeff_dir)
            if index_map.size > compact_random_effect_threshold:
                # giant-d_re coordinate: never materialize [E, dim] — load
                # straight into the compact [E, K] active-column layout
                models[name] = _load_compact_random_effect(
                    records, re_type, shard_id, index_map, task, dtype, device
                )
                continue
            keys = sorted(r["modelId"] for r in records)
            row = {k: i for i, k in enumerate(keys)}
            table = np.zeros((len(keys), index_map.size), dtype=dtype)
            var_table = None
            model_task = task
            for record in records:
                means, variances = _record_to_arrays(record, index_map, dtype)
                table[row[record["modelId"]]] = means
                if variances is not None:
                    if var_table is None:
                        # NaN = "record carried no variances": keeps entities
                        # without the field distinguishable from genuinely
                        # tiny variances
                        var_table = np.full_like(table, np.nan)
                    var_table[row[record["modelId"]]] = variances
                model_task = _CLASS_TO_TASK.get(record.get("modelClass"), model_task)
            models[name] = RandomEffectModel(
                coefficients=tensor(table),
                entity_keys=np.asarray(keys),
                random_effect_type=re_type,
                feature_shard_id=shard_id,
                task=model_task,
                variances=None if var_table is None else tensor(var_table),
            )

    if not models:
        raise ValueError(f"No models could be loaded from given path: {models_dir}")
    return GameModel(models=models), dict(index_maps)


def _harvest_index_maps(models_dir: str, read_records) -> dict[str, IndexMap]:
    """Per-shard index maps from a model's own coefficient records
    (``read_records(coeff_dir) -> list[dict]`` supplies/caches decoding)."""
    keys_per_shard: dict[str, set[str]] = {}

    def scan(base: str, shard_line: int) -> None:
        if not os.path.isdir(base):
            return
        for name in _coordinate_dirs(base):
            sub = os.path.join(base, name)
            shard_id = _read_id_info(sub, shard_line + 1)[shard_line]
            keys = keys_per_shard.setdefault(shard_id, set())
            coeff_dir = os.path.join(sub, COEFFICIENTS)
            if not _has_part_files(coeff_dir):
                continue  # empty coordinate (seen in reference fixtures)
            for record in read_records(coeff_dir):
                for field in ("means", "variances"):
                    for ntv in record.get(field) or ():
                        keys.add(feature_key(ntv["name"], ntv.get("term") or ""))

    scan(os.path.join(models_dir, FIXED_EFFECT), 0)
    scan(os.path.join(models_dir, RANDOM_EFFECT), 1)
    return {
        shard: IndexMap.from_keys(keys, add_intercept=False)
        for shard, keys in keys_per_shard.items()
    }


def index_maps_from_model(
    models_dir: str | os.PathLike,
) -> dict[str, IndexMap]:
    """Reconstruct per-shard index maps from a saved model's own coefficient
    records (name/term keys).

    The reference persists its index maps as PalDB stores, which only the
    JVM can read; the model files themselves carry every feature key, so a
    reference-written model directory becomes loadable without its stores.
    Column order follows IndexMap.from_keys (sorted), which both loaders
    use consistently. (``load_game_model(dir)`` with no maps does this in
    the same decode pass as the load itself.)
    """
    return _harvest_index_maps(
        str(models_dir), lambda d: avro_io.read_directory(d)
    )


def write_glm_text(
    path: str | os.PathLike,
    models: Mapping[float, GeneralizedLinearModel],
    index_map: IndexMap,
) -> None:
    """Per-λ text model dump (reference IOUtils.writeModelsInText: one file
    per regularization weight, 'name\\tterm\\tvalue' lines)."""
    os.makedirs(path, exist_ok=True)
    for lam, glm in models.items():
        means = _host(glm.coefficients.means)
        with open(os.path.join(str(path), f"{lam}.txt"), "w", encoding="utf-8") as f:
            for j in np.argsort(-np.abs(means)):
                key = index_map.get_feature_name(int(j))
                if key is None:
                    continue
                name, term = split_feature_key(key)
                f.write(f"{name}\t{term}\t{float(means[j])!r}\n")


def write_feature_stats(
    path: str | os.PathLike,
    stats: Mapping[str, np.ndarray],
    index_map: IndexMap,
) -> None:
    """Feature summary as FeatureSummarizationResultAvro (reference
    ModelProcessingUtils.writeBasicStatistics:515-586)."""
    metrics_per_feature = {}
    d = index_map.size
    for metric, values in stats.items():
        arr = np.asarray(values)
        if arr.ndim == 1 and arr.shape[0] == d:
            metrics_per_feature[metric] = arr

    def records():
        for j in range(d):
            key = index_map.get_feature_name(j)
            if key is None:
                continue
            name, term = split_feature_key(key)
            yield {
                "featureName": name,
                "featureTerm": term,
                "metrics": {m: float(v[j]) for m, v in metrics_per_feature.items()},
            }

    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    avro_io.write_container(path, schemas.FEATURE_SUMMARIZATION_RESULT_AVRO, records())


def write_scores(
    path: str | os.PathLike,
    scores: np.ndarray,
    *,
    model_id: str = "",
    uids: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    records_per_file: int | None = None,
) -> None:
    """Scored-item output as ScoringResultAvro (reference
    ScoreProcessingUtils.saveScoredItemsToHDFS).

    ``records_per_file``: when set, ``path`` is treated as a directory and
    scores split into part-NNNNN.avro files (the reference's partitioned
    score output)."""
    n = len(scores)

    def records():
        for i in range(n):
            yield {
                "uid": None if uids is None else str(uids[i]),
                "label": None if labels is None else float(labels[i]),
                "modelId": model_id,
                "predictionScore": float(scores[i]),
                "weight": None if weights is None else float(weights[i]),
                "metadataMap": None,
            }

    encoded = _encode_score_blocks(
        scores, model_id, uids, labels, weights
    )
    if records_per_file is not None:
        os.makedirs(str(path), exist_ok=True)
        if encoded is not None:
            for part, lo in enumerate(range(0, n, records_per_file)):
                chunk = encoded[lo:lo + records_per_file]
                avro_io.write_container_blocks(
                    os.path.join(str(path), f"part-{part:05d}.avro"),
                    schemas.SCORING_RESULT_AVRO,
                    [(len(chunk), chunk.tobytes())],
                )
            if n == 0:  # keep the directory readable, like _write_chunked
                avro_io.write_container(
                    os.path.join(str(path), "part-00000.avro"),
                    schemas.SCORING_RESULT_AVRO, [],
                )
            return
        _write_chunked(
            str(path), schemas.SCORING_RESULT_AVRO, records(), records_per_file
        )
        return
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    if encoded is not None:
        # an empty block list still writes a valid header-only container
        avro_io.write_container_blocks(
            path, schemas.SCORING_RESULT_AVRO,
            [(n, encoded.tobytes())] if n else [],
        )
        return
    avro_io.write_container(path, schemas.SCORING_RESULT_AVRO, records())


def _encode_score_blocks(
    scores: np.ndarray,
    model_id: str,
    uids: np.ndarray | None,
    labels: np.ndarray | None,
    weights: np.ndarray | None,
):
    """Vectorized Avro-binary encoding of ScoringResultAvro records.

    The schema is fixed and flat, so the whole record stream assembles as
    numpy byte scatters (~20x the per-record BinaryEncoder — the write-side
    analogue of the native reader; pure numpy, no compiler needed). Returns
    a sliceable per-record object (numpy array of VOID rows is unsuitable
    because uid lengths vary, so this returns a `_RaggedBytes` with
    per-record boundaries), or None when the inputs are outside the fast
    subset (non-ASCII or >8 KB uids).
    """
    n = len(scores)
    if n == 0:
        return _RaggedBytes(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    scores = np.ascontiguousarray(scores, dtype="<f8")

    # ---- uid segment (the only variable-width part)
    if uids is not None:
        u = np.asarray(uids)
        if u.dtype.kind in "iu" and (u >= 0).all():
            # vectorized decimal digits (numpy's int->str astype is the
            # profile's hot spot): RIGHT-aligned [n, maxlen] digit matrix.
            # Digit count via exact integer thresholds — float64 log10
            # overcounts just below powers of ten beyond 2^53
            pow10 = np.array([10 ** k for k in range(1, 19)], dtype=np.uint64)
            ulen = (
                np.searchsorted(pow10, u.astype(np.uint64), side="right") + 1
            ).astype(np.int64)
            width = int(ulen.max())
            ub_bytes = (
                (u[:, None] // 10 ** np.arange(width - 1, -1, -1, dtype=u.dtype))
                % 10
            ).astype(np.uint8) + ord("0")
            right_aligned = True
        elif u.dtype.kind == "S" or (
            u.dtype == object and any(isinstance(x, bytes) for x in u)
        ):
            return None  # str(bytes) renders the b'...' repr — generic's job
        else:
            ustr = u.astype("U") if u.dtype.kind != "U" else u
            try:
                ub = ustr.astype("S")  # ASCII-only fast encode
            except UnicodeEncodeError:
                return None
            ulen = np.char.str_len(ustr).astype(np.int64)
            ub_bytes = ub.view(np.uint8).reshape(n, -1)
            right_aligned = False
        if (ulen >= 8192).any():
            return None  # >2-byte varint lengths: generic writer's job
        two = ulen >= 64  # zigzag(len) needs 2 varint bytes
        uid_seg = 1 + 1 + two.astype(np.int64) + ulen  # tag + varint + bytes
    else:
        ulen = np.zeros(n, np.int64)
        two = np.zeros(n, bool)
        uid_seg = np.ones(n, np.int64)  # null tag only

    mid = model_id.encode("utf-8")
    buf = io.BytesIO()
    avro_io.write_long(buf, len(mid))
    mid_prefix = buf.getvalue() + mid
    tail = (
        (9 if labels is not None else 1)
        + len(mid_prefix) + 8
        + (9 if weights is not None else 1)
        + 1
    )
    sizes = uid_seg + tail
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    out = np.zeros(int(starts[-1]), dtype=np.uint8)

    # uid union tag + varint + bytes
    if uids is not None:
        out[starts[:-1]] = 2  # union branch 1 (string)
        z = ulen * 2  # zigzag
        out[starts[:-1] + 1] = np.where(two, (z & 0x7F) | 0x80, z)
        p2 = starts[:-1][two] + 2
        out[p2] = (ulen[two] * 2) >> 7
        # ragged scatter of the uid bytes
        width = ub_bytes.shape[1]
        if width:
            uid_start = starts[:-1] + 2 + two.astype(np.int64)
            total = int(ulen.sum())
            rows = np.repeat(np.arange(n), ulen)
            intra = np.arange(total) - np.repeat(np.cumsum(ulen) - ulen, ulen)
            src_col = intra + (width - ulen[rows] if right_aligned else 0)
            out[np.repeat(uid_start, ulen) + intra] = ub_bytes[rows, src_col]
    # fixed tail as one [n, tail] byte matrix
    tail_mat = np.zeros((n, tail), dtype=np.uint8)
    pos = 0
    if labels is not None:
        tail_mat[:, 0] = 2
        tail_mat[:, 1:9] = (
            np.ascontiguousarray(labels, "<f8").view(np.uint8).reshape(n, 8)
        )
        pos = 9
    else:
        pos = 1
    tail_mat[:, pos:pos + len(mid_prefix)] = np.frombuffer(mid_prefix, np.uint8)
    pos += len(mid_prefix)
    tail_mat[:, pos:pos + 8] = scores.view(np.uint8).reshape(n, 8)
    pos += 8
    if weights is not None:
        tail_mat[:, pos] = 2
        tail_mat[:, pos + 1:pos + 9] = (
            np.ascontiguousarray(weights, "<f8").view(np.uint8).reshape(n, 8)
        )
        pos += 9
    else:
        pos += 1
    # metadataMap null tag is the final zero byte — already zeroed
    tail_start = starts[1:] - tail
    out[tail_start[:, None] + np.arange(tail)] = tail_mat
    return _RaggedBytes(out, starts)


class _RaggedBytes:
    """Byte stream with per-record boundaries; slicing yields sub-streams
    (len() = record count, .tobytes() = the raw payload)."""

    def __init__(self, data: np.ndarray, starts: np.ndarray):
        self._data = data
        self._starts = starts

    def __len__(self) -> int:
        return len(self._starts) - 1

    def __getitem__(self, s: slice) -> "_RaggedBytes":
        lo, hi, step = s.indices(len(self))
        assert step == 1
        return _RaggedBytes(
            self._data[self._starts[lo]:self._starts[hi]],
            self._starts[lo:hi + 1] - self._starts[lo],
        )

    def tobytes(self) -> bytes:
        return self._data.tobytes()


def read_scores(path: str | os.PathLike) -> list[dict]:
    return list(avro_io.read_directory(path))
