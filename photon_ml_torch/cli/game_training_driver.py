"""GAME training driver: the flagship end-to-end CLI entry point (the port's).

Counterpart of ``photon_ml_tpu/cli/game_training_driver.py`` on its in-core,
one-device path; reference photon-client
cli/game/training/GameTrainingDriver.scala — params (:78-166), run()
pipeline (:335-471): read + validate data, feature stats, normalization
contexts, λ-grid expansion (:612-621), GameEstimator fit per configuration
warm-starting from the previous (:352-366), model selection (:672-737),
model save (:748-815).

    python -m photon_ml_torch.cli.game_training_driver \\
        --input-data-path data/train --validation-data-path data/val \\
        --root-output-dir out \\
        --feature-shard-configurations name=global,feature.bags=features \\
        --coordinate-configurations name=fe,feature.shard=global,reg.weights=0.1|1|10 \\
        --task-type LOGISTIC_REGRESSION --evaluators AUC

Runs on the CUDA device (the fixed effects through the packed kernel);
``main(argv, device="cpu")`` runs on the CPU. The flags the port takes keep
the JAX driver's names and meanings, and its outputs (``models/<i>``,
``best``, ``index-maps``, ``feature-stats``, ``training-summary.json``) keep
their names and layout. The summary leaves out what only the JAX run fills:
the telemetry journal, the program ledger and the streaming and refresh
sections. Left out, each refused with ``NotImplementedError`` naming its
ROADMAP.md item before any data is read: ``--distributed``/``--mesh`` (10),
``--partitioned-io`` (15), ``--streaming-chunks`` and its DuHL riders,
``--checkpoint-dir`` and ``--max-restarts`` above 0 (16; the port's default
is 0), ``--incremental-refresh``, hyperparameter tuning, the lane scheduler
(18), ``--telemetry-dir``, ``--trace-dir``, ``--profile-dir`` (19).
Sparse, hybrid and pre-indexed shards and ``--input-format libsvm`` are
taken; a random effect on a sparse shard trains and saves a compact model;
matrix-factorization coordinates read both their entity columns;
``--input-date-range``/``--validation-data-date-range`` read the
``<path>/daily/yyyy/MM/dd`` directories inside the range.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from photon_ml_torch.cli.configs import (
    CoordinateCliConfig,
    ModelOutputMode,
    estimator_coordinate_configs,
    evaluation_id_columns,
    expand_reg_weight_grid,
    format_coordinate_config,
    parse_coordinate_config,
    parse_feature_shard_config,
)
from photon_ml_torch.data.batch import summarize
from photon_ml_torch.data.sparse_batch import SparseShard
from photon_ml_torch.data.validators import DataValidationType, validate_game_dataset
from photon_ml_torch.device import resolve_device
from photon_ml_torch.estimators import GameEstimator
from photon_ml_torch.evaluation.evaluators import parse_evaluator
from photon_ml_torch.io.data_reader import read_merged
from photon_ml_torch.io.index_map import IdentityIndexMap, IndexMap
from photon_ml_torch.io.model_io import (
    DEFAULT_COMPACT_RE_THRESHOLD,
    load_game_model,
    save_game_model,
    write_feature_stats,
)
from photon_ml_torch.ops.normalization import NormalizationType
from photon_ml_torch.types import TaskType
from photon_ml_torch.util import PhotonLogger, Timed
from photon_ml_torch.util.date_range import parse_date_or_days_range, resolve_input_paths
from photon_ml_torch.util.timed import reset_timings, timing_summary

logger = logging.getLogger(__name__)

#: hyperparameter-tuning modes of the JAX driver (reference
#: HyperparameterTuningMode); the port takes NONE only (ROADMAP.md item 18)
TUNING_MODES = ("NONE", "BAYESIAN", "RANDOM")


@dataclasses.dataclass
class GameTrainingParams:
    """Validated driver parameters (reference GameTrainingDriver params)."""

    input_data_path: str
    root_output_dir: str
    feature_shards: dict
    coordinates: dict[str, CoordinateCliConfig]
    task_type: TaskType
    validation_data_path: str | None = None
    update_sequence: tuple[str, ...] = ()
    coordinate_descent_iterations: int = 1
    evaluators: tuple[str, ...] = ()
    normalization: NormalizationType = NormalizationType.NONE
    data_validation: DataValidationType = DataValidationType.VALIDATE_DISABLED
    model_input_dir: str | None = None  # warm start
    partial_retrain_locked_coordinates: tuple[str, ...] = ()
    model_output_mode: ModelOutputMode = ModelOutputMode.ALL
    input_format: str = "avro"
    #: reuse the plain ``.keys`` index stores of a previous run or of the
    #: feature-indexing driver instead of scanning the data
    index_maps_dir: str | None = None
    override_output: bool = False
    #: warm-start models whose RE feature space exceeds this load compact
    compact_random_effect_threshold: int = DEFAULT_COMPACT_RE_THRESHOLD
    #: "raise" (strict) or "quarantine" (skip-and-count corrupt Avro blocks)
    on_corrupt: str = "raise"
    #: "yyyyMMdd-yyyyMMdd" or "N-M" days ago: read <path>/daily/yyyy/MM/dd
    input_date_range: str | None = None
    validation_data_date_range: str | None = None
    # not ported: each refused by check_ported() when set
    hyperparameter_tuning: str = "NONE"
    hyperparameter_prior_json: str | None = None
    checkpoint_dir: str | None = None
    max_restarts: int = 0
    profile_dir: str | None = None
    telemetry_dir: str | None = None
    trace_dir: str | None = None
    distributed: bool = False
    partitioned_io: bool = False
    streaming_chunks: int = 0
    duhl_working_set: int = 0
    incremental_refresh: bool = False

    def check_ported(self) -> None:
        """Raise NotImplementedError for the first option or coordinate the
        port lacks, before any data is read."""
        left_out = (
            (self.distributed,
             "--distributed/--mesh (the mesh path, GameTrainProgram)", 10),
            (self.partitioned_io, "--partitioned-io (multi-process ingestion)", 15),
            (self.streaming_chunks > 0 or self.duhl_working_set > 0,
             "--streaming-chunks and the DuHL schedule (out-of-core GAME)", 16),
            (bool(self.checkpoint_dir), "--checkpoint-dir and resume", 16),
            (self.max_restarts > 0, "--max-restarts (the recovery layer)", 16),
            (self.incremental_refresh, "--incremental-refresh", 18),
            (self.hyperparameter_tuning != "NONE" or bool(self.hyperparameter_prior_json),
             "hyperparameter tuning", 18),
            (bool(self.telemetry_dir), "--telemetry-dir (run journal)", 19),
            (bool(self.trace_dir), "--trace-dir (span tracing)", 19),
            (bool(self.profile_dir), "--profile-dir (device traces)", 19),
        )
        for unported, what, item in left_out:
            if unported:
                raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md item {item}")
        for name, cfg in self.coordinates.items():
            if cfg.scheduler:
                raise NotImplementedError(
                    f"coordinate '{name}': the lane scheduler (scheduler=true) is not ported "
                    "yet: ROADMAP.md item 18")

    def validate(self) -> None:
        """Cross-parameter checks (reference validateParams:196-298)."""
        problems = []
        if self.on_corrupt not in ("raise", "quarantine"):
            problems.append(f"--on-corrupt must be 'raise' or 'quarantine', got "
                            f"{self.on_corrupt!r}")
        if self.max_restarts < 0:
            problems.append("--max-restarts must be >= 0")
        sequence = self.update_sequence or tuple(self.coordinates.keys())
        for cid in sequence:
            if cid not in self.coordinates:
                problems.append(f"update sequence names unknown coordinate '{cid}'")
        for cid in self.partial_retrain_locked_coordinates:
            if cid not in sequence:
                problems.append(f"locked coordinate '{cid}' not in update sequence")
        if self.partial_retrain_locked_coordinates and self.model_input_dir is None:
            problems.append("partial retraining requires --model-input-dir")
        for name, cfg in self.coordinates.items():
            if cfg.is_matrix_factorization:
                continue  # MF coordinates take no feature shard
            if cfg.feature_shard not in self.feature_shards:
                problems.append(f"coordinate '{name}' references undefined feature shard "
                                f"'{cfg.feature_shard}'")
        if self.evaluators and self.validation_data_path is None:
            problems.append("--evaluators are validation evaluators and require "
                            "--validation-data-path")
        for spec in self.evaluators:
            try:
                parse_evaluator(spec)
            except ValueError as e:
                problems.append(str(e))
        if self.index_maps_dir:
            try:
                found = IndexMap.list_directory(self.index_maps_dir)
                missing = set(self.feature_shards) - set(found)
                if missing:
                    problems.append(f"--index-maps-dir {self.index_maps_dir!r} has no stores "
                                    f"for shards {sorted(missing)}")
            except OSError as e:
                problems.append(f"cannot read --index-maps-dir {self.index_maps_dir!r}: {e}")
        if problems:
            raise ValueError("invalid driver parameters: " + "; ".join(problems))


def _json_safe(obj):
    """NaN/Inf -> None so the summary is strict JSON."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def run(params: GameTrainingParams, *, device=None) -> dict:
    """Execute the training pipeline on ``device`` (CUDA unless "cpu");
    returns the summary dict written to ``training-summary.json``."""
    params.validate()
    params.check_ported()
    device = resolve_device(device)
    out = params.root_output_dir
    if os.path.isdir(out) and os.listdir(out) and not params.override_output:
        raise ValueError(f"output dir {out!r} is non-empty (pass --override-output to replace)")
    os.makedirs(out, exist_ok=True)
    reset_timings()
    with PhotonLogger(os.path.join(out, "driver.log")) as job_log:
        return _run_inner(params, job_log, device)


def _resolve(path: str, range_spec: str | None):
    """The input path, or the daily directories under it within the range."""
    if not range_spec:
        return path
    return resolve_input_paths([path], parse_date_or_days_range(range_spec))


def _run_inner(params: GameTrainingParams, job_log: PhotonLogger, device) -> dict:
    out = params.root_output_dir
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    entity_columns = {c.random_effect_type for c in params.coordinates.values()
                      if c.random_effect_type}
    for c in params.coordinates.values():
        # an MF coordinate reads two entity id columns (row and col)
        if c.is_matrix_factorization:
            entity_columns.update((c.mf_row_effect_type, c.mf_col_effect_type))
    re_columns = tuple(sorted(entity_columns))
    eval_columns = evaluation_id_columns(params.evaluators)
    prebuilt_maps = None
    if params.index_maps_dir:
        prebuilt_maps = IndexMap.load_directory(params.index_maps_dir)

    with Timed("read training data", sync=sync):
        train = read_merged(_resolve(params.input_data_path, params.input_date_range),
                            params.feature_shards,
                            index_maps=prebuilt_maps, random_effect_id_columns=re_columns,
                            evaluation_id_columns=eval_columns, fmt=params.input_format,
                            on_corrupt=params.on_corrupt, device=device)
    job_log.info("read %d training samples, shards %s", train.dataset.num_samples,
                 {k: v.size for k, v in train.index_maps.items()})

    validation = None
    if params.validation_data_path:
        with Timed("read validation data", sync=sync):
            validation = read_merged(
                _resolve(params.validation_data_path, params.validation_data_date_range),
                params.feature_shards,
                index_maps=train.index_maps, random_effect_id_columns=re_columns,
                evaluation_id_columns=eval_columns, entity_vocabs=train.dataset.entity_vocabs,
                fmt=params.input_format, on_corrupt=params.on_corrupt, device=device)

    with Timed("validate data"):
        validate_game_dataset(train.dataset, params.task_type, params.data_validation)
        if validation is not None:
            validate_game_dataset(validation.dataset, params.task_type, params.data_validation)

    with Timed("feature shard stats"):
        weights = train.dataset.host_array("weights")
        for shard_id, features in train.dataset.feature_shards.items():
            imap = train.index_maps[shard_id]
            if isinstance(imap, IdentityIndexMap) and imap.size > (1 << 20):
                # a pre-indexed giant space: its stats file would be d records
                logger.info("skipping feature stats for pre-indexed shard '%s' (d=%d)",
                            shard_id, imap.size)
                continue
            if isinstance(features, SparseShard):
                stats = features.summarize(weights)
            else:
                stats = summarize(train.dataset.host_array(f"shard/{shard_id}"), weights)
            write_feature_stats(os.path.join(out, "feature-stats", shard_id, "part-00000.avro"),
                                stats, imap)

    initial_model = None
    if params.model_input_dir:
        with Timed("load warm-start model"):
            initial_model = load_game_model(
                params.model_input_dir, train.index_maps,
                compact_random_effect_threshold=params.compact_random_effect_threshold,
                device=device)

    # index maps beside the models, so scoring is self-contained
    for shard_id, imap in train.index_maps.items():
        imap.save(os.path.join(out, "index-maps"), shard_id)

    def make_estimator(reg_weights) -> GameEstimator:
        return GameEstimator(
            task=params.task_type,
            coordinate_configs=estimator_coordinate_configs(params.coordinates, reg_weights),
            update_sequence=params.update_sequence or None,
            num_iterations=params.coordinate_descent_iterations,
            normalization=params.normalization,
            validation_evaluators=params.evaluators,
            locked_coordinates=frozenset(params.partial_retrain_locked_coordinates),
            intercept_indices=train.intercept_indices,
        )

    grid = expand_reg_weight_grid(params.coordinates)
    job_log.info("expanded λ grid to %d configurations", len(grid))
    first_evaluator = parse_evaluator(params.evaluators[0]) if params.evaluators else None

    results = []
    warm_model = initial_model
    best_index, best_metric = -1, float("nan")
    for i, reg_weights in enumerate(grid):
        with Timed(f"train config {i}", sync=sync):
            result = make_estimator(reg_weights).fit(
                train.dataset,
                validation_dataset=None if validation is None else validation.dataset,
                initial_model=warm_model)
        # warm start the next grid point (reference GameEstimator.fit:352-366)
        warm_model = result.model
        results.append((reg_weights, result))
        metric = result.best_metric
        job_log.info("config %d %s -> metric %s", i, reg_weights, metric)
        if first_evaluator is None:
            if best_index < 0:
                best_index = i
        elif best_index < 0 or first_evaluator.better_than(metric, best_metric):
            best_index, best_metric = i, metric
        if params.model_output_mode in (ModelOutputMode.ALL, ModelOutputMode.EXPLICIT):
            with Timed("save model"):
                save_game_model(os.path.join(out, "models", str(i)), result.best_model,
                                train.index_maps,
                                optimization_configurations={"regWeights": reg_weights})

    summary: dict = {
        "distributed": False,
        "num_configurations": len(grid),
        "effective_coordinate_configurations": {
            name: format_coordinate_config(cfg) for name, cfg in params.coordinates.items()},
        "best_configuration_index": best_index,
        "best_reg_weights": grid[best_index],
        "best_metric": best_metric,
        "metric_history": [{"reg_weights": rw, "metrics": r.metric_history}
                           for rw, r in results],
    }
    if params.model_output_mode != ModelOutputMode.NONE:
        with Timed("save model"):
            save_game_model(os.path.join(out, "best"), results[best_index][1].best_model,
                            train.index_maps,
                            optimization_configurations={"regWeights": grid[best_index]})
    summary["timings"] = timing_summary()
    with open(os.path.join(out, "training-summary.json"), "w") as f:
        json.dump(_json_safe(summary), f, indent=2, default=float)
    return summary


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="game_training_driver", description=__doc__.split("\n")[0])
    p.add_argument("--input-data-path", required=True)
    p.add_argument("--input-date-range",
                   help="yyyyMMdd-yyyyMMdd or N-M (days ago): read <path>/daily/yyyy/MM/dd")
    p.add_argument("--validation-data-path")
    p.add_argument("--validation-data-date-range",
                   help="yyyyMMdd-yyyyMMdd or N-M (days ago), as --input-date-range")
    p.add_argument("--root-output-dir", required=True)
    p.add_argument("--feature-shard-configurations", action="append", required=True,
                   help="name=NAME,feature.bags=BAG|BAG,intercept=true (repeatable)")
    p.add_argument("--coordinate-configurations", action="append", required=True,
                   help="name=NAME,feature.shard=SHARD,reg.weights=0.1|1,... (repeatable)")
    p.add_argument("--task-type", required=True,
                   choices=[t.name for t in TaskType if t != TaskType.NONE])
    p.add_argument("--update-sequence", default="", help="comma-separated coordinate order")
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument("--evaluators", default="", help="comma-separated specs")
    p.add_argument("--normalization", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--data-validation", default="VALIDATE_DISABLED",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--model-input-dir", help="warm-start model directory")
    p.add_argument("--partial-retrain-locked-coordinates", default="")
    p.add_argument("--model-output-mode", default="ALL",
                   choices=[m.name for m in ModelOutputMode])
    p.add_argument("--hyperparameter-tuning", default="NONE", choices=TUNING_MODES,
                   help="not ported beyond NONE (item 18)")
    p.add_argument("--hyperparameter-prior-json", help="not ported (item 18)")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--index-maps-dir", help="reuse plain .keys index stores")
    p.add_argument("--override-output", action="store_true")
    p.add_argument("--checkpoint-dir", help="not ported (item 16)")
    p.add_argument("--profile-dir", help="not ported (item 19)")
    p.add_argument("--telemetry-dir", help="not ported (item 19)")
    p.add_argument("--trace-dir", help="not ported (item 19)")
    p.add_argument("--compact-random-effect-threshold", type=int,
                   default=DEFAULT_COMPACT_RE_THRESHOLD,
                   help="warm-start RE models over this feature-space size load as compact "
                        "per-entity tables")
    p.add_argument("--distributed", action="store_true", help="not ported (item 10)")
    p.add_argument("--mesh", default="", help="not ported (item 10)")
    p.add_argument("--partitioned-io", action="store_true", help="not ported (item 15)")
    p.add_argument("--on-corrupt", default="raise", choices=["raise", "quarantine"],
                   help="corrupt Avro blocks: 'raise' (strict, default) or 'quarantine' "
                        "(skip-and-count)")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="restarts after a divergence or transient failure; the port has no "
                        "recovery layer yet (item 16), so only 0 is taken")
    p.add_argument("--streaming-chunks", type=int, default=0, help="not ported (item 16)")
    p.add_argument("--duhl-working-set", type=int, default=0, help="not ported (item 16)")
    p.add_argument("--incremental-refresh", action="store_true", help="not ported (item 18)")
    return p


def parse_args(argv: Sequence[str] | None = None) -> GameTrainingParams:
    args = build_arg_parser().parse_args(argv)
    shards = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    coords = {}
    for spec in args.coordinate_configurations:
        cfg = parse_coordinate_config(spec)
        if cfg.name in coords:
            raise ValueError(f"duplicate coordinate name {cfg.name!r}")
        coords[cfg.name] = cfg

    def split(s):
        return tuple(x.strip() for x in s.split(",") if x.strip())

    return GameTrainingParams(
        input_data_path=args.input_data_path,
        input_date_range=args.input_date_range,
        validation_data_path=args.validation_data_path,
        validation_data_date_range=args.validation_data_date_range,
        root_output_dir=args.root_output_dir,
        feature_shards=shards,
        coordinates=coords,
        task_type=TaskType[args.task_type],
        update_sequence=split(args.update_sequence),
        coordinate_descent_iterations=args.coordinate_descent_iterations,
        evaluators=split(args.evaluators),
        normalization=NormalizationType[args.normalization],
        data_validation=DataValidationType[args.data_validation],
        model_input_dir=args.model_input_dir,
        partial_retrain_locked_coordinates=split(args.partial_retrain_locked_coordinates),
        model_output_mode=ModelOutputMode[args.model_output_mode],
        hyperparameter_tuning=args.hyperparameter_tuning,
        hyperparameter_prior_json=args.hyperparameter_prior_json,
        input_format=args.input_format,
        index_maps_dir=args.index_maps_dir,
        override_output=args.override_output,
        checkpoint_dir=args.checkpoint_dir,
        profile_dir=args.profile_dir,
        telemetry_dir=args.telemetry_dir,
        trace_dir=args.trace_dir,
        compact_random_effect_threshold=args.compact_random_effect_threshold,
        distributed=args.distributed or bool(args.mesh),
        partitioned_io=args.partitioned_io,
        on_corrupt=args.on_corrupt,
        max_restarts=args.max_restarts,
        streaming_chunks=args.streaming_chunks,
        duhl_working_set=args.duhl_working_set,
        incremental_refresh=args.incremental_refresh,
    )


def main(argv: Sequence[str] | None = None, *, device=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv), device=device)


if __name__ == "__main__":
    main()
