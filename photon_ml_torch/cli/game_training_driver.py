"""GAME training driver: the flagship end-to-end CLI entry point (the port's).

Counterpart of ``photon_ml_tpu/cli/game_training_driver.py`` on its in-core
paths, one device or a data-axis mesh (``--distributed``); reference
photon-client
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
their names and layout.

``--telemetry-dir`` writes rank 0's JSONL run journal
(``run-journal.jsonl``: the configuration, per-coordinate convergence rows,
heartbeats, phase timings, the metrics registry's snapshot; on success and
on failure), ``--trace-dir`` every rank's host span timeline
(``trace-<rank>.json``, Chrome-trace JSON) with a straggler report merged
across the ranks into the journal, and ``--profile-dir`` a
``torch.profiler`` device trace of the run. The module's ``events``
emitter sends the setup, start, finish and per-update optimization events
to its listeners. The JAX driver's program-ledger rows and compile gauges
are not written (ROADMAP.md item 19, step 2).

``--distributed`` (or ``--mesh data=N[,model=M]``) trains through the fused
program over a mesh of every rank: run it under ``torchrun --nproc-per-node
N·M`` (NCCL, one card a rank), or in one process alone (a group of one).
Every rank reads the same inputs; rank 0 writes the outputs and the other
ranks write into ``<root-output-dir>/.worker-<rank>``. A model axis wider
than 1 feature-shards the primary fixed effect over it
(``fe_feature_sharded``, the JAX driver's rule). With ``--partitioned-io``
each data rank of a group of several decodes only its slice of the
training input (``io/partitioned_reader.py``; the ranks of one data row
each read the same slice) and trains through ``train_partitioned``; it
needs ``--distributed`` or ``--mesh``, takes no validation data and writes
no feature statistics (they would summarize one rank's rows). A data axis
of one reads in full.

``--checkpoint-dir`` keeps one checkpoint directory per configuration of
the λ grid, named by its index and a digest of its regularization weights
(``config_<i>_<digest>``, the JAX driver's), saved every
``--checkpoint-every`` coordinate updates (fused sweeps with
``--distributed``); a rerun resumes from it unless ``--no-resume``.
``--max-restarts`` (default 2, the JAX driver's) restarts a configuration
after a transient failure or a divergence with a checkpoint to fall back to
(``resilience/recovery.py``), and a restart resumes even under
``--no-resume``. A run of several ranks (``--distributed``, partitioned or
not) attaches a ``resilience.CoordinatedRecovery`` to its exchange: one
rank's failure rolls every rank back to the last barrier-committed
checkpoint on a new process group, within one budget shared by the ranks.

``--streaming-chunks N`` trains out of core (``_run_streaming``): one
streaming scan builds the index maps, entity vocabularies and per-sample
scalars, the input streams in entity-clustered chunks of about N records
(``io/stream_reader.GameAvroChunkSource``) and
``algorithm/streaming_game.StreamingGameProgram`` sweeps them; validation
data is scored chunk by chunk (``score_game_stream``).
``--duhl-working-set B`` (with ``--duhl-tail-chunks t``) takes the DuHL
schedule. With ``--partitioned-io`` in a group of several ranks (the
launcher's, or one ``initialize`` joins), each rank streams its own slice
of the chunks (``plan_partitioned_game_stream``) under coordinated recovery.
The surface is the JAX driver's: Avro, one dense fixed effect first in the
update sequence, IDENTITY random effects, one λ each, no normalization.

``--incremental-refresh`` (with ``--model-input-dir`` or a training run's
``--checkpoint-dir``) solves again only the random-effect entities that
changed (``--refresh-changed-entities``, ``--refresh-gradient-tolerance``,
``--refresh-fixed-effects``; ``algorithm/refresh.py``) and writes its
selection into the summary's ``incremental_refresh``.
``--hyperparameter-tuning RANDOM|BAYESIAN`` searches every unlocked
coordinate's λ over ``--hyperparameter-tuning-range`` for
``--hyperparameter-tuning-iter`` fits after the grid
(``hyperparameter/game_glue.py``, seeded by ``--hyperparameter-prior-json``)
and writes ``tuned-hyperparameters.json``. ``scheduler=true`` in a random
effect's configuration schedules its lanes (``algorithm/lane_scheduler.py``).
Sparse, hybrid and pre-indexed shards and ``--input-format libsvm`` are
taken; a random effect on a sparse shard trains and saves a compact model;
matrix-factorization coordinates read both their entity columns;
``--input-date-range``/``--validation-data-date-range`` read the
``<path>/daily/yyyy/MM/dd`` directories inside the range.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import shutil
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
from photon_ml_torch.estimators import GameEstimator, TrainPartition
from photon_ml_torch.hyperparameter.game_glue import (
    GameHyperparameterTuner,
    HyperparameterTuningMode,
    load_prior_observations,
    save_tuned_config,
)
from photon_ml_torch.evaluation.evaluators import parse_evaluator
from photon_ml_torch.io.checkpoint import TrainingCheckpointer
from photon_ml_torch.io.data_reader import read_merged
from photon_ml_torch.io.partitioned_reader import read_partitioned
from photon_ml_torch.io.index_map import IdentityIndexMap, IndexMap
from photon_ml_torch.io.model_io import (
    DEFAULT_COMPACT_RE_THRESHOLD,
    load_game_model,
    save_game_model,
    write_feature_stats,
)
from photon_ml_torch.ops.normalization import NormalizationType
from photon_ml_torch.optim.optimizer import OptimizerType
from photon_ml_torch.parallel import multihost
from photon_ml_torch.projector.projectors import ProjectorType
from photon_ml_torch.resilience import CoordinatedRecovery, run_with_recovery
from photon_ml_torch.telemetry import (
    RunJournal,
    Tracer,
    default_registry,
    flush_trace_best_effort,
    install_tracer,
    resilience_counters,
    uninstall_tracer,
)
from photon_ml_torch.telemetry.layout import reset_layout_metrics
from photon_ml_torch.telemetry.refresh_counters import reset_refresh_metrics
from photon_ml_torch.telemetry.resilience_counters import reset_resilience_metrics
from photon_ml_torch.telemetry.solver_trace import SolverTelemetry, reset_solver_metrics
from photon_ml_torch.types import TaskType
from photon_ml_torch.util import (
    EventEmitter,
    PhotonLogger,
    Timed,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_torch.util.date_range import parse_date_or_days_range, resolve_input_paths
from photon_ml_torch.util.timed import profile_trace, reset_timings, timing_summary

logger = logging.getLogger(__name__)

#: process-wide emitter: external telemetry registers listeners here
#: (reference Driver.scala:120-393's PhotonSetupEvent, TrainingStart/Finish
#: and per-update PhotonOptimizationLogEvents)
events = EventEmitter()

#: hyperparameter-tuning modes (reference HyperparameterTuningMode)
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
    #: one checkpoint directory per configuration under it (None: none)
    checkpoint_dir: str | None = None
    #: coordinate updates (fused sweeps) between checkpoints
    checkpoint_every: int = 1
    #: False ignores existing checkpoints on the first attempt
    resume: bool = True
    #: restarts of a configuration after a transient failure
    max_restarts: int = 2
    #: "NONE", "RANDOM" or "BAYESIAN" (game_glue.HyperparameterTuningMode)
    hyperparameter_tuning: str = "NONE"
    hyperparameter_tuning_iter: int = 10
    hyperparameter_tuning_range: tuple[float, float] = (1e-4, 1e4)
    #: tuned-hyperparameters.json of a previous run, the search's priors
    hyperparameter_prior_json: str | None = None
    #: torch.profiler trace output dir (CPU and CUDA activity); empty = off
    profile_dir: str | None = None
    #: rank 0's JSONL run journal dir (telemetry/journal.py); None = off
    telemetry_dir: str | None = None
    #: every rank's span timeline dir (telemetry/tracing.py); None = off
    trace_dir: str | None = None
    #: train through the fused program over a data-axis mesh (one process
    #: per rank: ``torchrun --nproc-per-node N``, or one process alone);
    #: ``mesh_shape`` {"data": N, "model": M}, None = every rank on "data"
    distributed: bool = False
    mesh_shape: dict | None = None
    partitioned_io: bool = False
    #: out-of-core streamed GAME: records per entity-clustered chunk (0: in core)
    streaming_chunks: int = 0
    #: decode the next chunk behind the current one (False: inline)
    streaming_prefetch: bool = True
    #: DuHL working set (pinned chunks; 0: uniform order) and cold chunks a sweep
    duhl_working_set: int = 0
    duhl_tail_chunks: int = 1
    #: incremental retrain (algorithm/refresh.py) against a resident model
    #: (--model-input-dir, or the CD checkpoints of --checkpoint-dir)
    incremental_refresh: bool = False
    #: gradient screen (<= 0: only declared entities are solved again)
    refresh_gradient_tolerance: float = 1e-4
    #: "reType=key1|key2" specs of entities declared changed
    refresh_changed_entities: tuple[str, ...] = ()
    #: also solve the fixed effects again (warm-started)
    refresh_fixed_effects: bool = False

    def validate(self) -> None:
        """Cross-parameter checks (reference validateParams:196-298)."""
        problems = []
        if self.on_corrupt not in ("raise", "quarantine"):
            problems.append(f"--on-corrupt must be 'raise' or 'quarantine', got "
                            f"{self.on_corrupt!r}")
        if self.max_restarts < 0:
            problems.append("--max-restarts must be >= 0")
        if self.checkpoint_every < 1:
            problems.append("--checkpoint-every must be >= 1")
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
        if self.hyperparameter_prior_json:
            # a mistyped priors path fails now, not after the grid trains
            try:
                load_prior_observations(self.hyperparameter_prior_json)
            except Exception as e:
                problems.append(f"cannot read --hyperparameter-prior-json "
                                f"{self.hyperparameter_prior_json!r}: {e}")
        if self.hyperparameter_tuning != "NONE" and not self.evaluators:
            problems.append("hyperparameter tuning requires --evaluators")
        if self.incremental_refresh:
            self._validate_refresh(problems)
        elif self.refresh_changed_entities or self.refresh_fixed_effects:
            problems.append(
                "--refresh-changed-entities/--refresh-fixed-effects tune "
                "the incremental-refresh policy; pass --incremental-refresh "
                "to opt into the refresh driver mode")
        if self.streaming_chunks > 0:
            self._validate_streaming(problems)
        elif self.duhl_working_set > 0:
            problems.append("--duhl-working-set schedules streamed chunks; pass "
                            "--streaming-chunks N to opt into the streamed GAME path")
        if problems:
            raise ValueError("invalid driver parameters: " + "; ".join(problems))

    def _validate_refresh(self, problems: list) -> None:
        """The incremental-refresh surface (the JAX driver's checks and
        messages): the single-process coordinate-descent path, one λ per
        coordinate, against a resident model."""
        if not self.model_input_dir and not self.checkpoint_dir:
            problems.append(
                "--incremental-refresh needs a resident model: pass "
                "--model-input-dir (a saved model directory) or "
                "--checkpoint-dir (a training run's CD checkpoints — "
                "warm-start re-entry)")
        if self.distributed or self.mesh_shape or self.partitioned_io:
            problems.append(
                "--incremental-refresh is the single-process host path; "
                "drop --distributed/--mesh/--partitioned-io (run the full "
                "fused fit to retrain at mesh scale)")
        if self.streaming_chunks > 0:
            problems.append(
                "--incremental-refresh reads the refresh data in-core; "
                "drop --streaming-chunks (or run the streamed full fit)")
        if self.hyperparameter_tuning != "NONE":
            problems.append(
                "--incremental-refresh trains the resident λ; drop "
                "--hyperparameter-tuning (tune on a full fit)")
        if self.validation_data_path or self.evaluators:
            problems.append(
                "--incremental-refresh has no validation pass; drop "
                "--validation-data-path/--evaluators and score with the "
                "scoring driver")
        if self.refresh_gradient_tolerance < 0:
            problems.append("--refresh-gradient-tolerance must be >= 0")
        for name, cfg in self.coordinates.items():
            if len(cfg.reg_weights) != 1:
                problems.append(
                    f"coordinate '{name}': --incremental-refresh trains "
                    "the resident λ; pass a single reg.weights value")
        try:
            _parse_changed_entities(self.refresh_changed_entities)
        except ValueError as e:
            problems.append(str(e))

    def _validate_streaming(self, problems: list) -> None:
        """The streamed-GAME surface (the JAX driver's checks and messages):
        one dense primary FE and IDENTITY random effects over an
        entity-sorted Avro input, in one process or over ranks with
        --partitioned-io."""
        if self.input_format != "avro":
            problems.append("--streaming-chunks streams Avro container blocks; for libsvm "
                            "inputs drop --streaming-chunks (or convert with "
                            "cli.libsvm_to_avro)")
        if self.input_date_range:
            problems.append("--streaming-chunks streams one input directory; drop "
                            "--input-date-range (pass the resolved daily dir directly)")
        if self.validation_data_date_range:
            problems.append("--streaming-chunks streams one validation directory; drop "
                            "--validation-data-date-range (pass the resolved dir directly)")
        if self.distributed or self.mesh_shape:
            problems.append("--streaming-chunks is the host-loop out-of-core GAME path; drop "
                            "--distributed/--mesh (for multi-process streamed GAME use "
                            "--partitioned-io, which partitions chunks across ranks instead "
                            "of meshing devices)")
        if self.normalization != NormalizationType.NONE:
            problems.append("--streaming-chunks trains un-normalized; use --normalization NONE "
                            "or run in-core")
        for spec in self.evaluators:
            if ":" in str(spec):
                problems.append(f"evaluator '{spec}': per-query evaluators need evaluation id "
                                "columns the chunk stream does not decode; use a global "
                                "evaluator or score with the scoring driver")
        if self.hyperparameter_tuning != "NONE":
            problems.append("--streaming-chunks trains one configuration; drop "
                            "--hyperparameter-tuning")
        if self.data_validation != DataValidationType.VALIDATE_DISABLED:
            problems.append("--streaming-chunks has no chunked validation pass yet; use "
                            "--data-validation VALIDATE_DISABLED or run in-core")
        if self.model_input_dir or self.partial_retrain_locked_coordinates:
            problems.append("--streaming-chunks does not warm-start from --model-input-dir "
                            "yet; drop it or train in-core")
        if self.duhl_working_set < 0 or self.duhl_tail_chunks < 1:
            problems.append("--duhl-working-set must be >= 0 and --duhl-tail-chunks >= 1")
        fe_coords = [n for n, c in self.coordinates.items()
                     if not c.is_random_effect and not c.is_matrix_factorization]
        if len(fe_coords) != 1:
            problems.append("--streaming-chunks needs exactly one fixed-effect coordinate "
                            f"(got {fe_coords}); train other layouts in-core")
        sequence = self.update_sequence or tuple(self.coordinates.keys())
        if fe_coords and sequence and sequence[0] != fe_coords[0]:
            problems.append("--streaming-chunks trains the fixed effect first; put "
                            f"'{fe_coords[0]}' first in --update-sequence")
        for name, c in self.coordinates.items():
            if c.is_matrix_factorization:
                problems.append(f"coordinate '{name}': matrix factorization does not stream; "
                                "drop --streaming-chunks or the MF coordinate")
            if (not c.is_random_effect and not c.is_matrix_factorization
                    and c.optimizer == OptimizerType.NEWTON):
                problems.append(f"coordinate '{name}': NEWTON cannot stream the fixed effect "
                                "(dense [d, d] Hessian); use TRON or LBFGS")
            if c.is_random_effect and c.projector != ProjectorType.IDENTITY:
                problems.append(f"coordinate '{name}': projector {c.projector.name} does not "
                                "stream; use IDENTITY or train in-core")
            if len(c.reg_weights) != 1:
                problems.append(f"coordinate '{name}': --streaming-chunks trains one λ per "
                                "coordinate; pass a single reg.weights value")


def _parse_changed_entities(specs) -> dict:
    """'reType=key1|key2' specs -> {reType: (keys...)} (repeatable; specs of
    one type merge)."""
    out: dict = {}
    for spec in specs:
        typ, sep, keys = str(spec).partition("=")
        typ = typ.strip()
        if not sep or not typ:
            raise ValueError(f"bad --refresh-changed-entities {spec!r}; expected "
                             "reType=key1|key2")
        out.setdefault(typ, [])
        out[typ] += [k for k in keys.split("|") if k]
    return {k: tuple(v) for k, v in out.items()}


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
    streamed_ranks = params.streaming_chunks > 0 and params.partitioned_io
    if params.partitioned_io and not params.distributed and not streamed_ranks:
        raise ValueError(
            "--partitioned-io requires --distributed or --mesh (the "
            "partitioned blocks feed a mesh's addressable shards)"
        )
    created = False
    rank = 0
    if params.distributed or streamed_ranks:
        # every rank reads the same inputs and joins every collective; the
        # files are rank 0's, the other ranks write into a scratch directory
        created = not torch.distributed.is_initialized()
        rank = multihost.initialize(device=device).rank
    elif torch.distributed.is_initialized() and torch.distributed.get_world_size() > 1:
        raise ValueError("multi-process runs require --distributed or --mesh (the fused "
                         "program over the mesh) or --streaming-chunks with --partitioned-io "
                         "(the partitioned streamed GAME path); the coordinate-descent path "
                         "has no cross-rank coordination")
    if rank > 0:
        params = dataclasses.replace(
            params, root_output_dir=os.path.join(params.root_output_dir, f".worker-{rank}"),
            override_output=True)
    try:
        device = resolve_device(device)
        out = params.root_output_dir
        # a faster rank may create its .worker-N directory first
        existing = [e for e in os.listdir(out) if not e.startswith(".worker-")] \
            if os.path.isdir(out) else []
        if existing and not params.override_output:
            raise ValueError(f"output dir {out!r} is non-empty (pass --override-output to "
                             "replace)")
        mesh = None
        if params.distributed:
            shape = dict(params.mesh_shape or {})
            mesh = multihost.make_hybrid_mesh(data=shape.get("data"),
                                              model=shape.get("model", 1))
        os.makedirs(out, exist_ok=True)
        # per-run phase timings and tallies (a sweep may call run() again)
        reset_timings()
        reset_solver_metrics()
        reset_layout_metrics()
        reset_resilience_metrics()
        reset_refresh_metrics()
        events.send(TrainingStartEvent(job_name="game-training"))
        # the journal is inert on ranks > 0, so the telemetry calls below
        # run on every rank; with no live sink SolverTelemetry builds no
        # row and reads nothing from the device
        journal = RunJournal(params.telemetry_dir) if params.telemetry_dir else None
        telemetry = SolverTelemetry(
            journal=journal, emitter=events,
            registry=default_registry() if journal and journal.active else None)
        # installed before any stage, so a failed read still leaves a timeline
        tracer = install_tracer(Tracer()) if params.trace_dir else None
        succeeded = False
        try:
            with profile_trace(params.profile_dir), \
                    PhotonLogger(os.path.join(out, "driver.log")) as job_log:
                if params.incremental_refresh:
                    # the refresh reads the data in the resident model's feature space
                    summary = _run_refresh(params, job_log, device, telemetry)
                elif params.streaming_chunks > 0:
                    # the streamed path scans the input itself: the full read
                    # would build what it exists to avoid
                    summary = _run_streaming(params, job_log, device, telemetry)
                else:
                    summary = _run_inner(params, job_log, device, mesh, telemetry)
            succeeded = True
            events.send(TrainingFinishEvent(job_name="game-training", succeeded=True))
            return summary
        except Exception:
            events.send(TrainingFinishEvent(job_name="game-training", succeeded=False))
            raise
        finally:
            # the trace flushes first, so a crash leaves a timeline: on
            # success the straggler tables merge over the exchange (every
            # rank reaches this point); on failure no new collective runs
            if tracer is not None:
                try:
                    flush_trace_best_effort(
                        tracer, params.trace_dir,
                        exchange=multihost.default_exchange() if succeeded else None,
                        gather=succeeded, journal=journal)
                finally:
                    uninstall_tracer()
            _close_journal(journal)
    finally:
        if created:
            multihost.shutdown()


def _journal_of(telemetry) -> "RunJournal | None":
    return None if telemetry is None else telemetry.journal


def _close_journal(journal) -> None:
    """The run-end rows, on success and on failure: each quarantined block
    span, the phase timings and the registry snapshot (the resilience,
    solver, scheduler, stream, layout and I/O counters); then publish."""
    if journal is None:
        return
    for event in resilience_counters.drain_quarantine_events():
        journal.record("quarantined_block", **event)
    journal.record_timings(timing_summary())
    journal.record_metrics(default_registry().snapshot())
    journal.close()


def _resolve(path: str, range_spec: str | None):
    """The input path, or the daily directories under it within the range."""
    if not range_spec:
        return path
    return resolve_input_paths([path], parse_date_or_days_range(range_spec))


def _run_inner(params: GameTrainingParams, job_log: PhotonLogger, device, mesh=None,
               telemetry: SolverTelemetry | None = None) -> dict:
    out = params.root_output_dir
    if mesh is not None:
        job_log.info("distributed mode: mesh data=%d, model=%d", mesh.size(0), mesh.size(1))
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

    # partitioned I/O: each rank of a group of several decodes about 1/P of
    # the input; a group of one (and every other run) reads in full
    exchange = None
    coordinator = None
    pad_multiple = 1
    if params.partitioned_io and mesh is not None and mesh.size(0) > 1:
        # the partition's ranks are the data ranks: one data row reads one slice
        exchange = multihost.default_exchange()
        if mesh.size(1) > 1:
            exchange = multihost.DataAxisExchange(exchange, mesh)
        # coordinated recovery: the run's one exchange is fenced into restart
        # generations, and a rank's failure rolls every rank back to the last
        # barrier-committed checkpoint within one budget (host-side only: no
        # device collective is added or moved)
        coordinator = CoordinatedRecovery(exchange, max_restarts=params.max_restarts,
                                          journal=_journal_of(telemetry),
                                          description="partitioned game train")
        data_axis = mesh.size(0)
        if data_axis % exchange.num_ranks:
            raise ValueError(f"--partitioned-io: mesh data axis {data_axis} must be a multiple "
                             f"of the process count {exchange.num_ranks}")
        pad_multiple = data_axis // exchange.num_ranks
        if params.validation_data_path:
            raise ValueError(
                "--partitioned-io does not support validation data yet; "
                "score + evaluate with the partitioned scoring driver"
            )
    elif mesh is not None and multihost.process_info().world_size > 1:
        # every rank reads in full; the exchange only fences the checkpoint
        # commits and carries the coordinated restart, so a rank that fails
        # never re-enters the fused program's collectives out of step
        coordinator = CoordinatedRecovery(multihost.default_exchange(),
                                          max_restarts=params.max_restarts,
                                          journal=_journal_of(telemetry),
                                          description="distributed game train")

    # no retry around the read: a partitioned read is collective, and one
    # rank retrying would desynchronize its exchanges
    with Timed("read training data", sync=sync):
        train_part = read_partitioned(
            _resolve(params.input_data_path, params.input_date_range), params.feature_shards,
            exchange=exchange, index_maps=prebuilt_maps, random_effect_id_columns=re_columns,
            evaluation_id_columns=eval_columns, fmt=params.input_format,
            pad_multiple=pad_multiple, tag="train", on_corrupt=params.on_corrupt, device=device)
        train = train_part.result
    partition = train_part.partition
    job_log.info(
        "read %d training samples%s, shards %s", train.dataset.num_samples,
        (f" (rank {partition.rank}/{partition.num_ranks}, {train_part.bytes_decoded}/"
         f"{train_part.input_bytes_total} bytes decoded)" if partition.num_ranks > 1 else ""),
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
        if partition.num_ranks > 1:
            # a rank's statistics would summarize 1/P of the rows
            logger.info("partitioned ingest: skipping feature stats (rank-local rows)")
        for shard_id, features in ({} if partition.num_ranks > 1
                                   else train.dataset.feature_shards).items():
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

    # plain index maps beside the models, so scoring is self-contained;
    # off-heap stores stay where they are (scoring takes --index-maps-dir)
    for shard_id, imap in train.index_maps.items():
        if isinstance(imap, IndexMap):
            imap.save(os.path.join(out, "index-maps"), shard_id)

    estimator_partition = None
    if partition.num_ranks > 1:
        estimator_partition = TrainPartition(
            info=partition, exchange=exchange, lane_multiple=pad_multiple,
            entity_rank_presence=train_part.entity_rank_presence)

    # the mesh of the current attempt: a coordinated restart joins a new group
    live = {"mesh": mesh}

    def make_estimator(reg_weights, checkpointer=None, resume=True) -> GameEstimator:
        mesh = live["mesh"]
        return GameEstimator(
            task=params.task_type,
            coordinate_configs=estimator_coordinate_configs(params.coordinates, reg_weights),
            update_sequence=params.update_sequence or None,
            num_iterations=params.coordinate_descent_iterations,
            normalization=params.normalization,
            validation_evaluators=params.evaluators,
            locked_coordinates=frozenset(params.partial_retrain_locked_coordinates),
            intercept_indices=train.intercept_indices,
            checkpointer=checkpointer,
            checkpoint_every=params.checkpoint_every,
            resume=resume,
            mesh=mesh,
            fe_feature_sharded=mesh is not None and mesh.size(1) > 1,
            telemetry=telemetry,
            partition=estimator_partition,
        )

    grid = expand_reg_weight_grid(params.coordinates)
    job_log.info("expanded λ grid to %d configurations", len(grid))
    if _journal_of(telemetry) is not None:
        telemetry.journal.record(
            "config", task_type=params.task_type.name, distributed=mesh is not None,
            num_configurations=len(grid),
            coordinate_configurations={name: format_coordinate_config(cfg)
                                       for name, cfg in params.coordinates.items()},
            update_sequence=list(params.update_sequence or params.coordinates.keys()),
            coordinate_descent_iterations=params.coordinate_descent_iterations,
            # their scheduler/* counters and the solver/lane_iters histogram
            # ride the registry snapshot
            scheduled_coordinates=[name for name, cfg in params.coordinates.items()
                                   if cfg.scheduler])
    first_evaluator = parse_evaluator(params.evaluators[0]) if params.evaluators else None

    def make_checkpointer(config_index: int, reg_weights):
        if not params.checkpoint_dir:
            return None
        # keyed by the configuration's content, not only its grid position:
        # an edited λ grid never resumes another configuration's checkpoint
        digest = hashlib.sha256(
            json.dumps(sorted(reg_weights.items()), default=float).encode()).hexdigest()[:12]
        return TrainingCheckpointer(
            os.path.join(params.checkpoint_dir, f"config_{config_index}_{digest}"))

    results = []
    warm_model = initial_model
    best_index, best_metric = -1, float("nan")
    for i, reg_weights in enumerate(grid):
        ckpt = make_checkpointer(i, reg_weights)

        def attempt(restart: int, _rw=reg_weights, _ck=ckpt, _init=warm_model):
            # a restart resumes even under --no-resume: that is what the
            # checkpoint is for; a coordinated one restores the published step
            # on a new group (a rank that failed inside a collective leaves
            # the old group's operation sequence out of step)
            if restart > 0 and coordinator is not None:
                multihost.reinitialize(f"restart/{coordinator.exchange.fence_namespace()}")
                shape = dict(params.mesh_shape or {})
                live["mesh"] = multihost.make_hybrid_mesh(data=shape.get("data"),
                                                          model=shape.get("model", 1))
            est = make_estimator(_rw, _ck, resume=params.resume or restart > 0)
            if coordinator is not None:
                est.resume_step = coordinator.resume_step
                if estimator_partition is None:
                    est.exchange = coordinator.exchange
            return est.fit(train.dataset,
                           validation_dataset=None if validation is None else validation.dataset,
                           initial_model=_init)

        if coordinator is not None:
            # this configuration's directory; forget the previous one's step
            coordinator.rebind(ckpt)
        with Timed(f"train config {i}", sync=sync):
            result = run_with_recovery(attempt, max_restarts=params.max_restarts,
                                       checkpointer=ckpt, journal=_journal_of(telemetry),
                                       description=f"train config {i}",
                                       coordinator=coordinator)
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
        "distributed": mesh is not None,
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
    if params.hyperparameter_tuning != "NONE":
        _tune(params, summary, results, grid, best_index, best_metric, first_evaluator,
              make_estimator, train, validation)
    summary["timings"] = timing_summary()
    with open(os.path.join(out, "training-summary.json"), "w") as f:
        json.dump(_json_safe(summary), f, indent=2, default=float)
    return summary


def _tune(params: GameTrainingParams, summary: dict, results, grid, best_index: int,
          best_metric: float, first_evaluator, make_estimator, train, validation) -> None:
    """Hyperparameter tuning after the grid (reference
    GameTrainingDriver.runHyperparameterTuning:631-663): every unlocked
    coordinate's λ searched over the range, the grid's fits and the prior
    file as the search's priors; ``tuned-hyperparameters.json`` written and
    the best over the grid and the tuned candidates saved (the first
    evaluator decides)."""
    out = params.root_output_dir
    with Timed("hyperparameter tuning"):
        tunable = {name: params.hyperparameter_tuning_range for name in params.coordinates
                   if name not in params.partial_retrain_locked_coordinates}
        tuner = GameHyperparameterTuner(
            estimator=make_estimator(grid[best_index]), reg_ranges=tunable,
            mode=HyperparameterTuningMode[params.hyperparameter_tuning])
        priors = [(rw, r.best_metric) for rw, r in results if not np.isnan(r.best_metric)]
        if params.hyperparameter_prior_json:
            priors += load_prior_observations(params.hyperparameter_prior_json)
        tuned = tuner.tune(
            train.dataset, validation.dataset, num_iterations=params.hyperparameter_tuning_iter,
            prior_observations=priors,
            keep_models=params.model_output_mode in (ModelOutputMode.ALL, ModelOutputMode.TUNED))
    save_tuned_config(tuned, os.path.join(out, "tuned-hyperparameters.json"))
    summary["tuned_reg_weights"] = tuned.best_reg_weights
    summary["tuned_metric"] = tuned.best_value
    if params.model_output_mode in (ModelOutputMode.ALL, ModelOutputMode.TUNED):
        for j, (reg, r) in enumerate(tuned.tuned_results):
            save_game_model(os.path.join(out, "models-tuned", str(j)), r.best_model,
                            train.index_maps, optimization_configurations={"regWeights": reg})
    if first_evaluator is not None and tuned.best_result is not None:
        reg, r = tuned.best_result
        if not np.isnan(r.best_metric) and first_evaluator.better_than(r.best_metric,
                                                                       best_metric):
            summary["best_metric"] = r.best_metric
            summary["best_reg_weights"] = reg
            # the grid index no longer names the winner
            summary["best_configuration_index"] = None
            summary["best_is_tuned"] = True
            if params.model_output_mode != ModelOutputMode.NONE:
                save_game_model(os.path.join(out, "best"), r.best_model, train.index_maps,
                                optimization_configurations={"regWeights": reg})


def _run_refresh(params: GameTrainingParams, job_log: PhotonLogger, device,
                 telemetry: SolverTelemetry | None = None) -> dict:
    """The --incremental-refresh pipeline (``algorithm/refresh.py``): load the
    resident model (a saved directory, or the CD checkpoints of a training
    run), read the refresh data in its feature space, check the agreement
    (layout and λ; a mismatch fails naming the fields), then solve again
    only the entities the policy selects, against frozen residuals, under
    ``run_with_recovery`` with per-coordinate refresh checkpoints."""
    from photon_ml_torch.algorithm.refresh import (
        RefreshPolicy,
        check_refresh_fingerprint,
        expected_fingerprint,
        model_fingerprint,
    )
    from photon_ml_torch.cli.game_scoring_driver import _load_scoring_model
    from photon_ml_torch.io.checkpoint import latest_trained_model
    from photon_ml_torch.models.game import RandomEffectModel
    from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
    from photon_ml_torch.resilience import default_io_policy

    out = params.root_output_dir
    reg_weights = {name: cfg.reg_weights[0] for name, cfg in params.coordinates.items()}
    saved_reg_weights = None
    if params.model_input_dir:
        model, index_maps, feature_shards, entity_vocabs, re_columns = _load_scoring_model(
            model_input_dir=params.model_input_dir, index_maps_dir=params.index_maps_dir,
            feature_shards=params.feature_shards,
            compact_random_effect_threshold=params.compact_random_effect_threshold,
            device=device)
        meta_path = os.path.join(params.model_input_dir, "model-metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved = (json.load(f).get("optimizationConfigurations") or {}).get("regWeights")
            if isinstance(saved, dict):
                saved_reg_weights = {k: float(v) for k, v in saved.items()}
    else:
        # warm-start re-entry: the training run's CD checkpoints hold the model
        with Timed("restore resident model from checkpoint"):
            restored = latest_trained_model(TrainingCheckpointer(params.checkpoint_dir),
                                            device=device)
        if restored is None:
            raise ValueError(
                f"--checkpoint-dir {params.checkpoint_dir!r} holds no "
                "loadable checkpoint; pass --model-input-dir (a saved "
                "model) instead")
        model, step = restored
        job_log.info("resident model restored from checkpoint step %d", step)
        if not params.index_maps_dir:
            raise ValueError(
                "checkpoint warm-start re-entry needs --index-maps-dir "
                "(the training run's saved stores) so the refresh data "
                "reads in the resident model's feature space; or pass "
                "--model-input-dir")
        index_maps = IndexMap.load_directory(params.index_maps_dir)
        feature_shards = params.feature_shards
        entity_vocabs = {}
        re_set = set()
        for m in model.models.values():
            if isinstance(m, RandomEffectModel):
                entity_vocabs[m.random_effect_type] = np.asarray(m.entity_keys)
                re_set.add(m.random_effect_type)
            elif isinstance(m, MatrixFactorizationModel):
                entity_vocabs[m.row_effect_type] = np.asarray(m.row_keys)
                entity_vocabs[m.col_effect_type] = np.asarray(m.col_keys)
                re_set.update((m.row_effect_type, m.col_effect_type))
        re_columns = tuple(sorted(re_set))

    with Timed("read refresh data"):
        part = default_io_policy().call(
            lambda: read_partitioned(
                params.input_data_path, feature_shards, index_maps=index_maps or None,
                random_effect_id_columns=re_columns, evaluation_id_columns=(),
                entity_vocabs=entity_vocabs, fmt=params.input_format, tag="refresh",
                on_corrupt=params.on_corrupt, device=device),
            description="read refresh data")
        dataset = part.result.dataset
    job_log.info("read %d refresh samples", dataset.num_samples)

    sequence = list(params.update_sequence or params.coordinates.keys())
    coordinate_configs = estimator_coordinate_configs(params.coordinates, reg_weights)
    # the agreement: layout and λ (λ only where the saved model's metadata
    # records it; a checkpoint re-entry has no record)
    expected = expected_fingerprint(
        dataset, coordinate_configs, sequence,
        reg_weights=reg_weights if saved_reg_weights is not None else None)
    check_refresh_fingerprint(model_fingerprint(model, sequence, reg_weights=saved_reg_weights),
                              expected)
    policy = RefreshPolicy(
        gradient_tolerance=(params.refresh_gradient_tolerance
                            if params.refresh_gradient_tolerance > 0 else None),
        changed_entities=_parse_changed_entities(params.refresh_changed_entities),
        refresh_fixed_effects=params.refresh_fixed_effects)
    refresh_ckpt = None
    if params.checkpoint_dir:
        refresh_dir = os.path.join(params.checkpoint_dir, "refresh")
        if not params.resume and os.path.isdir(refresh_dir):
            # --no-resume drops stale refresh progress now, so a restart within
            # this run resumes this run's steps only
            shutil.rmtree(refresh_dir)
        refresh_ckpt = TrainingCheckpointer(refresh_dir)
    estimator = GameEstimator(
        task=params.task_type, coordinate_configs=coordinate_configs, update_sequence=sequence,
        normalization=params.normalization,
        locked_coordinates=frozenset(params.partial_retrain_locked_coordinates),
        intercept_indices=part.result.intercept_indices, telemetry=telemetry)
    if _journal_of(telemetry) is not None:
        telemetry.journal.record(
            "config", task_type=params.task_type.name, incremental_refresh=True,
            update_sequence=sequence, refresh_gradient_tolerance=params.refresh_gradient_tolerance,
            refresh_changed_entities={k: len(v) for k, v in policy.changed_entities.items()},
            refresh_fixed_effects=params.refresh_fixed_effects)

    with Timed("incremental refresh"):
        def attempt(restart: int):
            # a restart resumes even under --no-resume (that is the checkpoint's use)
            return estimator.refresh(dataset, model, policy, checkpointer=refresh_ckpt,
                                     fingerprint=expected, resume=params.resume or restart > 0)

        result = run_with_recovery(attempt, max_restarts=params.max_restarts,
                                   checkpointer=refresh_ckpt, journal=_journal_of(telemetry),
                                   description="incremental refresh")

    if params.model_output_mode != ModelOutputMode.NONE:
        save_game_model(os.path.join(out, "best"), result.model, index_maps,
                        optimization_configurations={"regWeights": reg_weights})
    summary: dict = {
        "distributed": False,
        "incremental_refresh": {
            "lanes_total": result.lanes_total,
            "lanes_solved": result.lanes_solved,
            "lanes_changed": result.lanes_changed,
            "lanes_gradient": result.lanes_gradient,
            "coordinates": result.coordinate_stats,
            "coordinates_refreshed": sum(1 for s in result.coordinate_stats.values()
                                         if s.get("refreshed")),
            "coordinates_carried": sum(1 for s in result.coordinate_stats.values()
                                       if not s.get("refreshed")),
        },
        "num_configurations": 1,
        "effective_coordinate_configurations": {
            name: format_coordinate_config(cfg) for name, cfg in params.coordinates.items()},
        "best_configuration_index": 0,
        "best_reg_weights": reg_weights,
        "best_metric": float("nan"),
        "metric_history": [],
    }
    summary["timings"] = timing_summary()
    with open(os.path.join(out, "training-summary.json"), "w") as f:
        json.dump(_json_safe(summary), f, indent=2, default=float)
    return summary


def _run_streaming(params: GameTrainingParams, job_log: PhotonLogger, device,
                   telemetry: SolverTelemetry | None = None) -> dict:
    """The ``--streaming-chunks`` GAME pipeline: one streaming scan (index
    maps, entity vocabularies, cluster keys and per-sample scalars; records
    dropped), an entity-clustered chunk source and ``StreamingGameProgram``
    sweeps, so the input never sits in memory whole. With
    ``--partitioned-io`` in a group of several ranks, the chunk plan is
    agreed over the exchange, each rank streams its slice, and the sweeps
    recover through the coordinated rollback. ``validate`` has restricted
    the surface (one dense FE and IDENTITY random effects, one λ each)."""
    from photon_ml_torch.algorithm.streaming_game import (
        DuHLChunkSchedule,
        DuHLScheduleConfig,
        StreamingGameProgram,
        score_game_stream,
    )
    from photon_ml_torch.io import avro as avro_io
    from photon_ml_torch.io.stream_reader import (
        GameAvroChunkSource,
        plan_partitioned_game_stream,
        scan_game_stream,
    )
    from photon_ml_torch.models.coefficients import Coefficients
    from photon_ml_torch.models.game import FixedEffectModel, GameModel, RandomEffectModel
    from photon_ml_torch.models.glm import GeneralizedLinearModel
    from photon_ml_torch.parallel.distributed import FixedEffectStepSpec, RandomEffectStepSpec

    out = params.root_output_dir
    sequence = tuple(params.update_sequence or params.coordinates.keys())
    fe_name = next(n for n in sequence if not params.coordinates[n].is_random_effect)
    fe_cfg = params.coordinates[fe_name]
    re_names = [n for n in sequence if n != fe_name]
    cluster_by = params.coordinates[re_names[0]].random_effect_type if re_names else None
    shard_ids = {fe_cfg.feature_shard} | {params.coordinates[n].feature_shard for n in re_names}
    shard_configs = {s: params.feature_shards[s] for s in shard_ids}
    re_columns = tuple(sorted(params.coordinates[n].random_effect_type for n in re_names))

    exchange = None
    coordinator = None
    partition = None
    scalars = None
    if params.partitioned_io and torch.distributed.get_world_size() > 1:
        if cluster_by is None:
            raise ValueError("--partitioned-io streamed GAME needs at least one random-effect "
                             "coordinate (its entities define the chunk partition); drop "
                             "--partitioned-io or add one")
        if params.validation_data_path:
            raise ValueError("--partitioned-io streamed GAME has no multi-rank validation "
                             "pass; drop --validation-data-path and score with the scoring "
                             "driver")
        exchange = multihost.default_exchange()
        schedule_budget = ({"working_set": params.duhl_working_set,
                            "tail_chunks": params.duhl_tail_chunks}
                           if params.duhl_working_set > 0 else None)
        with Timed("streaming scan"):
            source, index_maps, vocabs, partition = plan_partitioned_game_stream(
                params.input_data_path, shard_configs, re_columns, exchange=exchange,
                chunk_records=params.streaming_chunks, cluster_by=cluster_by,
                schedule_budget=schedule_budget, on_corrupt=params.on_corrupt)
        job_log.info("partitioned streamed plan %s: rank %d/%d holds chunks [%d, %d) of %d "
                     "(payload %d/%d input bytes)", partition.fingerprint, partition.rank,
                     partition.num_ranks, *partition.chunk_range(), partition.num_chunks,
                     partition.payload_bytes[partition.rank], partition.input_bytes)
        # a preempted rank becomes a rollback of every rank to the last
        # barrier-committed sweep (host-side key-value traffic only)
        coordinator = CoordinatedRecovery(exchange, max_restarts=params.max_restarts,
                                          journal=_journal_of(telemetry),
                                          description="partitioned streamed game train")
    else:
        files = avro_io.list_avro_files(params.input_data_path)
        with Timed("streaming scan"):
            index_maps, vocabs, cluster_keys, indexes, scalars = scan_game_stream(
                files, shard_configs, re_columns, cluster_by=cluster_by,
                on_corrupt=params.on_corrupt)
        source = GameAvroChunkSource(
            files, shard_configs, index_maps, chunk_records=params.streaming_chunks,
            random_effect_id_columns=re_columns, entity_vocabs=vocabs, cluster_by=cluster_by,
            cluster_keys=cluster_keys, indexes=indexes, on_corrupt=params.on_corrupt)
    job_log.info("streaming scan: %d files, shards %s, entities %s", len(source.files),
                 {k: v.size for k, v in index_maps.items()},
                 {k: len(v) for k, v in vocabs.items()})
    for shard_id, imap in index_maps.items():
        if isinstance(imap, IndexMap):
            imap.save(os.path.join(out, "index-maps"), shard_id)
    job_log.info("planned %d entity-clustered chunks (<=%d records requested, chunk_rows=%d)",
                 source.num_chunks, params.streaming_chunks, source.chunk_rows)

    def opt_config(cfg):
        return cfg.optimization_config(cfg.reg_weights[0])

    fe_opt = opt_config(fe_cfg)
    fe_spec = FixedEffectStepSpec(feature_shard_id=fe_cfg.feature_shard,
                                  optimizer=fe_opt.optimizer, l2_weight=fe_opt.l2_weight)
    re_specs = []
    for n in re_names:
        cfg = params.coordinates[n]
        o = opt_config(cfg)
        re_specs.append(RandomEffectStepSpec(re_type=cfg.random_effect_type,
                                             feature_shard_id=cfg.feature_shard,
                                             optimizer=o.optimizer, l2_weight=o.l2_weight))
    schedule = None
    if params.duhl_working_set > 0:
        # over ranks, the one schedule spans the global chunks
        schedule = DuHLChunkSchedule(
            DuHLScheduleConfig(working_set_chunks=params.duhl_working_set,
                               tail_chunks_per_sweep=params.duhl_tail_chunks),
            partition.num_chunks if partition is not None else source.num_chunks)
    checkpointer = (TrainingCheckpointer(os.path.join(params.checkpoint_dir, "streaming-game"))
                    if params.checkpoint_dir else None)
    sync = torch.cuda.synchronize if device.type == "cuda" else None

    def attempt(restart: int):
        program = StreamingGameProgram(
            params.task_type, source, fe_spec, tuple(re_specs),
            num_entities={t: len(vocabs[t]) for t in re_columns}, schedule=schedule,
            prefetch=params.streaming_prefetch, exchange=exchange, partition=partition,
            scalars=scalars, device=device)
        return program.train(
            num_sweeps=params.coordinate_descent_iterations, checkpointer=checkpointer,
            checkpoint_every=params.checkpoint_every, resume=params.resume or restart > 0,
            # a coordinated restart restores the published step on every rank
            resume_step=coordinator.resume_step if coordinator is not None else None,
            on_sweep=None if telemetry is None else (
                lambda sweep, total, loss: telemetry.heartbeat(
                    "game_streaming", sweep=sweep, num_sweeps=total, loss=loss)))

    if coordinator is not None:
        coordinator.rebind(checkpointer)
    with Timed("streamed game train", sync=sync):
        result = run_with_recovery(attempt, max_restarts=params.max_restarts,
                                   checkpointer=checkpointer, journal=_journal_of(telemetry),
                                   description="streamed game train", coordinator=coordinator)

    state = result.state
    models: dict = {fe_name: FixedEffectModel(
        glm=GeneralizedLinearModel(Coefficients(means=state.fe_coefficients), params.task_type),
        feature_shard_id=fe_cfg.feature_shard)}
    for n, spec in zip(re_names, re_specs):
        models[n] = RandomEffectModel(
            coefficients=state.re_tables[spec.re_type], entity_keys=vocabs[spec.re_type],
            random_effect_type=spec.re_type, feature_shard_id=spec.feature_shard_id,
            task=params.task_type)
    model = GameModel(models=models)
    reg_weights = {n: params.coordinates[n].reg_weights[0] for n in sequence}
    if params.model_output_mode != ModelOutputMode.NONE:
        with Timed("save model"):
            save_game_model(os.path.join(out, "best"), model, index_maps,
                            optimization_configurations={"regWeights": reg_weights})

    best_metric = float("nan")
    validation_metrics: dict = {}
    if params.validation_data_path:
        from photon_ml_torch.evaluation.evaluators import EvaluationData

        with Timed("streamed validation scoring", sync=sync):
            val_source = GameAvroChunkSource(
                avro_io.list_avro_files(params.validation_data_path), shard_configs,
                index_maps, chunk_records=params.streaming_chunks,
                random_effect_id_columns=re_columns, entity_vocabs=vocabs,
                on_corrupt=params.on_corrupt)
            val_scores, val_scalars = score_game_stream(
                state, val_source, params.task_type, fe_cfg.feature_shard,
                {spec.re_type: spec.feature_shard_id for spec in re_specs},
                prefetch=params.streaming_prefetch, return_scalars=True)
        val_data = EvaluationData(labels=val_scalars["labels"], offsets=val_scalars["offsets"],
                                  weights=val_scalars["weights"], ids={})
        for spec_str in params.evaluators:
            validation_metrics[spec_str] = float(
                parse_evaluator(spec_str).evaluate(val_scores, val_data))
        if params.evaluators:
            best_metric = validation_metrics[params.evaluators[0]]
        job_log.info("streamed validation: %d records, metrics %s", val_source.total_records,
                     validation_metrics)

    summary: dict = {
        "distributed": False,
        "streaming": {
            "chunks": partition.num_chunks if partition is not None else source.num_chunks,
            "chunk_rows": source.chunk_rows,
            "records": (partition.total_records if partition is not None
                        else source.total_records),
            "schedule": "duhl" if schedule is not None else "uniform",
            "chunk_loads": result.chunk_loads,
            "chunk_visits": result.chunk_visits,
            "sweeps": result.sweeps,
            **({} if partition is None else {"partitioned": {
                "plan": partition.fingerprint, "rank": partition.rank,
                "num_ranks": partition.num_ranks, "chunk_range": list(partition.chunk_range()),
                "rank_records": source.total_records, "bytes_decoded": source.bytes_decoded,
                "input_bytes": partition.input_bytes}}),
        },
        "num_configurations": 1,
        "effective_coordinate_configurations": {
            name: format_coordinate_config(cfg) for name, cfg in params.coordinates.items()},
        "best_configuration_index": 0,
        "best_reg_weights": reg_weights,
        "best_metric": best_metric,
        "validation_metrics": validation_metrics,
        "losses": [float(x) for x in result.losses],
        "metric_history": [],
    }
    if _journal_of(telemetry) is not None:
        telemetry.journal.record(
            "config", task_type=params.task_type.name, distributed=False,
            streaming_chunks=params.streaming_chunks, duhl_working_set=params.duhl_working_set,
            partitioned_ranks=partition.num_ranks if partition is not None else 1,
            num_configurations=1)
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
    p.add_argument("--hyperparameter-tuning", default="NONE", choices=TUNING_MODES)
    p.add_argument("--hyperparameter-tuning-iter", type=int, default=10)
    p.add_argument("--hyperparameter-tuning-range", default="1e-4,1e4",
                   help="low,high λ search range (log-scale)")
    p.add_argument("--hyperparameter-prior-json",
                   help="tuned-hyperparameters.json from a previous run, used to seed the "
                        "search")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--index-maps-dir",
                   help="reuse index stores built by the feature indexing driver (plain "
                        ".keys or off-heap .photonix)")
    p.add_argument("--override-output", action="store_true")
    p.add_argument("--checkpoint-dir",
                   help="checkpoints, one directory per configuration; a rerun resumes")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save every N coordinate updates (fused sweeps with --distributed)")
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=True,
                   help="resume from existing checkpoints (--no-resume: a fresh run)")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler trace (CPU and CUDA activity, Chrome-trace "
                        "JSON) of the run here")
    p.add_argument("--telemetry-dir",
                   help="write rank 0's JSONL run journal (config, phase timings, "
                        "per-coordinate convergence rows, heartbeats, the metrics registry's "
                        "snapshot) here")
    p.add_argument("--trace-dir",
                   help="write every rank's host span timeline (trace-<rank>.json, "
                        "Chrome-trace JSON) here; the straggler report goes to the journal")
    p.add_argument("--compact-random-effect-threshold", type=int,
                   default=DEFAULT_COMPACT_RE_THRESHOLD,
                   help="warm-start RE models over this feature-space size load as compact "
                        "per-entity tables")
    p.add_argument("--distributed", action="store_true",
                   help="train through the fused program over a data-axis mesh of every rank "
                        "(torchrun --nproc-per-node N, or one process alone)")
    p.add_argument("--mesh", default="",
                   help="data=N[,model=M]: the mesh's shape (implies --distributed; "
                        "model>1 feature-shards the primary fixed effect)")
    p.add_argument("--partitioned-io", action="store_true",
                   help="each rank decodes ~1/P of the input bytes (per-rank partitioned Avro "
                        "ingestion; needs --distributed or --mesh, or --streaming-chunks; no "
                        "validation data)")
    p.add_argument("--on-corrupt", default="raise", choices=["raise", "quarantine"],
                   help="corrupt Avro blocks: 'raise' (strict, default) or 'quarantine' "
                        "(skip-and-count)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="restarts of a configuration after a divergence (with a checkpoint) "
                        "or a transient failure (0 disables); coordinated over the ranks of "
                        "a partitioned run")
    p.add_argument("--streaming-chunks", type=int, default=0,
                   help="out-of-core streamed GAME: records per entity-clustered chunk (> 0 "
                        "opts in; dense single-FE + IDENTITY-RE configs over an entity-sorted "
                        "Avro input)")
    p.add_argument("--no-streaming-prefetch", action="store_true",
                   help="decode chunks inline instead of behind the current one")
    p.add_argument("--duhl-working-set", type=int, default=0,
                   help="DuHL schedule: pin this many chunks of the largest importance and "
                        "visit the cold tail round-robin (0: uniform order)")
    p.add_argument("--duhl-tail-chunks", type=int, default=1,
                   help="cold chunks visited a sweep under --duhl-working-set")
    p.add_argument("--incremental-refresh", action="store_true",
                   help="incremental retrain: solve again only the RE entities that saw new "
                        "data or whose gradient at the resident solution exceeds tolerance, "
                        "against frozen residuals — needs --model-input-dir or "
                        "--checkpoint-dir (the resident model)")
    p.add_argument("--refresh-gradient-tolerance", type=float, default=1e-4,
                   help="solve again entities whose solve-space gradient norm at the resident "
                        "solution exceeds this (0 disables the screen: only declared entities)")
    p.add_argument("--refresh-changed-entities", action="append", default=[],
                   help="reType=key1|key2 — entities declared changed (repeatable)")
    p.add_argument("--refresh-fixed-effects", action="store_true",
                   help="also solve the fixed-effect coordinates again (warm-started)")
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
        hyperparameter_tuning_iter=args.hyperparameter_tuning_iter,
        hyperparameter_tuning_range=tuple(
            float(x) for x in args.hyperparameter_tuning_range.split(",")),
        hyperparameter_prior_json=args.hyperparameter_prior_json,
        input_format=args.input_format,
        index_maps_dir=args.index_maps_dir,
        override_output=args.override_output,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        profile_dir=args.profile_dir,
        telemetry_dir=args.telemetry_dir,
        trace_dir=args.trace_dir,
        compact_random_effect_threshold=args.compact_random_effect_threshold,
        distributed=args.distributed or bool(args.mesh),
        mesh_shape=parse_mesh_shape(args.mesh),
        partitioned_io=args.partitioned_io,
        on_corrupt=args.on_corrupt,
        max_restarts=args.max_restarts,
        streaming_chunks=args.streaming_chunks,
        streaming_prefetch=not args.no_streaming_prefetch,
        duhl_working_set=args.duhl_working_set,
        duhl_tail_chunks=args.duhl_tail_chunks,
        incremental_refresh=args.incremental_refresh,
        refresh_gradient_tolerance=args.refresh_gradient_tolerance,
        refresh_changed_entities=tuple(args.refresh_changed_entities),
        refresh_fixed_effects=args.refresh_fixed_effects,
    )


def parse_mesh_shape(spec: str) -> dict[str, int] | None:
    """'data=8,model=1' -> {"data": 8, "model": 1}; '' -> None."""
    if not spec:
        return None
    out: dict[str, int] = {}
    for part in spec.split(","):
        if not part.strip():
            continue
        key, _, value = part.partition("=")
        key = key.strip()
        if key not in ("data", "model") or not value.strip().isdigit() or int(value) < 1:
            raise ValueError(f"bad --mesh component {part!r}; expected data=N,model=M with "
                             "N,M >= 1")
        out[key] = int(value)
    return out


def main(argv: Sequence[str] | None = None, *, device=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return run(parse_args(argv), device=device)


if __name__ == "__main__":
    main()
