"""Single-GLM training driver with the staged pipeline (the port's driver).

Counterpart of ``photon_ml_tpu/cli/glm_driver.py`` on its in-core Avro path;
reference photon-client Driver.scala — staged pipeline INIT -> PREPROCESSED
-> TRAINED -> VALIDATED -> DIAGNOSED (:158-218), train via ModelTraining
over the λ grid with warm starts (:334-368), validation metrics +
best-model selection (:373-450, ModelSelection.scala), diagnostics and the
HTML report (:608-635, 719-739), text model output (IOUtils
writeModelsInText, :211-215).

    python -m photon_ml_torch.cli.glm_driver --input-data-path train \\
        --validation-data-path val --output-dir out \\
        --task-type LOGISTIC_REGRESSION --regularization-weights 1,10

Runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU. The
flags keep the JAX driver's names and meanings. ``--streaming-chunks N``
trains out of core: the data is never read whole, and every objective
evaluation is one chunked epoch over the Avro blocks
(``estimators.train_glm_streaming``), with ``--no-streaming-prefetch``
decoding inline. ``--checkpoint-dir`` (streaming only) saves the solver's
state every ``--checkpoint-every`` iterations and at each λ, and a rerun
resumes from it; ``--max-restarts`` restarts the stages after a transient
failure (``resilience/recovery.py``), resuming from the checkpoint; its
default is 2, the JAX driver's. ``--grid-parallel`` trains the whole λ grid
at once as solver lanes (``estimators.train_glm_grid``), and
``--search-rounds N`` replaces the grid by a GP-driven model search over
``--search-space`` with ``--search-lane-budget`` configurations a round
(``hyperparameter/search_driver.run_model_search``), selected by the
validation metric. ``--enable-diagnostics`` (with a validation path) writes
``diagnostic-report.html`` and ``diagnostic-report.txt`` for the best λ:
fitting curves, Hosmer-Lemeshow or Kendall's tau, feature importance and,
with ``--num-bootstraps`` of 2 or more, the bootstrap chapter; every refit
trains through the same ``train_glm``. ``--telemetry-dir`` writes a JSONL
run journal (the configuration, a convergence row and a heartbeat a λ,
phase timings, the program ledger's rows and the ``jax/backend_compile_count``
gauge, the metrics registry's snapshot; on success and on failure) and
``--trace-dir`` the host span timeline (``trace-00000.json``), flushed
before the journal's last rows. The module's ``events`` emitter sends the
setup, start, finish and per-λ optimization events to its listeners.
``--input-format libsvm`` reads LibSVM text (``io/libsvm.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from photon_ml_torch.data.batch import LabeledPointBatch, summarize
from photon_ml_torch.data.validators import DataValidationType, validate_arrays
from photon_ml_torch.cli.game_training_driver import _close_journal, _install_ledger
from photon_ml_torch.device import resolve_device
from photon_ml_torch.diagnostics.metrics import METRIC_DIRECTIONS, evaluate_model
from photon_ml_torch.diagnostics.report_builder import build_diagnostic_report
from photon_ml_torch.diagnostics.reporting import render_html, render_text
from photon_ml_torch.estimators import train_glm, train_glm_grid, train_glm_streaming
from photon_ml_torch.io.data_reader import FeatureShardConfiguration, read_merged
from photon_ml_torch.io.model_io import write_glm_text
from photon_ml_torch.ops.normalization import NormalizationType, build_normalization
from photon_ml_torch.optim.optimizer import OptimizerConfig, OptimizerType
from photon_ml_torch.telemetry import (
    CompileMonitor,
    RunJournal,
    Tracer,
    default_registry,
    flush_trace_best_effort,
    install_tracer,
    io_counters,
    uninstall_tracer,
)
from photon_ml_torch.telemetry.layout import reset_layout_metrics
from photon_ml_torch.telemetry.resilience_counters import reset_resilience_metrics
from photon_ml_torch.telemetry.solver_trace import SolverTelemetry, reset_solver_metrics
from photon_ml_torch.telemetry.stream_counters import reset_stream_metrics
from photon_ml_torch.types import TaskType
from photon_ml_torch.util import (
    EventEmitter,
    PhotonLogger,
    SetupEvent,
    Timed,
    TrainingFinishEvent,
    TrainingStartEvent,
)
from photon_ml_torch.util.timed import reset_timings

logger = logging.getLogger(__name__)

#: process-wide emitter: external telemetry registers listeners here (the
#: reference emitted PhotonSetupEvent, TrainingStart/Finish and per-update
#: PhotonOptimizationLogEvents from Driver.scala:120-393)
events = EventEmitter()


class DriverStage(enum.Enum):
    """Reference: DriverStage.scala."""

    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


#: model selection metric per task (reference ModelSelection.scala: best
#: AUC for classification, best RMSE for regression)
_SELECTION_METRIC = {
    TaskType.LOGISTIC_REGRESSION: "AUC",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: "AUC",
    TaskType.LINEAR_REGRESSION: "RMSE",
    TaskType.POISSON_REGRESSION: "POISSON_LOSS",
}


@dataclasses.dataclass
class GLMDriverParams:
    input_data_path: str
    output_dir: str
    task_type: TaskType
    validation_data_path: str | None = None
    regularization_weights: tuple[float, ...] = (0.0,)
    elastic_net_alpha: float = 0.0
    optimizer: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    normalization: NormalizationType = NormalizationType.NONE
    data_validation: DataValidationType = DataValidationType.VALIDATE_DISABLED
    compute_variance: bool = False
    #: JSON constraint list (reference Params.constraintString): maps with
    #: name/term (+ optional lowerBound/upperBound), "*" wildcards allowed
    coefficient_box_constraints: str | None = None
    input_format: str = "avro"
    #: "raise" (strict) or "quarantine" (skip-and-count corrupt Avro blocks)
    on_corrupt: str = "raise"
    #: out-of-core epochs: records per chunk (> 0 opts in; 0 reads in core)
    streaming_chunks: int = 0
    #: False decodes the chunks inline (no background decode thread)
    streaming_prefetch: bool = True
    #: streamed solves' checkpoints (io/checkpoint.SolverCheckpointer);
    #: needs streaming_chunks
    checkpoint_dir: str | None = None
    #: iterations between mid-solve checkpoints (λ boundaries always save)
    checkpoint_every: int = 1
    #: restarts after a transient failure (resilience/recovery.py)
    max_restarts: int = 2
    #: train the λ grid at once as solver lanes (LBFGS/OWLQN)
    grid_parallel: bool = False
    #: GP-driven model search (hyperparameter/search_driver.py): > 0 opts in
    #: and replaces the λ grid; needs a validation path and a search space
    search_rounds: int = 0
    #: configurations a round (solver lanes of one tournament)
    search_lane_budget: int = 8
    #: the search space, e.g. "lambda=1e-4:1e2:log,alpha=0:1,
    #: tolerance=1e-9:1e-5:log" (search_driver.parse_search_space)
    search_space: str | None = None
    #: one SeedSequence threads the Sobol scramble and the GP slice sampler
    search_seed: int = 0
    #: the DIAGNOSED stage: the diagnostic report of the best λ (needs a
    #: validation path); num_bootstraps >= 2 adds the bootstrap chapter
    enable_diagnostics: bool = False
    num_bootstraps: int = 0
    #: JSONL run journal dir (telemetry/journal.py); None = off
    telemetry_dir: str | None = None
    #: span timeline dir (telemetry/tracing.py); None = off
    trace_dir: str | None = None


@dataclasses.dataclass
class GLMDriverResult:
    stage: DriverStage
    models: dict
    best_lambda: float | None
    validation_metrics: dict
    summary_path: str


def _read_batch(path: str, fmt: str, shard_cfg, device, index_maps=None,
                on_corrupt: str = "raise"):
    """(batch, dataset, index maps, intercept index) of one Avro or LibSVM input."""
    result = read_merged(path, shard_cfg, index_maps=index_maps, fmt=fmt, on_corrupt=on_corrupt,
                         device=device)
    ds = result.dataset
    batch = LabeledPointBatch(features=ds.feature_shards["features"], labels=ds.labels,
                              offsets=ds.offsets, weights=ds.weights)
    return batch, ds, result.index_maps, result.intercept_indices.get("features")


def _check_streaming_supported(params: GLMDriverParams) -> None:
    """The streamed path never holds the whole batch: refuse, before any data
    is read, the stages that need it."""
    if params.input_format != "avro":
        raise ValueError(
            "--streaming-chunks streams Avro container blocks; for "
            "libsvm inputs drop --streaming-chunks (or convert with "
            "cli/libsvm_to_avro.py and stream the result)")
    if params.grid_parallel:
        raise ValueError(
            "--streaming-chunks trains the λ grid sequentially with warm "
            "starts (vmapped grid lanes need the in-core batch); drop "
            "--grid-parallel")
    if params.compute_variance:
        raise ValueError(
            "coefficient variances decompose the in-core Hessian; drop "
            "--compute-variance or run without --streaming-chunks")
    if params.optimizer == OptimizerType.NEWTON:
        raise ValueError(
            "NEWTON needs the dense [d, d] Hessian; use --optimizer TRON "
            "for streamed second-order solves")


def _check_search_supported(params: GLMDriverParams) -> None:
    """Fail fast, naming the alternative, before any data is read."""
    if not params.search_space:
        raise ValueError(
            "--search-rounds needs --search-space (grammar: "
            "name=low:high[:log][:int], comma-separated; e.g. "
            "'lambda=1e-4:1e2:log,alpha=0:1')")
    if not params.validation_data_path:
        raise ValueError(
            "--search-rounds selects by the validation metric; pass "
            "--validation-data-path")
    if params.streaming_chunks > 0:
        raise ValueError(
            "--search-rounds trains vmapped tournament lanes on the "
            "in-core batch; drop --streaming-chunks (stream-compose the "
            "winning config afterwards instead)")
    if params.grid_parallel:
        raise ValueError(
            "--search-rounds replaces the λ grid (tournament lanes ARE "
            "the grid generalization); drop --grid-parallel")
    if params.elastic_net_alpha:
        raise ValueError(
            "the elastic-net mix is a search dimension — add 'alpha=0:1' "
            "to --search-space instead of --elastic-net-alpha")
    if params.enable_diagnostics or params.num_bootstraps:
        raise ValueError(
            "diagnostics re-fit the λ grid; run them on the winning "
            "config without --search-rounds")
    if params.compute_variance:
        raise ValueError(
            "coefficient variances are not computed per tournament lane; "
            "re-fit the winning config with --compute-variance")


def _check_checkpoint_supported(params: GLMDriverParams) -> None:
    if params.checkpoint_dir and params.streaming_chunks <= 0:
        raise ValueError(
            "--checkpoint-dir resumes STREAMING solves (epoch-granular "
            "solver state; io/checkpoint.SolverCheckpointer) — pass "
            "--streaming-chunks N to opt in, or drop --checkpoint-dir "
            "(the in-core path re-runs from scratch under --max-restarts)")
    if params.max_restarts < 0:
        raise ValueError("--max-restarts must be >= 0")
    if params.checkpoint_every < 1:
        raise ValueError("--checkpoint-every must be >= 1")


def _prepare_streaming(params: GLMDriverParams, shard_cfg, device):
    """The streamed PREPROCESS: the index map from one pass that keeps no
    record, the chunk source over the block plan, per-chunk validation, and
    the normalization statistics from one streamed pass."""
    from photon_ml_torch.algorithm.streaming import streaming_summarize
    from photon_ml_torch.io.avro import list_avro_files
    from photon_ml_torch.io.index_map import INTERCEPT_KEY
    from photon_ml_torch.io.stream_reader import (
        AvroChunkSource,
        ChunkPrefetcher,
        DenseRecordAssembler,
        build_streaming_index_maps,
    )
    from photon_ml_torch.resilience import default_io_policy

    files = list_avro_files(params.input_data_path)
    # the full read's journal evidence (read_partitioned sets it there)
    io_counters.set_input_bytes_total(sum(int(os.path.getsize(f)) for f in files))
    index_maps = default_io_policy().call(
        lambda: build_streaming_index_maps(files, shard_cfg, on_corrupt=params.on_corrupt),
        description=f"streaming vocab pass over {params.input_data_path}")
    imap = index_maps["features"]
    intercept_index = imap.get_index(INTERCEPT_KEY)
    if intercept_index < 0:
        intercept_index = None
    source = AvroChunkSource(files, DenseRecordAssembler(imap, shard_cfg["features"]),
                             chunk_records=params.streaming_chunks,
                             on_corrupt=params.on_corrupt)
    if params.data_validation != DataValidationType.VALIDATE_DISABLED:
        # the true rows of each chunk (the zero-weight padding is layout)
        with ChunkPrefetcher(source, prefetch=False) as chunks:
            for chunk, spec in zip(chunks, source.specs):
                n = spec.num_records
                validate_arrays(labels=chunk.labels[:n], task=params.task_type,
                                offsets=chunk.offsets[:n], weights=chunk.weights[:n],
                                feature_shards={"features": chunk.features[:n]},
                                validation_type=params.data_validation)
    norm = None
    if params.normalization != NormalizationType.NONE:
        stats = streaming_summarize(source, prefetch=params.streaming_prefetch)
        stat = {k: torch.as_tensor(stats[k], dtype=torch.float32, device=device)
                for k in ("mean", "variance", "max_magnitude")}
        norm = build_normalization(params.normalization, **stat, intercept_index=intercept_index)
    return source, index_maps, intercept_index, norm


def run(params: GLMDriverParams, *, device=None) -> GLMDriverResult:
    """The staged pipeline on ``device`` (CUDA unless "cpu"), restarted up
    to ``max_restarts`` times after a transient failure."""
    from photon_ml_torch.resilience import run_with_recovery

    if params.streaming_chunks > 0:
        _check_streaming_supported(params)
    if params.search_rounds > 0:
        _check_search_supported(params)
    _check_checkpoint_supported(params)
    device = resolve_device(device)
    if params.coefficient_box_constraints and params.normalization != NormalizationType.NONE:
        # bounds are stated in original feature space; the solvers work in
        # normalized space (reference Params.scala:219)
        raise ValueError(
            "coefficient box constraints cannot combine with feature normalization (bounds "
            "are stated in original feature space; the solvers work in normalized space) — "
            "drop normalization.type or the box constraints")
    os.makedirs(params.output_dir, exist_ok=True)
    # per-run phase timings and tallies (a sweep may call run() again)
    reset_timings()
    reset_solver_metrics()
    reset_layout_metrics()
    reset_stream_metrics()
    reset_resilience_metrics()
    journal = RunJournal(params.telemetry_dir) if params.telemetry_dir else None
    # the emitter rides along always; SolverTelemetry builds no row (and
    # reads nothing from the device) unless a sink consumes it
    telemetry = SolverTelemetry(journal=journal, emitter=events,
                                registry=default_registry() if journal and journal.active
                                else None)
    config_summary = {
        "task_type": params.task_type.name,
        "optimizer": params.optimizer.name,
        "regularization_weights": list(params.regularization_weights),
        "grid_parallel": params.grid_parallel,
        "max_iterations": params.max_iterations,
        "tolerance": params.tolerance,
        "normalization": params.normalization.name,
        "streaming_chunks": params.streaming_chunks,
        "streaming_prefetch": params.streaming_prefetch,
        "search_rounds": params.search_rounds,
        "search_lane_budget": params.search_lane_budget,
        "search_space": params.search_space,
        "checkpoint_dir": params.checkpoint_dir,
        "max_restarts": params.max_restarts,
        "trace_dir": params.trace_dir,
    }
    events.send(SetupEvent(config_summary=json.dumps(config_summary)))
    events.send(TrainingStartEvent(job_name="glm-training"))
    if journal is not None:
        journal.record("config", **config_summary)
    compiles = CompileMonitor()
    checkpointer = None
    if params.checkpoint_dir:
        from photon_ml_torch.io.checkpoint import SolverCheckpointer

        checkpointer = SolverCheckpointer(params.checkpoint_dir,
                                          save_every=params.checkpoint_every)
    # installed right before the try whose finally removes them, early
    # enough that a failed read still leaves a timeline
    ledger = _install_ledger(journal)
    tracer = install_tracer(Tracer()) if params.trace_dir else None
    try:
        with compiles:
            result = run_with_recovery(
                lambda restart: _run_stages(params, device, checkpointer, telemetry),
                max_restarts=params.max_restarts, checkpointer=checkpointer, journal=journal,
                description="glm training")
        events.send(TrainingFinishEvent(job_name="glm-training", succeeded=True))
        return result
    except Exception:
        events.send(TrainingFinishEvent(job_name="glm-training", succeeded=False))
        raise
    finally:
        # the trace flushes first, so a crash leaves a timeline even when
        # journaling fails; a publication error never masks the outcome
        if tracer is not None:
            try:
                flush_trace_best_effort(tracer, params.trace_dir, journal=journal)
            finally:
                uninstall_tracer()
        _close_journal(journal, ledger,
                       gauges={"jax/backend_compile_count": lambda: compiles.count})


def _run_stages(params: GLMDriverParams, device, checkpointer,
                telemetry: SolverTelemetry | None = None) -> GLMDriverResult:
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    stage = DriverStage.INIT
    shard_cfg = {"features": FeatureShardConfiguration(feature_bags=("features",))}
    streaming = params.streaming_chunks > 0

    with PhotonLogger(os.path.join(params.output_dir, "driver.log")) as job_log:
        # PREPROCESS
        with Timed("glm preprocess", sync=sync):
            if streaming:
                source, index_maps, intercept_index, norm = _prepare_streaming(
                    params, shard_cfg, device)
            else:
                batch, ds, index_maps, intercept_index = _read_batch(
                    params.input_data_path, params.input_format, shard_cfg, device,
                    on_corrupt=params.on_corrupt)
                validate_arrays(
                    labels=ds.host_array("labels"), task=params.task_type,
                    offsets=ds.host_array("offsets"), weights=ds.host_array("weights"),
                    feature_shards={"features": ds.host_array("shard/features")},
                    validation_type=params.data_validation)
                norm = None
                if params.normalization != NormalizationType.NONE:
                    stats = summarize(ds.host_array("shard/features"), ds.host_array("weights"))
                    stat = {k: torch.as_tensor(stats[k], dtype=batch.labels.dtype,
                                               device=device)
                            for k in ("mean", "variance", "max_magnitude")}
                    norm = build_normalization(params.normalization, **stat,
                                               intercept_index=intercept_index)
        stage = DriverStage.PREPROCESSED
        if streaming:
            job_log.info("preprocessed %d samples, %d features (streaming: %d chunks of <=%d "
                         "records)", source.total_records, source.dim, source.num_chunks,
                         params.streaming_chunks)
        else:
            job_log.info("preprocessed %d samples, %d features", batch.num_samples, batch.dim)

        # TRAIN
        opt = OptimizerConfig(optimizer_type=params.optimizer,
                              max_iterations=params.max_iterations, tolerance=params.tolerance)
        lower_bounds = upper_bounds = None
        if params.coefficient_box_constraints:
            from photon_ml_torch.io.constraints import build_bound_arrays

            lower_bounds, upper_bounds = build_bound_arrays(
                params.coefficient_box_constraints, index_maps["features"])

        def fit(b: LabeledPointBatch, lams, tel=None) -> dict:
            trainer = train_glm_grid if params.grid_parallel else train_glm
            return trainer(
                b, params.task_type, optimizer=opt, regularization_weights=lams,
                elastic_net_alpha=params.elastic_net_alpha, normalization=norm,
                intercept_index=intercept_index, compute_variance=params.compute_variance,
                lower_bounds=lower_bounds, upper_bounds=upper_bounds, telemetry=tel)

        val_batch = None
        search_outcome = None
        with Timed("glm train", sync=sync):
            if params.search_rounds > 0:
                from photon_ml_torch.hyperparameter.search_driver import (
                    parse_search_space,
                    run_model_search,
                )

                # the validation batch is the tournament's metric input too;
                # VALIDATE below reuses it
                val_batch, _, _, _ = _read_batch(params.validation_data_path,
                                                 params.input_format, shard_cfg, device,
                                                 index_maps, on_corrupt=params.on_corrupt)
                search_outcome = run_model_search(
                    batch, val_batch, params.task_type, parse_search_space(params.search_space),
                    rounds=params.search_rounds, lane_budget=params.search_lane_budget,
                    optimizer=opt, seed=params.search_seed,
                    evaluator=_SELECTION_METRIC[params.task_type], normalization=norm,
                    intercept_index=intercept_index, box_lower=lower_bounds,
                    box_upper=upper_bounds,
                    journal=None if telemetry is None else telemetry.journal,
                    telemetry=telemetry)
                models = {search_outcome.best_config["lambda"]: search_outcome.best_model}
                job_log.info("search best %s=%s config=%s (%d configs over %d rounds)",
                             search_outcome.evaluator_name, search_outcome.best_metric,
                             search_outcome.best_config,
                             params.search_rounds * params.search_lane_budget,
                             params.search_rounds)
            elif streaming:
                models = train_glm_streaming(
                    source, params.task_type, optimizer=opt,
                    regularization_weights=params.regularization_weights,
                    elastic_net_alpha=params.elastic_net_alpha, normalization=norm,
                    intercept_index=intercept_index, prefetch=params.streaming_prefetch,
                    lower_bounds=lower_bounds, upper_bounds=upper_bounds,
                    checkpointer=checkpointer, telemetry=telemetry, device=device)
            else:
                # telemetry on the primary grid only: the diagnostics' refits
                # below would repeat per-λ convergence rows
                models = fit(batch, params.regularization_weights, tel=telemetry)
        stage = DriverStage.TRAINED
        with Timed("glm write models"):
            write_glm_text(os.path.join(params.output_dir, "models-text"), models,
                           index_maps["features"])

        # VALIDATE
        best_lambda = None
        validation_metrics: dict = {}
        if params.validation_data_path:
            with Timed("glm validate", sync=sync):
                if val_batch is None:
                    val_batch, _, _, _ = _read_batch(params.validation_data_path,
                                                     params.input_format, shard_cfg, device,
                                                     index_maps, on_corrupt=params.on_corrupt)
                metric = _SELECTION_METRIC[params.task_type]
                larger = METRIC_DIRECTIONS[metric]
                best_value = None
                for lam, model in sorted(models.items()):
                    m = evaluate_model(model, val_batch)
                    validation_metrics[lam] = m
                    value = m[metric]
                    if np.isnan(value):  # a diverged model never wins
                        continue
                    if best_value is None or (value > best_value) == larger:
                        best_value, best_lambda = value, lam
            stage = DriverStage.VALIDATED
            job_log.info("best λ=%s by %s=%s", best_lambda, metric, best_value)

        # DIAGNOSE
        if params.enable_diagnostics:
            if val_batch is None:
                raise ValueError("diagnostics require --validation-data-path")
            if best_lambda is None:
                raise ValueError(
                    "no model produced a finite validation metric; nothing to diagnose")
            with Timed("glm diagnose", sync=sync):
                report = build_diagnostic_report(
                    models, batch, val_batch, task=params.task_type,
                    train_fn_for_lambda=lambda lam: (lambda b: fit(b, (lam,))[lam]),
                    best_lambda=best_lambda, index_map=index_maps["features"],
                    num_bootstraps=params.num_bootstraps, validation_metrics=validation_metrics)
                with open(os.path.join(params.output_dir, "diagnostic-report.html"), "w") as f:
                    f.write(render_html(report))
                with open(os.path.join(params.output_dir, "diagnostic-report.txt"), "w") as f:
                    f.write(render_text(report))
            stage = DriverStage.DIAGNOSED

    summary_path = os.path.join(params.output_dir, "glm-summary.json")
    summary = {
        "stage": stage.name,
        "lambdas": sorted(models),
        "best_lambda": best_lambda,
        "validation_metrics": {str(k): v for k, v in validation_metrics.items()},
    }
    if search_outcome is not None:
        summary["search"] = {
            "best_config": search_outcome.best_config,
            "best_metric": search_outcome.best_metric,
            "metric": search_outcome.evaluator_name,
            "rounds": len(search_outcome.trajectory),
            "configs": len(search_outcome.observations),
        }
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2, default=float)
    return GLMDriverResult(stage=stage, models=models, best_lambda=best_lambda,
                           validation_metrics=validation_metrics, summary_path=summary_path)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="glm_driver", description=__doc__.split("\n")[0])
    p.add_argument("--input-data-path", required=True)
    p.add_argument("--validation-data-path")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--task-type", required=True,
                   choices=[t.name for t in TaskType if t != TaskType.NONE])
    p.add_argument("--regularization-weights", default="0", help="comma-separated λ grid")
    p.add_argument("--elastic-net-alpha", type=float, default=0.0)
    p.add_argument("--optimizer", default="LBFGS", choices=[o.name for o in OptimizerType])
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument("--normalization", default="NONE",
                   choices=[n.name for n in NormalizationType])
    p.add_argument("--data-validation", default="VALIDATE_DISABLED",
                   choices=[v.name for v in DataValidationType])
    p.add_argument("--compute-variance", action="store_true")
    p.add_argument("--coefficient-box-constraints",
                   help='JSON constraint list, e.g. \'[{"name": "f0", "term": "", '
                        '"lowerBound": 0}]\'; "*" wildcards match all features / all terms '
                        "of a name")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--on-corrupt", default="raise", choices=["raise", "quarantine"],
                   help="corrupt Avro blocks: 'raise' (strict, default) or 'quarantine' "
                        "(skip-and-count)")
    p.add_argument("--enable-diagnostics", action="store_true",
                   help="write diagnostic-report.{html,txt} for the best λ (needs "
                        "--validation-data-path)")
    p.add_argument("--num-bootstraps", type=int, default=0,
                   help="bootstrap refits of the diagnostic report (>= 2 adds its chapter)")
    p.add_argument("--grid-parallel", action="store_true",
                   help="train all regularization weights simultaneously as "
                        "solver lanes (LBFGS/OWLQN only)")
    p.add_argument("--telemetry-dir",
                   help="write a JSONL run journal (config, per-λ convergence rows, phase "
                        "timings, the metrics registry's snapshot) here")
    p.add_argument("--trace-dir",
                   help="write the host span timeline (trace-00000.json, Chrome-trace JSON) "
                        "here")
    p.add_argument("--streaming-chunks", type=int, default=0,
                   help="out-of-core epochs: records per chunk (0 reads the data in core)")
    p.add_argument("--no-streaming-prefetch", action="store_true",
                   help="decode each chunk inline instead of in a background thread")
    p.add_argument("--checkpoint-dir",
                   help="checkpoints of --streaming-chunks solves: a rerun resumes from them")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="solver iterations between mid-solve checkpoints (λ boundaries "
                        "always save)")
    p.add_argument("--max-restarts", type=int, default=2,
                   help="restarts after a transient failure, resuming from --checkpoint-dir "
                        "(0 disables)")
    p.add_argument("--search-rounds", type=int, default=0,
                   help="GP-driven model search: rounds of config tournaments (> 0 opts "
                        "in; replaces --regularization-weights; requires "
                        "--validation-data-path and --search-space)")
    p.add_argument("--search-lane-budget", type=int, default=8,
                   help="configs per tournament round (solver lanes sharing one "
                        "feature-block read)")
    p.add_argument("--search-space",
                   help="search-space grammar: name=low:high[:log][:int], comma-separated; "
                        "dims: lambda (required), alpha, tolerance, box — e.g. "
                        "'lambda=1e-4:1e2:log,alpha=0:1'")
    p.add_argument("--search-seed", type=int, default=0,
                   help="one SeedSequence threads Sobol + the GP slice sampler; a "
                        "trajectory replays deterministically under a fixed seed")
    return p


def main(argv: Sequence[str] | None = None, *, device=None) -> GLMDriverResult:
    logging.basicConfig(level=logging.INFO)
    args = build_arg_parser().parse_args(argv)
    return run(
        GLMDriverParams(
            input_data_path=args.input_data_path,
            validation_data_path=args.validation_data_path,
            output_dir=args.output_dir,
            task_type=TaskType[args.task_type],
            regularization_weights=tuple(
                float(x) for x in args.regularization_weights.split(",") if x),
            elastic_net_alpha=args.elastic_net_alpha,
            optimizer=OptimizerType[args.optimizer],
            max_iterations=args.max_iterations,
            tolerance=args.tolerance,
            normalization=NormalizationType[args.normalization],
            data_validation=DataValidationType[args.data_validation],
            compute_variance=args.compute_variance,
            coefficient_box_constraints=args.coefficient_box_constraints,
            input_format=args.input_format,
            on_corrupt=args.on_corrupt,
            enable_diagnostics=args.enable_diagnostics,
            num_bootstraps=args.num_bootstraps,
            grid_parallel=args.grid_parallel,
            telemetry_dir=args.telemetry_dir,
            trace_dir=args.trace_dir,
            streaming_chunks=args.streaming_chunks,
            streaming_prefetch=not args.no_streaming_prefetch,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            max_restarts=args.max_restarts,
            search_rounds=args.search_rounds,
            search_lane_budget=args.search_lane_budget,
            search_space=args.search_space,
            search_seed=args.search_seed,
        ),
        device=device,
    )


if __name__ == "__main__":
    main()
