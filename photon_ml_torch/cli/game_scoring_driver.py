"""GAME scoring driver: load a model, score a dataset, save scores (the port's).

Counterpart of ``photon_ml_tpu/cli/game_scoring_driver.py`` on its
one-device and mesh paths; reference photon-client
cli/game/scoring/GameScoringDriver.scala — run() (:133-194): prepare feature
maps, read data, load the GAME model from the training output layout,
GameTransformer.transform, optional evaluation, saveScoresToHDFS (:191-253,
ScoringResultAvro records).

    python -m photon_ml_torch.cli.game_scoring_driver --input-data-path val \\
        --model-input-dir out/best --output-dir scored --evaluators AUC

Runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU. The
outputs (``scores/part-NNNNN.avro``, ``scoring-summary.json``) keep the JAX
driver's names and layout. ``--distributed`` (or ``--mesh data=N[,model=M]``)
scores each rank's rows through ``parallel/scoring.DistributedScorer`` over a
mesh of every rank (``torchrun --nproc-per-node N·M``, or one process alone)
and gathers them; rank 0 writes, the other ranks write into
``<output-dir>/.worker-<rank>``. A model axis wider than 1 feature-shards
the model's fixed effect over it (the JAX driver's rule). With
``--partitioned-io`` (which needs ``--distributed`` or ``--mesh`` and takes
no ``--evaluators``) each data rank of a group of several decodes only its
slice of the input (``io/partitioned_reader.py``), scores its own rows
(``DistributedScorer.score_partitioned``) and writes them as its own part,
``scores/part-{rank:05d}.avro`` (``io/score_writer.ShardedScoreWriter``);
the other ranks of its data row write the same part into their
``.worker-<rank>`` directory. ``--telemetry-dir`` writes rank 0's run
journal and ``--trace-dir`` every rank's span timeline (see :func:`run`).
``--input-format libsvm``
reads LibSVM text. A compact random-effect model scores a sparse shard
(``sparse=true`` in its ``--feature-shard-configurations``) through the
gather kernel; a model is loaded compact when its feature space exceeds
``--compact-random-effect-threshold``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from photon_ml_torch.cli.configs import evaluation_id_columns, parse_feature_shard_config
from photon_ml_torch.cli.game_training_driver import _close_journal, _json_safe, parse_mesh_shape
from photon_ml_torch.device import resolve_device
from photon_ml_torch.io.data_reader import FeatureShardConfiguration
from photon_ml_torch.io.index_map import IndexMap
from photon_ml_torch.io.model_io import (
    DEFAULT_COMPACT_RE_THRESHOLD,
    load_game_model,
    load_game_model_and_index_maps,
    write_scores,
)
from photon_ml_torch.io.partitioned_reader import read_partitioned
from photon_ml_torch.io.score_writer import ShardedScoreWriter
from photon_ml_torch.models.game import RandomEffectModel
from photon_ml_torch.models.matrix_factorization import MatrixFactorizationModel
from photon_ml_torch.parallel import multihost
from photon_ml_torch.parallel.scoring import DistributedScorer
from photon_ml_torch.transformers import GameTransformer
from photon_ml_torch.telemetry import (
    RunJournal,
    Tracer,
    default_registry,
    flush_trace_best_effort,
    install_tracer,
    uninstall_tracer,
)
from photon_ml_torch.telemetry.resilience_counters import reset_resilience_metrics
from photon_ml_torch.util import Timed
from photon_ml_torch.util.timed import reset_timings

logger = logging.getLogger(__name__)


def run(
    *,
    input_data_path: "str | Sequence[str]",
    model_input_dir: str,
    output_dir: str,
    feature_shards: dict | None = None,
    index_maps_dir: str | None = None,
    evaluators: Sequence[str] = (),
    model_id: str = "",
    input_format: str = "avro",
    compact_random_effect_threshold: int = DEFAULT_COMPACT_RE_THRESHOLD,
    on_corrupt: str = "raise",
    distributed: bool = False,
    mesh_shape: dict | None = None,
    partitioned_io: bool = False,
    telemetry_dir: str | None = None,
    trace_dir: str | None = None,
    device=None,
) -> dict:
    """Score ``input_data_path`` with the model at ``model_input_dir`` on
    ``device`` (CUDA unless "cpu").

    input_data_path: one dataset path, or a sequence scored in one run with
    the model parsed once; each dataset then writes under
    ``output_dir/dataset-NNNN``. Index maps default to the ones the training
    driver saved next to the model (<root>/index-maps); feature shard
    configs default to one shard per saved index map using the bag of the
    same name.

    telemetry_dir: rank 0's JSONL run journal (phase timings, the I/O and
    resilience counters, a heartbeat a dataset, the scoring summary),
    written on success and on failure. trace_dir: every rank's span
    timeline (``trace-{rank:05d}.json``) and a straggler report merged over
    the ranks into the journal, flushed before the journal's last rows.
    """
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}")
    distributed = distributed or bool(mesh_shape)
    if partitioned_io and not distributed:
        raise ValueError(
            "--partitioned-io requires --distributed or --mesh (the "
            "partitioned blocks feed a mesh's addressable shards)"
        )
    created = distributed and not torch.distributed.is_initialized()
    mesh = None
    exchange = None
    own_dir = False
    try:
        if distributed:
            info = multihost.initialize(device=device)
            shape = dict(mesh_shape or {})
            mesh = multihost.make_hybrid_mesh(data=shape.get("data"),
                                              model=shape.get("model", 1))
            if partitioned_io and mesh.size(0) > 1:
                # every data rank writes its own part into the one output
                # directory; the others of its data row into their own
                exchange = multihost.default_exchange()
                if mesh.size(1) > 1:
                    exchange = multihost.DataAxisExchange(exchange, mesh)
                    own_dir = mesh.get_local_rank("model") > 0
            else:
                own_dir = info.rank > 0
            if own_dir:
                output_dir = os.path.join(output_dir, f".worker-{info.rank}")
        reset_resilience_metrics()
        journal = RunJournal(telemetry_dir) if telemetry_dir else None
        tracer = install_tracer(Tracer()) if trace_dir else None
        succeeded = False
        try:
            summary = _run(input_data_path=input_data_path, model_input_dir=model_input_dir,
                           output_dir=output_dir, feature_shards=feature_shards,
                           index_maps_dir=index_maps_dir, evaluators=evaluators,
                           model_id=model_id, input_format=input_format,
                           compact_random_effect_threshold=compact_random_effect_threshold,
                           on_corrupt=on_corrupt, mesh=mesh, exchange=exchange, device=device,
                           own_dir=own_dir, journal=journal)
            succeeded = True
            if journal is not None:
                journal.record("scoring_summary", **summary)
            return summary
        finally:
            # the trace flushes before the journal's last rows; the straggler
            # merge runs collectives only on success (every rank gets here)
            if tracer is not None:
                try:
                    flush_trace_best_effort(
                        tracer, trace_dir,
                        exchange=(exchange or multihost.default_exchange()) if succeeded
                        else None,
                        gather=succeeded, journal=journal)
                finally:
                    uninstall_tracer()
            _close_journal(journal)
    finally:
        if created:
            multihost.shutdown()


def _run(*, input_data_path, model_input_dir, output_dir, feature_shards, index_maps_dir,
         evaluators, model_id, input_format, compact_random_effect_threshold, on_corrupt, mesh,
         device, exchange=None, own_dir: bool = False, journal=None) -> dict:
    device = resolve_device(device)
    reset_timings()
    if exchange is not None and evaluators:
        raise ValueError(
            "--partitioned-io does not support --evaluators yet; evaluate "
            "through the non-partitioned scoring path"
        )
    paths = ([input_data_path] if isinstance(input_data_path, (str, os.PathLike))
             else list(input_data_path))
    if not paths:
        raise ValueError("input_data_path names no datasets")
    # the shared directory is rank 0's; a worker directory its process's
    writes = exchange is None or exchange.rank == 0 or own_dir
    if writes:
        os.makedirs(output_dir, exist_ok=True)
    if exchange is not None:
        exchange.barrier("scoring/output_dir")
    model, index_maps, feature_shards, entity_vocabs, re_columns = _load_scoring_model(
        model_input_dir=model_input_dir, index_maps_dir=index_maps_dir,
        feature_shards=feature_shards,
        compact_random_effect_threshold=compact_random_effect_threshold, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    # a model axis feature-shards the model's fixed effect (the JAX driver's rule)
    fe_feature_sharded = mesh is not None and mesh.size(1) > 1
    transformer = GameTransformer(model=model, evaluator_specs=tuple(evaluators), mesh=mesh,
                                  fe_feature_sharded=fe_feature_sharded)
    part_scorer = None
    summaries: list[dict] = []
    for di, path in enumerate(paths):
        ds_output = output_dir if len(paths) == 1 else os.path.join(output_dir, f"dataset-{di:04d}")
        if ds_output != output_dir:
            if writes:
                os.makedirs(ds_output, exist_ok=True)
            if exchange is not None:
                exchange.barrier(f"scoring/output_dir/{di}")
        # no retry around the read: a partitioned read is collective
        with Timed("read scoring data", sync=sync):
            part = read_partitioned(path, feature_shards, exchange=exchange,
                                    index_maps=index_maps or None,
                                    random_effect_id_columns=re_columns,
                                    evaluation_id_columns=evaluation_id_columns(evaluators),
                                    entity_vocabs=entity_vocabs, fmt=input_format,
                                    pad_multiple=1, on_corrupt=on_corrupt, device=device)
            data = part.result
        partition = part.partition
        if partition.num_ranks > 1:
            # each rank scores and writes its own rows: no gather, no rank-0
            # encode of the whole output
            with Timed("score", sync=sync):
                if part_scorer is None:
                    part_scorer = DistributedScorer(model, mesh,
                                                    fe_feature_sharded=fe_feature_sharded)
                local_scores = part_scorer.score_partitioned(
                    {partition.rank: data.dataset}, partition, exchange=exchange)[partition.rank]
            n_local = partition.local_n
            if own_dir:
                os.makedirs(os.path.join(ds_output, "scores"), exist_ok=True)
            with Timed("save scores"):
                ShardedScoreWriter(os.path.join(ds_output, "scores"), exchange=exchange).write(
                    local_scores, model_id=model_id,
                    uids=np.asarray(data.dataset.unique_ids)[:n_local],
                    labels=data.dataset.host_array("labels")[:n_local],
                    weights=data.dataset.host_array("weights")[:n_local])
            summary = {"num_scored": partition.total_true_rows, "num_scored_local": n_local,
                       "bytes_decoded_local": part.bytes_decoded,
                       "input_bytes_total": part.input_bytes_total, "evaluations": {}}
        else:
            with Timed("score", sync=sync):
                scored = transformer.transform(data.dataset)
            summary = {"num_scored": int(len(scored.scores)), "evaluations": scored.evaluations}
            with Timed("save scores"):
                write_scores(os.path.join(ds_output, "scores"), scored.scores,
                             records_per_file=1 << 20, model_id=model_id,
                             uids=scored.unique_ids,
                             labels=data.dataset.host_array("labels"),
                             weights=data.dataset.host_array("weights"))
        if len(paths) > 1:
            summary = dict(summary, input_data_path=str(path))
        if writes:
            with open(os.path.join(ds_output, "scoring-summary.json"), "w") as f:
                json.dump(_json_safe(summary), f, indent=2, default=float)
        summaries.append(summary)
        if journal is not None:
            # which dataset the loop last finished, with the registry's deltas
            journal.heartbeat(registry=default_registry(), stage="game_scoring",
                              dataset_index=di, num_datasets=len(paths),
                              num_scored=summary.get("num_scored"))
    if len(paths) == 1:
        return summaries[0]
    combined = {"num_scored": int(sum(s["num_scored"] for s in summaries)),
                "num_datasets": len(summaries), "datasets": summaries}
    if writes:
        with open(os.path.join(output_dir, "scoring-summary.json"), "w") as f:
            json.dump(_json_safe(combined), f, indent=2, default=float)
    return combined


def _load_scoring_model(*, model_input_dir: str, index_maps_dir: str | None,
                        feature_shards: dict | None, compact_random_effect_threshold: int,
                        device):
    """Parse the model Avro + index maps once: (model, index_maps,
    feature_shards, entity_vocabs, re_columns)."""
    if index_maps_dir is None:
        candidate = os.path.join(os.path.dirname(model_input_dir.rstrip("/")), "index-maps")
        index_maps_dir = candidate if os.path.isdir(candidate) else None
    index_maps = IndexMap.load_directory(index_maps_dir) if index_maps_dir else {}
    if index_maps:
        if feature_shards is None:
            # shard name == bag name is the training driver's convention,
            # only trustworthy for maps its stores produced
            feature_shards = {shard: FeatureShardConfiguration(feature_bags=(shard, "features"))
                              for shard in index_maps}
        with Timed("load model"):
            model = load_game_model(model_input_dir, index_maps,
                                    compact_random_effect_threshold=compact_random_effect_threshold,
                                    device=device)
    else:
        # no saved stores (a reference-written model): rebuild the maps from
        # the model's own records while loading; the shard -> bag mapping
        # cannot be guessed, so explicit shard configs are required
        if feature_shards is None:
            raise ValueError(
                "no saved index-map stores next to this model: pass "
                "--feature-shard-configurations mapping each model shard id to the data's "
                "feature bags")
        with Timed("load model"):
            model, index_maps = load_game_model_and_index_maps(
                model_input_dir,
                compact_random_effect_threshold=compact_random_effect_threshold, device=device)
    entity_vocabs: dict[str, np.ndarray] = {}

    def set_vocab(effect_type: str, keys) -> None:
        keys = np.asarray(keys)
        existing = entity_vocabs.get(effect_type)
        if existing is not None and not np.array_equal(existing, keys):
            # two sub-models disagreeing on a shared entity space would
            # silently misalign one model's table rows
            raise ValueError(
                f"sub-models disagree on entity keys for effect type "
                f"'{effect_type}' ({len(existing)} vs {len(keys)} keys); "
                "cannot build a consistent scoring vocab")
        entity_vocabs[effect_type] = keys

    for m in model.models.values():
        if isinstance(m, RandomEffectModel):
            set_vocab(m.random_effect_type, m.entity_keys)
        elif isinstance(m, MatrixFactorizationModel):
            set_vocab(m.row_effect_type, m.row_keys)
            set_vocab(m.col_effect_type, m.col_keys)
    return model, index_maps, feature_shards, entity_vocabs, tuple(sorted(entity_vocabs))


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="game_scoring_driver")
    p.add_argument("--input-data-path", required=True, action="append",
                   help="dataset to score; repeat to score several datasets in one run (the "
                        "model is parsed once; each dataset writes under "
                        "<output-dir>/dataset-NNNN)")
    p.add_argument("--model-input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard-configurations", action="append", default=None)
    p.add_argument("--index-maps-dir")
    p.add_argument("--evaluators", default="")
    p.add_argument("--model-id", default="")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--compact-random-effect-threshold", type=int,
                   default=DEFAULT_COMPACT_RE_THRESHOLD,
                   help="random-effect coordinates whose feature space exceeds this load as "
                        "compact per-entity tables (never materializing [entities, dim])")
    p.add_argument("--on-corrupt", default="raise", choices=["raise", "quarantine"],
                   help="corrupt Avro blocks: 'raise' (strict, default) or 'quarantine' "
                        "(skip-and-count)")
    p.add_argument("--distributed", action="store_true",
                   help="score each rank's rows over a mesh of every rank")
    p.add_argument("--mesh", default="",
                   help="data=N[,model=M]: the mesh's shape (implies --distributed; "
                        "model>1 feature-shards the fixed effect)")
    p.add_argument("--partitioned-io", action="store_true",
                   help="each rank decodes ~1/P of the input and writes its own score part "
                        "(needs --distributed or --mesh; no --evaluators)")
    p.add_argument("--telemetry-dir",
                   help="write rank 0's JSONL run journal (phase timings, I/O and resilience "
                        "counters, the scoring summary) here")
    p.add_argument("--trace-dir",
                   help="write every rank's host span timeline (trace-<rank>.json, "
                        "Chrome-trace JSON) here; the straggler report goes to the journal")
    return p


def main(argv: Sequence[str] | None = None, *, device=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_arg_parser().parse_args(argv)
    shards = None
    if args.feature_shard_configurations:
        shards = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    paths = args.input_data_path
    return run(
        input_data_path=paths[0] if len(paths) == 1 else paths,
        model_input_dir=args.model_input_dir,
        output_dir=args.output_dir,
        feature_shards=shards,
        index_maps_dir=args.index_maps_dir,
        evaluators=tuple(x.strip() for x in args.evaluators.split(",") if x.strip()),
        model_id=args.model_id,
        input_format=args.input_format,
        compact_random_effect_threshold=args.compact_random_effect_threshold,
        on_corrupt=args.on_corrupt,
        distributed=args.distributed or bool(args.mesh),
        mesh_shape=parse_mesh_shape(args.mesh),
        partitioned_io=args.partitioned_io,
        telemetry_dir=args.telemetry_dir,
        trace_dir=args.trace_dir,
        device=device,
    )


if __name__ == "__main__":
    main()
