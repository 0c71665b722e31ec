"""Serve driver: offline replay harness for the resident scoring service (the port's).

Counterpart of ``photon_ml_tpu/cli/serve_driver.py``; reference
photon-client cli/game/scoring/GameScoringDriver.scala is a batch job, and
this driver is its online half, exercised offline: it loads a GAME model
once into a resident scorer (``serving/resident.py``), replays a file of
scoring records as a stream of small requests through the micro-batching
loop (``serving/batching.py``), and reports scores/s, p50/p95 request
latency, the pad fraction and the signature count against an embedded
same-run one-request-per-micro-batch baseline. The replay is closed-loop
(submit as fast as the bounded queue admits): it measures the service's
steady-state ceiling, not an arrival process.

    python -m photon_ml_torch.cli.serve_driver --requests-avro req \\
        --model-input-dir out/best --output-dir served

Runs on the CUDA device; ``main(argv, device="cpu")`` runs on the CPU.
``serving-summary.json`` keeps the JAX driver's keys. On the card a
"compile" of the summary is a CUDA graph capture: ``warm_compiles`` and
``replay_compiles`` count the captures of the warm-up and of the replay
(0 once the warm-up has captured every signature the replay reaches), and
``program_compiles`` is ``null`` (the program ledger is ROADMAP.md item 19,
step 2). ``--telemetry-dir`` writes a JSONL run journal and ``--trace-dir``
the span timeline (see :func:`run`).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from typing import Sequence

import torch

from photon_ml_torch.cli.configs import parse_feature_shard_config
from photon_ml_torch.cli.game_training_driver import _close_journal
from photon_ml_torch.device import resolve_device
from photon_ml_torch.io.model_io import DEFAULT_COMPACT_RE_THRESHOLD
from photon_ml_torch.io.partitioned_reader import read_partitioned
from photon_ml_torch.telemetry import (
    RunJournal,
    Tracer,
    flush_trace_best_effort,
    install_tracer,
    uninstall_tracer,
)
from photon_ml_torch.util import Timed

logger = logging.getLogger(__name__)

DEFAULT_SHAPES = "64,256,1024"


class _SwapPoller(threading.Thread):
    """Continuous model refresh: watch a directory for atomically renamed
    model subdirectories and hot-swap each through the guarded
    ``MicroBatchServer.swap_model`` while the serving loop keeps draining.
    Appearance is completeness (publishers stage under a ``tmp.*`` or
    dot-prefixed sibling and ``os.rename`` into place), so a half-written
    model is never loaded. A rejected swap (``ModelSwapError``: a layout
    change) or an unloadable directory is logged, recorded in ``rejected``
    and journaled as a ``model_swap`` row, and serving continues on the
    resident model."""

    def __init__(self, server, watch_dir: str, poll_s: float, *, index_maps,
                 compact_threshold: int, device, journal=None):
        super().__init__(name="serve-swap-poller", daemon=True)
        self._server = server
        self._watch_dir = watch_dir
        self._poll_s = max(poll_s, 1e-3)
        self._index_maps = index_maps
        self._compact_threshold = compact_threshold
        self._device = device
        self._journal = journal
        self._stop_event = threading.Event()
        self._seen: set[str] = set()
        self.polls = 0
        self.applied: list[str] = []
        self.rejected: list[dict] = []

    def stop(self) -> None:
        self._stop_event.set()
        self.join(timeout=10.0)

    def run(self) -> None:
        while not self._stop_event.is_set():
            self.scan_once()
            self._stop_event.wait(self._poll_s)
        # one final scan so a model published just before the replay
        # drained is not skipped
        self.scan_once()

    def scan_once(self) -> None:
        from photon_ml_torch.io.model_io import load_game_model
        from photon_ml_torch.resilience import is_transient
        from photon_ml_torch.serving import ModelSwapError

        self.polls += 1
        try:
            names = sorted(os.listdir(self._watch_dir))
        except OSError:
            return  # the watch directory may not exist yet: keep serving
        for name in names:
            # staged (not yet renamed) publishes are invisible by contract
            if name in self._seen or name.startswith((".", "tmp.")):
                continue
            path = os.path.join(self._watch_dir, name)
            if not os.path.isdir(path):
                continue
            self._seen.add(name)
            try:
                model = load_game_model(path, self._index_maps,
                                        compact_random_effect_threshold=self._compact_threshold,
                                        device=self._device)
                self._server.swap_model(model)
            except Exception as e:  # noqa: BLE001 — a daemon thread with no caller
                # a bad publish must not take the poller (and every later
                # refresh) down; a failure outside the expected kinds is
                # logged as an error so a systematic fault stands out
                self.rejected.append({"dir": name, "error": repr(e)})
                log = (logger.warning
                       if isinstance(e, (ModelSwapError, OSError, ValueError, KeyError))
                       or is_transient(e) else logger.error)
                log("rejected hot swap of %s: %r", path, e)
                if self._journal is not None:
                    self._journal.record("model_swap", dir=name, applied=False, error=repr(e))
                continue
            self.applied.append(name)
            logger.info("hot-swapped model from %s", path)
            if self._journal is not None:
                self._journal.record("model_swap", dir=name, applied=True)


def _parse_shapes(spec: str) -> tuple[int, ...]:
    try:
        shapes = tuple(int(s) for s in spec.split(",") if s.strip())
    except ValueError:
        raise ValueError(f"bad --microbatch-shapes {spec!r}") from None
    if not shapes:
        raise ValueError("--microbatch-shapes names no shapes")
    return shapes


def run(
    *,
    requests_avro: str,
    model_input_dir: str,
    output_dir: str,
    feature_shards: dict | None = None,
    index_maps_dir: str | None = None,
    input_format: str = "avro",
    compact_random_effect_threshold: int = DEFAULT_COMPACT_RE_THRESHOLD,
    microbatch_shapes: "tuple[int, ...] | str" = DEFAULT_SHAPES,
    max_wait_ms: float = 2.0,
    queue_depth: int = 1024,
    request_rows: int = 1,
    num_requests: int | None = None,
    bf16: bool = False,
    skip_unbatched_baseline: bool = False,
    swap_model_dir: str | None = None,
    swap_at_request: int | None = None,
    swap_poll_ms: float = 0.0,
    telemetry_dir: str | None = None,
    trace_dir: str | None = None,
    device=None,
) -> dict:
    """Replay ``requests_avro`` as ``request_rows``-row requests through
    the resident micro-batch scorer on ``device`` (CUDA unless "cpu");
    writes ``serving-summary.json`` under ``output_dir``.

    microbatch_shapes: the bucket set (power-of-two row counts), the bound
    on captured signatures. max_wait_ms/queue_depth: the latency knobs of
    the micro-batching loop. bf16: whole-path bf16 features and parameters
    (not bitwise). skip_unbatched_baseline: drop the embedded
    one-request-per-micro-batch comparison.

    swap_model_dir: a refreshed model hot-swapped in place mid-replay
    through the guarded swap while requests keep flowing; the summary's
    ``swap`` block carries the evidence (every request resolved, the
    captures across the swap: 0 for a model of the same layout).
    swap_at_request: the submit index the swap fires before (default:
    halfway). swap_poll_ms > 0 switches ``swap_model_dir`` into continuous
    mode: the directory is watched, and every atomically renamed model
    subdirectory that appears during the replay is loaded and hot-swapped in
    order (:class:`_SwapPoller`); the ``swap`` block then carries the applied
    and rejected directories, and the journal a ``model_swap`` row a swap.

    telemetry_dir: a JSONL run journal (the serving summary, the ``serve/*``
    counters and the latency histogram in the registry's snapshot, phase
    timings), written on success and on failure. trace_dir: the span
    timeline (``serve/batch``, ``serve/score`` and the phases).
    """
    if swap_poll_ms > 0 and swap_at_request is not None:
        raise ValueError(
            "--swap-at-request names a submit index for the ONE-SHOT "
            "rehearsal swap, but --swap-poll-ms selects continuous mode, "
            "where swaps fire when a model dir APPEARS in "
            "--swap-model-dir; drop one of the two flags"
        )
    from photon_ml_torch.telemetry.serving_counters import reset_serving_metrics
    from photon_ml_torch.util.timed import reset_timings

    reset_timings()
    reset_serving_metrics()
    device = resolve_device(device)
    journal = RunJournal(telemetry_dir) if telemetry_dir else None
    tracer = install_tracer(Tracer()) if trace_dir else None
    try:
        summary = _run_inner(
            requests_avro=requests_avro, model_input_dir=model_input_dir,
            output_dir=output_dir, feature_shards=feature_shards,
            index_maps_dir=index_maps_dir, input_format=input_format,
            compact_random_effect_threshold=compact_random_effect_threshold,
            microbatch_shapes=microbatch_shapes, max_wait_ms=max_wait_ms,
            queue_depth=queue_depth, request_rows=request_rows, num_requests=num_requests,
            bf16=bf16, skip_unbatched_baseline=skip_unbatched_baseline,
            swap_model_dir=swap_model_dir, swap_at_request=swap_at_request,
            swap_poll_ms=swap_poll_ms, device=device, journal=journal)
        if journal is not None:
            journal.record("serving_summary", **summary)
        return summary
    finally:
        # one process: the trace publishes alone, before the journal's last rows
        if tracer is not None:
            try:
                flush_trace_best_effort(tracer, trace_dir, exchange=None, gather=False,
                                        journal=journal)
            finally:
                uninstall_tracer()
        _close_journal(journal)


def _run_inner(*, requests_avro, model_input_dir, output_dir, feature_shards, index_maps_dir,
               input_format, compact_random_effect_threshold, microbatch_shapes, max_wait_ms,
               queue_depth, request_rows, num_requests, bf16, skip_unbatched_baseline,
               swap_model_dir, swap_at_request, swap_poll_ms, device, journal=None) -> dict:
    from photon_ml_torch.cli.game_scoring_driver import _load_scoring_model
    from photon_ml_torch.cli.game_training_driver import _json_safe
    from photon_ml_torch.data.game_data import slice_game_dataset
    from photon_ml_torch.resilience import default_io_policy
    from photon_ml_torch.serving import MicroBatchServer, ResidentScorer
    from photon_ml_torch.telemetry import serving_counters

    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise ValueError(
            "serve_driver is single-process (one resident service per "
            "host); use game_scoring_driver --partitioned-io for "
            "multi-process batch scoring"
        )
    if request_rows <= 0:
        raise ValueError(f"request_rows must be positive, got {request_rows}")
    shapes = (_parse_shapes(microbatch_shapes) if isinstance(microbatch_shapes, str)
              else tuple(microbatch_shapes))
    os.makedirs(output_dir, exist_ok=True)

    model, index_maps, feature_shards, entity_vocabs, re_columns = _load_scoring_model(
        model_input_dir=model_input_dir, index_maps_dir=index_maps_dir,
        feature_shards=feature_shards,
        compact_random_effect_threshold=compact_random_effect_threshold, device=device)

    with Timed("read replay data"):
        # requests arrive in host memory: the resident scorer reads a
        # request's host arrays and copies each micro-batch to the device once
        part = default_io_policy().call(
            lambda: read_partitioned(requests_avro, feature_shards,
                                     index_maps=index_maps or None,
                                     random_effect_id_columns=re_columns,
                                     entity_vocabs=entity_vocabs, fmt=input_format,
                                     device="cpu"),
            description="read replay data",
        )
        dataset = part.result.dataset

    n = dataset.num_samples
    with Timed("slice requests"):
        requests = [slice_game_dataset(dataset, lo, min(lo + request_rows, n))
                    for lo in range(0, n, request_rows)]
        if num_requests is not None:
            requests = requests[:num_requests]
    total_rows = sum(r.num_samples for r in requests)
    logger.info("replaying %d requests (%d rows) through shapes %s", len(requests), total_rows,
                shapes)

    scorer = ResidentScorer(model, shapes=shapes, bf16=bf16)
    with Timed("warm capture"):
        scorer.warm(requests[0])
    warm_captures = scorer.captures

    swap_model = None
    if swap_model_dir and swap_poll_ms <= 0:
        from photon_ml_torch.io.model_io import load_game_model

        with Timed("load swap model"):
            # the resident model's index maps: an equal layout is the point
            # of a hot swap (the guard rejects a mismatch, naming the fields)
            swap_model = load_game_model(
                swap_model_dir, index_maps or None,
                compact_random_effect_threshold=compact_random_effect_threshold, device=device)
        if len(requests) < 2:
            raise ValueError(
                f"the replay has {len(requests)} request(s) but the "
                "mid-replay swap fires BETWEEN requests; raise "
                "--num-requests / shrink --request-rows, or drop "
                "--swap-model-dir"
            )
        if swap_at_request is None:
            swap_at_request = max(1, len(requests) // 2)
        # the swap fires before submit index i, so len(requests) would never fire
        if not 0 < swap_at_request < len(requests):
            raise ValueError(
                f"--swap-at-request {swap_at_request} is outside the "
                f"replay (1..{len(requests) - 1})"
            )

    unbatched_rate = None
    if not skip_unbatched_baseline:
        with Timed("unbatched baseline"):
            # the same-run baseline: one request a micro-batch, no queue
            t0 = time.perf_counter()
            for r in requests:
                scorer.score(r)
            unbatched_rate = total_rows / max(time.perf_counter() - t0, 1e-9)
        # the baseline's counters are not the service's
        serving_counters.reset_serving_metrics()

    replay_start = scorer.captures
    swap_info = None
    with Timed("batched replay"):
        server = MicroBatchServer(scorer, max_wait_ms=max_wait_ms, queue_depth=queue_depth)
        poller = None
        if swap_model_dir and swap_poll_ms > 0:
            poller = _SwapPoller(server, swap_model_dir, swap_poll_ms / 1e3,
                                 index_maps=index_maps or None,
                                 compact_threshold=compact_random_effect_threshold,
                                 device=device, journal=journal)
        t0 = time.perf_counter()
        with server:
            if poller is not None:
                poller.start()
            try:
                futures = []
                for i, r in enumerate(requests):
                    if swap_model is not None and i == swap_at_request:
                        # the in-place swap while the consumer keeps draining
                        before = scorer.captures
                        server.swap_model(swap_model)
                        swap_info = {"performed": True, "at_request": i,
                                     "_captures_before": before}
                    futures.append(server.submit(r))
                for f in futures:
                    f.result()
            finally:
                if poller is not None:
                    # stopped inside the server context, so the final scan's
                    # swap still reaches a live loop, and on failure too
                    poller.stop()
        batched_sec = time.perf_counter() - t0
    batched_rate = total_rows / max(batched_sec, 1e-9)
    if poller is not None:
        swap_info = {"mode": "poll", "poll_ms": swap_poll_ms, "polls": poller.polls,
                     "applied": list(poller.applied), "rejected": list(poller.rejected)}
    if swap_info is not None and "mode" not in swap_info:
        swap_info["score_compiles_after_swap"] = \
            scorer.captures - swap_info.pop("_captures_before")

    latency = serving_counters.latency_summary()
    summary = {
        "num_requests": len(requests),
        "num_rows": total_rows,
        "request_rows": request_rows,
        "microbatch_shapes": list(shapes),
        "max_wait_ms": max_wait_ms,
        "bf16": bf16,
        "scores_per_sec": batched_rate,
        "scores_per_sec_unbatched": unbatched_rate,
        "latency_ms_p50": latency["p50"],
        "latency_ms_p95": latency["p95"],
        "pad_fraction": serving_counters.pad_fraction(),
        "compiled_signatures": len(scorer.signatures),
        # CUDA graph captures (none on the CPU, where the program runs eagerly)
        "warm_compiles": warm_captures,
        "replay_compiles": scorer.captures - replay_start,
        # every submitted request resolved above, so none was dropped
        "swap": swap_info,
        # the program ledger is ROADMAP.md item 19, step 2
        "program_compiles": None,
    }
    with open(os.path.join(output_dir, "serving-summary.json"), "w") as f:
        json.dump(_json_safe(summary), f, indent=2, default=float)
    return summary


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="serve_driver")
    p.add_argument("--requests-avro", required=True,
                   help="Avro scoring records replayed as requests")
    p.add_argument("--model-input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--feature-shard-configurations", action="append", default=None)
    p.add_argument("--index-maps-dir")
    p.add_argument("--input-format", default="avro", choices=["avro", "libsvm"])
    p.add_argument("--compact-random-effect-threshold", type=int,
                   default=DEFAULT_COMPACT_RE_THRESHOLD)
    p.add_argument("--microbatch-shapes", default=DEFAULT_SHAPES,
                   help="comma-separated power-of-two micro-batch row buckets: the bound "
                        "on captured score-program signatures")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="flush deadline: a request waits at most this long for batch "
                        "company before it is scored")
    p.add_argument("--queue-depth", type=int, default=1024,
                   help="bounded request-queue depth (backpressure surfaces as a typed "
                        "submit timeout)")
    p.add_argument("--request-rows", type=int, default=1, help="rows per replayed request")
    p.add_argument("--num-requests", type=int, default=None,
                   help="cap the replay length (default: the whole file)")
    p.add_argument("--bf16", action="store_true",
                   help="whole-path bf16 features and parameters (not bitwise)")
    p.add_argument("--skip-unbatched-baseline", action="store_true",
                   help="skip the embedded one-request-per-micro-batch baseline pass")
    p.add_argument("--swap-model-dir",
                   help="hot-swap this refreshed model in place mid-replay (same-layout "
                        "models only: the guard rejects layout changes, typed)")
    p.add_argument("--swap-at-request", type=int, default=None,
                   help="submit index the swap fires before (default: halfway through "
                        "the replay)")
    p.add_argument("--swap-poll-ms", type=float, default=0.0,
                   help="poll --swap-model-dir every this many ms for atomically renamed "
                        "model subdirectories and hot-swap each through the guarded swap "
                        "(rejected swaps are logged and serving continues); 0 = the one "
                        "rehearsed mid-replay swap")
    p.add_argument("--telemetry-dir",
                   help="write a JSONL run journal (serve/* counters, the latency "
                        "histogram, the serving summary, hot-swap rows) here")
    p.add_argument("--trace-dir",
                   help="write the host span timeline (trace-00000.json, Chrome-trace "
                        "JSON) here")
    return p


def main(argv: Sequence[str] | None = None, *, device=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = build_arg_parser().parse_args(argv)
    shards = None
    if args.feature_shard_configurations:
        shards = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    return run(
        requests_avro=args.requests_avro,
        model_input_dir=args.model_input_dir,
        output_dir=args.output_dir,
        feature_shards=shards,
        index_maps_dir=args.index_maps_dir,
        input_format=args.input_format,
        compact_random_effect_threshold=args.compact_random_effect_threshold,
        microbatch_shapes=args.microbatch_shapes,
        max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth,
        request_rows=args.request_rows,
        num_requests=args.num_requests,
        bf16=args.bf16,
        skip_unbatched_baseline=args.skip_unbatched_baseline,
        swap_model_dir=args.swap_model_dir,
        swap_at_request=args.swap_at_request,
        swap_poll_ms=args.swap_poll_ms,
        telemetry_dir=args.telemetry_dir,
        trace_dir=args.trace_dir,
        device=device,
    )


if __name__ == "__main__":
    main()
