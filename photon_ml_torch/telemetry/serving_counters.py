"""Serving telemetry: the latency histogram and the micro-batch counters
(the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/serving_counters.py``. The
reference scores offline (photon-client cli/game/scoring/
GameScoringDriver.scala); an online resident scorer is judged by its latency
distribution, so the serving layer (``photon_ml_torch/serving/``) feeds the
process-wide registry with per-request latency (``time.perf_counter``, submit
to result), queue depth, request/batch/row counts and the pad fraction the
shape buckets cost. The names are the JAX package's, kept as constants so
producers and consumers cannot drift. On the card a "compiled signature" is
one captured CUDA graph.
"""

from __future__ import annotations

from photon_ml_torch.telemetry.registry import default_registry

#: prefix shared by every serving metric (reset_serving_metrics)
SERVING_METRIC_PREFIX = "serve/"
#: submit-to-result latency per request (ms): the SLO histogram — its
#: p50/p95 are what the serve driver reports
LATENCY_MS = "serve/latency_ms"
#: bounded request-queue depth observed at each enqueue/dequeue
QUEUE_DEPTH = "serve/queue_depth"
#: requests accepted into the queue
REQUESTS = "serve/requests"
#: micro-batches the loop scored (coalesced flushes)
BATCHES = "serve/batches"
#: true rows scored (request rows, pads excluded)
ROWS = "serve/rows"
#: pad rows the shape-bucket discipline added on top of ROWS
PADDED_ROWS = "serve/padded_rows"
#: cumulative padded_rows / (rows + padded_rows) — the bucket-set tax
PAD_FRACTION = "serve/pad_fraction"
#: requests that failed (poisoned input, scoring error) — each one
#: attributed to its request id, never fatal to the serving loop
REQUEST_FAILURES = "serve/request_failures"
#: distinct (shape-bucket, layout, entry-axis) signatures the resident
#: scorer has scored through — bounded by the configured bucket set (one
#: captured CUDA graph per signature on the card, none per request)
COMPILED_SIGNATURES = "serve/compiled_signatures"
#: over-sized requests split across micro-batches instead of compiling a
#: fresh signature (the bucket-miss rule)
BUCKET_SPLITS = "serve/bucket_splits"
#: bytes of the resident parameter buffers the scorer holds for its layout
#: signatures (parallel/scoring.py ``resident_params_bytes``)
RESIDENT_PARAMS_BYTES = "serve/resident_params_bytes"
#: in-place model refreshes accepted by the guarded swap API
#: (serving/resident.py swap_model — no new capture on a same-layout swap)
MODEL_SWAPS = "serve/model_swaps"
#: swaps REJECTED typed by the layout fingerprint guard — the serving loop
#: keeps running on the resident model after each one
SWAP_REJECTED = "serve/swap_rejected"


def reset_serving_metrics(registry=None) -> None:
    """Drop per-run serving metrics — the serve driver calls this at run
    start and again between its embedded unbatched baseline and the
    batched replay, so the summary carries only the replay's own latency
    distribution."""
    reg = registry or default_registry()
    reg.remove_prefix(SERVING_METRIC_PREFIX)


def record_request_latency_ms(ms: float) -> None:
    default_registry().histogram(LATENCY_MS).observe(float(ms))


def set_queue_depth(depth: int) -> None:
    default_registry().gauge(QUEUE_DEPTH).set(int(depth))


def record_request(n: int = 1) -> None:
    default_registry().counter(REQUESTS).inc(int(n))


def record_request_failure(n: int = 1) -> None:
    default_registry().counter(REQUEST_FAILURES).inc(int(n))


def record_batch() -> None:
    default_registry().counter(BATCHES).inc()


def record_scored(rows: int, padded_rows: int) -> None:
    """One scored micro-batch's row accounting; refreshes the cumulative
    pad-fraction gauge."""
    reg = default_registry()
    reg.counter(ROWS).inc(int(rows))
    reg.counter(PADDED_ROWS).inc(int(padded_rows))
    total = reg.counter(ROWS).value + reg.counter(PADDED_ROWS).value
    if total:
        reg.gauge(PAD_FRACTION).set(
            reg.counter(PADDED_ROWS).value / total
        )


def set_compiled_signatures(n: int) -> None:
    default_registry().gauge(COMPILED_SIGNATURES).set(int(n))


def set_resident_params_bytes(n: int) -> None:
    default_registry().gauge(RESIDENT_PARAMS_BYTES).set(int(n))


def record_model_swap() -> None:
    default_registry().counter(MODEL_SWAPS).inc()


def record_swap_rejected() -> None:
    default_registry().counter(SWAP_REJECTED).inc()


def record_bucket_split(n: int = 1) -> None:
    default_registry().counter(BUCKET_SPLITS).inc(int(n))


def latency_summary() -> dict:
    return default_registry().histogram(LATENCY_MS).summary()


def pad_fraction() -> float:
    value = default_registry().gauge(PAD_FRACTION).value
    return float(value or 0.0)
