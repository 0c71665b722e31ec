"""Out-of-core streaming telemetry: decode times and the overlap (the
port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/stream_counters.py``. The chunked
streaming pipeline (``io/stream_reader.py``, ``algorithm/streaming.py``,
``algorithm/streaming_game.py``) records here how long each chunk's host
decode took and how much of it hid behind device work, so a run journal
shows it on success and failure paths.
"""

from __future__ import annotations

from photon_ml_torch.telemetry.registry import default_registry

#: per-chunk host decode and assembly time (ms), prefetch on or off
CHUNK_DECODE_MS = "io/chunk_decode_ms"
#: prefix shared by the epoch-level gauges (reset_stream_metrics)
STREAM_METRIC_PREFIX = "stream/"
#: share of the epoch's host decode time hidden behind device work:
#: 1 - (consumer wait / total decode), clamped to [0, 1]; 0.0 without prefetch
OVERLAP_FRACTION = "stream/overlap_fraction"
#: chunk count of the most recent epoch
CHUNKS_PER_EPOCH = "stream/chunks_per_epoch"
#: streamed-GAME evidence: chunk loads (source decodes; DuHL working-set
#: hits do not count), chunk visits (schedule entries the random-effect
#: solves processed) and the sweeps of the most recent train
GAME_CHUNK_LOADS = "stream/game_chunk_loads"
GAME_CHUNK_VISITS = "stream/game_chunk_visits"
GAME_SWEEPS = "stream/game_sweeps"


def reset_stream_metrics(registry=None) -> None:
    """Drop the per-run streaming metrics (drivers call it at run start)."""
    reg = registry or default_registry()
    reg.remove_prefix(STREAM_METRIC_PREFIX)
    reg.remove_prefix(CHUNK_DECODE_MS)


def record_chunk_decode_ms(ms: float) -> None:
    default_registry().histogram(CHUNK_DECODE_MS).observe(float(ms))


def set_overlap_fraction(fraction: float) -> None:
    default_registry().gauge(OVERLAP_FRACTION).set(float(fraction))


def set_chunks_per_epoch(n: int) -> None:
    default_registry().gauge(CHUNKS_PER_EPOCH).set(int(n))


def overlap_fraction() -> float:
    value = default_registry().gauge(OVERLAP_FRACTION).value
    return float(value or 0.0)


def chunks_per_epoch() -> int:
    value = default_registry().gauge(CHUNKS_PER_EPOCH).value
    return int(value or 0)


def set_game_stream_evidence(*, chunk_loads: int, chunk_visits: int, sweeps: int) -> None:
    default_registry().gauge(GAME_CHUNK_LOADS).set(int(chunk_loads))
    default_registry().gauge(GAME_CHUNK_VISITS).set(int(chunk_visits))
    default_registry().gauge(GAME_SWEEPS).set(int(sweeps))


def game_stream_evidence() -> dict:
    reg = default_registry()
    return {
        "chunk_loads": int(reg.gauge(GAME_CHUNK_LOADS).value or 0),
        "chunk_visits": int(reg.gauge(GAME_CHUNK_VISITS).value or 0),
        "sweeps": int(reg.gauge(GAME_SWEEPS).value or 0),
    }


def chunk_decode_summary() -> dict:
    return default_registry().histogram(CHUNK_DECODE_MS).summary()
