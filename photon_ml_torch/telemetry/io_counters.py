"""Per-rank partitioned host-I/O counters (the port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/io_counters.py``. Spark surfaced
per-executor input/output bytes in its task UI for AvroDataReader.scala /
ScoreProcessingUtils.scala work; here the per-rank evidence lives in the
process-wide metrics registry, so a run journal shows each of P ranks
touched about 1/P of the input and output bytes.
"""

from __future__ import annotations

from photon_ml_torch.telemetry.registry import default_registry

#: bytes of input this rank decoded (container file bytes in files mode,
#: selected block payload bytes in blocks mode)
BYTES_DECODED = "io/partitioned/bytes_decoded"
#: total bytes of the input across all ranks (gauge, the same on every rank)
INPUT_BYTES_TOTAL = "io/partitioned/input_bytes_total"
#: bytes of score output this rank wrote (its own part files only)
SCORE_BYTES_WRITTEN = "io/partitioned/score_bytes_written"


def record_bytes_decoded(n: int) -> None:
    default_registry().counter(BYTES_DECODED).inc(int(n))


def set_input_bytes_total(n: int) -> None:
    default_registry().gauge(INPUT_BYTES_TOTAL).set(int(n))


def record_score_bytes_written(n: int) -> None:
    default_registry().counter(SCORE_BYTES_WRITTEN).inc(int(n))


def bytes_decoded() -> int:
    return int(default_registry().counter(BYTES_DECODED).value)


def input_bytes_total() -> int:
    value = default_registry().gauge(INPUT_BYTES_TOTAL).value
    return int(value or 0)


def score_bytes_written() -> int:
    return int(default_registry().counter(SCORE_BYTES_WRITTEN).value)
