"""Wall-clock timing of named blocks (the port's own copy).

Counterpart of ``photon_ml_tpu/util/timed.py``; reference photon-lib
util/Timed.scala:33-77 — ``Timed("name"){...}`` logs the duration of the
block. The drivers wrap each stage in one; the durations collect in this
module so a driver can write a per-stage summary. A block that launches
device work and must be timed to its end synchronizes the device itself
(``Timed(..., sync=torch.cuda.synchronize)``), since CUDA calls return
before the device finishes.
"""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np

logger = logging.getLogger("photon_ml_torch.timing")

#: name -> durations in seconds, since the last reset_timings()
_TIMINGS: dict[str, list[float]] = {}


class Timed(contextlib.AbstractContextManager):
    """``with Timed("read training data"): ...`` — logs and records.

    ``sync``, when given, is called before the clock is read at both ends
    (e.g. ``torch.cuda.synchronize``), so queued device work is inside the
    block's time and earlier work is not."""

    def __init__(self, name: str, log_level: int = logging.INFO, sync=None):
        self.name = name
        self.log_level = log_level
        self.sync = sync
        self.duration: float | None = None

    def __enter__(self):
        if self.sync is not None:
            self.sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.sync is not None and exc_type is None:
            self.sync()
        self.duration = time.perf_counter() - self._start
        _TIMINGS.setdefault(self.name, []).append(self.duration)
        logger.log(self.log_level, "%s took %.3f s", self.name, self.duration)
        return False


def timing_summary() -> dict[str, dict[str, float]]:
    """name -> {count, total, mean, min, max, p50, p95} over everything
    timed since the last reset."""
    out = {}
    for name, values in _TIMINGS.items():
        v = np.asarray(values, dtype=np.float64)
        out[name] = {"count": int(v.size), "total": float(v.sum()), "mean": float(v.mean()),
                     "min": float(v.min()), "max": float(v.max()),
                     "p50": float(np.percentile(v, 50)), "p95": float(np.percentile(v, 95))}
    return out


def reset_timings() -> None:
    _TIMINGS.clear()
