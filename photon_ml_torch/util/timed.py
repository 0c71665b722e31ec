"""Wall-clock timing of named blocks (the port's own copy).

Counterpart of ``photon_ml_tpu/util/timed.py``; reference photon-lib
util/Timed.scala:33-77 — ``Timed("name"){...}`` logs the duration of the
block. Here a context manager and a decorator; the durations feed the
process-wide metrics registry (``telemetry/registry.py`` histograms under
``timing/<name>``), so a driver can journal a per-stage summary, and each
block records a ``phase/<name>`` span into the run tracer when one is
installed (``telemetry/tracing.py``), so driver phases frame the finer
spans of the exported timeline. A block that launches device work and must
be timed to its end synchronizes the device itself (``Timed(...,
sync=torch.cuda.synchronize)``), since CUDA calls return before the device
finishes. ``profile_trace`` captures a device trace with
``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from functools import wraps

from photon_ml_torch.telemetry import tracing
from photon_ml_torch.telemetry.registry import default_registry

logger = logging.getLogger("photon_ml_torch.timing")

#: registry namespace for phase timings
_TIMING_PREFIX = "timing/"


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
        self._span = tracing.span("phase/" + self.name, cat="phase")
        self._span.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.sync is not None and exc_type is None:
            self.sync()
        self.duration = time.perf_counter() - self._start
        self._span.__exit__(exc_type, exc, tb)
        default_registry().histogram(_TIMING_PREFIX + self.name).observe(self.duration)
        logger.log(self.log_level, "%s took %.3f s", self.name, self.duration)
        return False


def timed(name: str | None = None):
    """Decorator form of Timed."""

    def decorate(fn):
        label = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with Timed(label):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace of the enclosed block: CPU
    activity, and CUDA kernels when CUDA is available, exported as one
    Chrome trace (``trace-<pid>.json``) into ``log_dir`` (Perfetto or
    ``chrome://tracing`` open it). Yields the profiler. A None or empty
    ``log_dir`` disables it, so drivers pass their flag through
    unconditionally."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(log_dir), exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(str(log_dir), f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logger.info("torch profiler trace written to %s", path)


def timing_summary() -> dict[str, dict[str, float]]:
    """name -> {count, total, mean, min, max, p50, p95} over everything
    timed so far (the ``timing/`` histograms of the metrics registry)."""
    return {
        name[len(_TIMING_PREFIX):]: hist.summary()
        for name, hist in default_registry().histograms(_TIMING_PREFIX).items()
        if hist.count
    }


def reset_timings() -> None:
    default_registry().remove_prefix(_TIMING_PREFIX)
