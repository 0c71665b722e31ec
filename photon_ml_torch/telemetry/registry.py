"""Process-wide metrics registry: counters, gauges, histograms (the port's
own copy of what serving reads).

Counterpart of ``photon_ml_tpu/telemetry/registry.py``; reference photon-lib
util/Timed.scala:33-77 and OptimizationStatesTracker.scala:82-101 reported
through ad-hoc logging. Here one typed, thread-safe registry is fed by the
serving layer (``telemetry/serving_counters.py``); snapshots are plain
dicts. The rest of the JAX package's ``telemetry/`` (run journals, tracing,
the program ledger) is ROADMAP.md item 19.
"""

from __future__ import annotations

import math
import threading
from collections import deque

#: histograms keep the most recent observations for percentile estimation;
#: count/total/min/max stay exact over the full stream
HISTOGRAM_WINDOW = 8192


class Counter:
    """Monotonically increasing count (e.g. solver invocations, compiles)."""

    def __init__(self) -> None:
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar (e.g. live HBM bytes, lane count)."""

    def __init__(self) -> None:
        self._value: float | None = None

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float | None:
        return self._value


class Histogram:
    """Streaming distribution: exact count/total/min/max, windowed p50/p95."""

    def __init__(self, window: int = HISTOGRAM_WINDOW) -> None:
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._values: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._total += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            self._values.append(v)

    def observe_many(self, values) -> None:
        """Bulk observation under ONE lock acquisition — per-lane feeders
        (thousands of iteration counts per sweep) must not pay a lock
        round-trip per value."""
        vs = [float(v) for v in values]
        if not vs:
            return
        with self._lock:
            self._count += len(vs)
            self._total += sum(vs)
            self._min = min(self._min, min(vs))
            self._max = max(self._max, max(vs))
            self._values.extend(vs)

    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._total

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained window; NaN when empty."""
        with self._lock:
            values = sorted(self._values)
        if not values:
            return math.nan
        rank = max(0, min(len(values) - 1, math.ceil(p / 100.0 * len(values)) - 1))
        return values[rank]

    def summary(self) -> dict[str, float]:
        """count/total/mean/min/max/p50/p95 — the shape ``timing_summary``
        reports and the run journal persists."""
        with self._lock:
            count, total = self._count, self._total
            mn, mx = self._min, self._max
        if count == 0:
            return {"count": 0, "total": 0.0, "mean": math.nan,
                    "min": math.nan, "max": math.nan,
                    "p50": math.nan, "p95": math.nan}
        return {
            "count": count,
            "total": total,
            "mean": total / count,
            "min": mn,
            "max": mx,
            "p50": self.percentile(50.0),
            "p95": self.percentile(95.0),
        }


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    Names are free-form but by convention slash-namespaced
    (``timing/<phase>``, ``solver/<coordinate>/iterations``,
    ``serve/latency_ms``) so consumers can select by prefix.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get_or_create(self, name: str, cls):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls()
                self._metrics[name] = metric
            elif not isinstance(metric, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(metric).__name__}, not {cls.__name__}"
                )
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def histograms(self, prefix: str = "") -> dict[str, Histogram]:
        with self._lock:
            return {
                name: m for name, m in self._metrics.items()
                if isinstance(m, Histogram) and name.startswith(prefix)
            }

    def remove_prefix(self, prefix: str) -> None:
        """Drop every metric under ``prefix`` (e.g. per-run phase timings)."""
        with self._lock:
            for name in [n for n in self._metrics if n.startswith(prefix)]:
                del self._metrics[name]

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict[str, dict]:
        """JSON-ready view: {"counters": {...}, "gauges": {...},
        "histograms": {name: summary-dict}}."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out


#: the process-wide registry the serving layer feeds
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT
