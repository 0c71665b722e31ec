"""Telemetry the serving layer reads: the metrics registry and the serving
counters (the port's own copies). The JAX package's run journals, tracing,
probes and program ledger are ROADMAP.md item 19."""

from photon_ml_torch.telemetry import serving_counters
from photon_ml_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "serving_counters",
]
