"""Layout decisions of the sparse batch builders, as registry gauges (the
port's own copy).

Counterpart of ``photon_ml_tpu/telemetry/layout.py``. The reference keeps
Breeze CSR end to end and chooses no device layout; here the hybrid
dense-head / sparse-tail builder (``data/sparse_batch.py``) records its hot
coverage, head width, tail width and its byte estimate against plain ELL,
and the column-sharded builder (``parallel/column_sharded.py``) its
per-block head shape, so the run journal keeps each run's decisions.
Drivers call :func:`reset_layout_metrics` at run start.
"""

from __future__ import annotations

from photon_ml_torch.telemetry.registry import default_registry

#: registry namespace for layout-decision metrics
LAYOUT_METRIC_PREFIX = "layout/"


def reset_layout_metrics(registry=None) -> None:
    """Drop the per-run ``layout/*`` gauges and counters."""
    reg = registry or default_registry()
    reg.remove_prefix(LAYOUT_METRIC_PREFIX)


def record_hybrid_layout(label: str, *, k_hot: int, k_hot_padded: int, hot_coverage: float,
                         hot_nnz: int, tail_nnz: int, tail_width: int, hybrid_bytes: int,
                         ell_bytes: int, registry=None) -> None:
    """One hybrid build's layout decision, as gauges under
    ``layout/<label>/*`` plus a ``layout/<label>/builds`` counter.
    ``hybrid_bytes``/``ell_bytes`` are the builder's device-footprint
    estimates of the hybrid layout and of plain ELL over the same entries."""
    reg = registry or default_registry()
    base = f"{LAYOUT_METRIC_PREFIX}{label}"
    reg.counter(f"{base}/builds").inc()
    _set_gauges(reg, base, (
        ("k_hot", k_hot),
        ("k_hot_padded", k_hot_padded),
        ("hot_coverage", hot_coverage),
        ("hot_nnz", hot_nnz),
        ("tail_nnz", tail_nnz),
        ("tail_width", tail_width),
        ("hybrid_bytes", hybrid_bytes),
        ("ell_bytes", ell_bytes),
    ))


def record_global_hot_ranking(label: str, *, k_hot: int, global_nnz: int, num_ranks: int,
                              registry=None) -> None:
    """One partitioned read's global hot-column election (the head chosen
    from the ranks' summed nnz histograms); every rank records the same."""
    reg = registry or default_registry()
    base = f"{LAYOUT_METRIC_PREFIX}{label}"
    reg.counter(f"{base}/global_hot_rankings").inc()
    _set_gauges(reg, base, (
        ("global_hot_k", k_hot),
        ("global_hot_nnz", global_nnz),
        ("global_hot_ranks", num_ranks),
    ))


def record_block_head(label: str, *, width: int, num_blocks: int, k_hot_padded: int,
                      registry=None) -> None:
    """The column-sharded builder's per-block head: every block pads to
    the widest block's hot count, so ``block_head_replication`` (width x
    blocks over the global head) is the blow-up of a clustered head."""
    reg = registry or default_registry()
    base = f"{LAYOUT_METRIC_PREFIX}{label}"
    _set_gauges(reg, base, (
        ("block_head_width", width),
        ("block_head_replication", width * num_blocks / k_hot_padded if k_hot_padded else 0.0),
    ))


def _set_gauges(reg, base: str, pairs) -> None:
    for name, value in pairs:
        reg.gauge(f"{base}/{name}").set(value)
