"""Incremental-refresh counters: how many lanes each refresh selected (and
why), and how many coordinates it carried over untouched.

Counterpart of ``photon_ml_tpu/telemetry/refresh_counters.py``. The refresh
(``algorithm/refresh.py``) selects at entity granularity, so what it saves
against a full fit (strictly fewer random-effect lane solves) is counted
here, over the port's registry (``telemetry/registry.py``). Names are
constants so the producer and its readers (tests, the training driver's
summary) cannot drift.
"""

from __future__ import annotations

from photon_ml_torch.telemetry.registry import default_registry

#: prefix shared by every refresh metric (reset_refresh_metrics)
REFRESH_METRIC_PREFIX = "refresh/"
#: valid random-effect lanes the refresh could have solved (a full fit's)
LANES_TOTAL = "refresh/lanes_total"
#: lanes the refresh solved
LANES_SOLVED = "refresh/lanes_solved"
#: lanes selected because their entity was declared changed
LANES_CHANGED = "refresh/lanes_changed"
#: lanes selected because their gradient at the resident solution exceeded
#: the policy's tolerance
LANES_GRADIENT = "refresh/lanes_gradient"
#: coordinates whose entities were (partly) solved again
COORDINATES_REFRESHED = "refresh/coordinates_refreshed"
#: coordinates carried over untouched (fixed effects, MF)
COORDINATES_CARRIED = "refresh/coordinates_carried"


def reset_refresh_metrics(registry=None) -> None:
    """Drop the refresh metrics (a driver run starts from zero)."""
    (registry or default_registry()).remove_prefix(REFRESH_METRIC_PREFIX)


def record_selection(*, lanes_total: int, lanes_solved: int, lanes_changed: int,
                     lanes_gradient: int) -> None:
    """One refreshed coordinate's selection."""
    reg = default_registry()
    reg.counter(LANES_TOTAL).inc(int(lanes_total))
    reg.counter(LANES_SOLVED).inc(int(lanes_solved))
    reg.counter(LANES_CHANGED).inc(int(lanes_changed))
    reg.counter(LANES_GRADIENT).inc(int(lanes_gradient))
    reg.counter(COORDINATES_REFRESHED).inc()


def record_carried_coordinate(n: int = 1) -> None:
    default_registry().counter(COORDINATES_CARRIED).inc(int(n))


def selection_evidence() -> dict:
    """The counters as a dict (the training driver's summary)."""
    reg = default_registry()
    return {
        "lanes_total": int(reg.counter(LANES_TOTAL).value),
        "lanes_solved": int(reg.counter(LANES_SOLVED).value),
        "lanes_changed": int(reg.counter(LANES_CHANGED).value),
        "lanes_gradient": int(reg.counter(LANES_GRADIENT).value),
        "coordinates_refreshed": int(reg.counter(COORDINATES_REFRESHED).value),
        "coordinates_carried": int(reg.counter(COORDINATES_CARRIED).value),
    }
