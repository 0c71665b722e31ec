"""Training lifecycle events (the port's own copy).

Counterpart of ``photon_ml_tpu/util/events.py``; reference photon-client
event/ — Event, EventEmitter, EventListener; concrete events
PhotonSetupEvent, TrainingStartEvent, TrainingFinishEvent,
PhotonOptimizationLogEvent (emitted from Driver.scala:120-393). Listeners
hook external telemetry into driver runs without coupling.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event; ``timestamp`` is seconds since epoch."""

    timestamp: float = dataclasses.field(default_factory=time.time, kw_only=True)


@dataclasses.dataclass(frozen=True)
class SetupEvent(Event):
    config_summary: str = ""


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    job_name: str = ""


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    job_name: str = ""
    succeeded: bool = True


@dataclasses.dataclass(frozen=True)
class OptimizationLogEvent(Event):
    """Per-coordinate-update optimization telemetry (reference
    PhotonOptimizationLogEvent)."""

    coordinate_id: str = ""
    iteration: int = 0
    metrics: dict = dataclasses.field(default_factory=dict)


EventListener = Callable[[Event], None]


class EventEmitter:
    """Synchronous fan-out of events to registered listeners; listener
    exceptions are logged, never propagated (reference EventEmitter.scala)."""

    def __init__(self):
        self._listeners: list[EventListener] = []

    @property
    def has_listeners(self) -> bool:
        """True when a send() would reach anyone: producers whose events
        cost host reads check this before building one."""
        return bool(self._listeners)

    def register(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def unregister(self, listener: EventListener) -> None:
        """Idempotent: removing a listener that is not registered does
        nothing, so cleanup paths may unregister unconditionally."""
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def send(self, event: Event) -> None:
        for listener in self._listeners:
            try:
                listener(event)
            except Exception:
                logger.exception("event listener failed on %r", event)
