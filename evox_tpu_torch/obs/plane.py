"""The :class:`Observability` facade: one handle for bus + registry + tracer
(counterpart of ``evox_tpu/obs/plane.py``).

The :class:`~evox_tpu_torch.resilience.ResilientRunner` takes a single
``obs=`` parameter instead of three.  The default (``obs=None``) builds a
plane wired to the process-local
:func:`~evox_tpu_torch.obs.default_registry` and a private bus with a ring
buffer — metrics always aggregate process-wide, recent events are always
inspectable, and adding a JSONL file or a tracer is opt-in.  ``obs=False``
disables instrumentation entirely.
"""

from __future__ import annotations

import contextlib
from typing import Any, Union

from .events import CallbackSink, EventBus, JsonlFileSink, RingBufferSink
from .flight import FlightRecorder
from .metrics import MetricsRegistry, default_registry
from .trace import Tracer

__all__ = ["Observability"]

_NULL_CTX = contextlib.nullcontext()


class Observability:
    """Bundle of the three observability pillars.

    :param bus: the :class:`~evox_tpu_torch.obs.EventBus` events publish into;
        ``None`` builds a private bus.
    :param registry: the :class:`~evox_tpu_torch.obs.MetricsRegistry` metrics
        land in; ``None`` uses the process-local default registry.
    :param tracer: optional :class:`~evox_tpu_torch.obs.Tracer` for segment
        spans; ``None`` records no spans (``span()`` returns a shared
        no-op context).
    :param run_id: identity stamped on every event published through
        :meth:`event` (and onto the bus default when the bus is private).
    :param ring: capacity of the convenience ring-buffer sink attached to
        a *private* bus (``0`` disables; an explicitly passed bus is
        never modified).
    :param events_path: convenience — when set, a
        :class:`~evox_tpu_torch.obs.JsonlFileSink` at this path is attached to
        the bus (private or passed).
    :param flight: optional :class:`~evox_tpu_torch.obs.FlightRecorder` — the
        device-side flight recorder.  Attaching it here (1) turns on the
        per-generation flight telemetry in every instrumented runner's
        fused segments, (2) subscribes the recorder to the bus so health
        restarts / early stops / preemptions / tenant warnings dump
        postmortem bundles, and (3) stamps the plane's ``run_id`` into
        its manifests.
    """

    def __init__(
        self,
        *,
        bus: EventBus | None = None,
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        run_id: str | None = None,
        ring: int = 512,
        events_path: Any | None = None,
        flight: FlightRecorder | None = None,
    ):
        self.ring: RingBufferSink | None = None
        if bus is None:
            bus = EventBus(run_id=run_id)
            if ring:
                self.ring = bus.add_sink(RingBufferSink(ring))
        self.bus = bus
        self.registry = registry if registry is not None else default_registry()
        self.tracer = tracer
        self.run_id = run_id if run_id is not None else bus.run_id
        self.jsonl: JsonlFileSink | None = None
        if events_path is not None:
            self.jsonl = bus.add_sink(JsonlFileSink(events_path))
        self.flight: FlightRecorder | None = flight
        if flight is not None:
            if flight.run_id is None:
                flight.run_id = self.run_id
            bus.add_sink(flight)

    # -- events --------------------------------------------------------------
    def event(
        self,
        category: str,
        message: str,
        *,
        severity: str = "info",
        tenant_id: str | None = None,
        **payload: Any,
    ):
        return self.bus.publish(
            category,
            message,
            severity=severity,
            run_id=self.run_id,
            tenant_id=tenant_id,
            **payload,
        )

    def legacy_callback(self, callback, *, min_severity: str = "debug"):
        """Attach a pre-obs string callback as a bus sink (returns the
        sink so it can be removed)."""
        return self.bus.add_sink(
            CallbackSink(callback, min_severity=min_severity)
        )

    # -- metrics -------------------------------------------------------------
    def counter(self, name: str, help: str = "", **labels: Any):
        return self.registry.counter(name, help, **labels)

    def gauge(self, name: str, help: str = "", **labels: Any):
        return self.registry.gauge(name, help, **labels)

    def histogram(
        self, name: str, help: str = "", buckets: Any | None = None, **labels: Any
    ):
        return self.registry.histogram(name, help, buckets=buckets, **labels)

    # -- tracing -------------------------------------------------------------
    def span(self, name: str, **args: Any):
        """A tracer span, or a shared no-op context without a tracer."""
        if self.tracer is None:
            return _NULL_CTX
        return self.tracer.span(name, **args)

    def record_span(self, name: str, start: float, end: float, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.record(name, start, end, **args)

    def record_counter(self, name: str, **values: Any) -> None:
        """One counter-track sample (``ph:"C"``) when the plane carries a
        tracer; a no-op otherwise — boundary call sites pass optional
        device stats verbatim."""
        if self.tracer is not None:
            self.tracer.counter(name, **values)

    def maybe_profile(self, segment_index: int):
        if self.tracer is None:
            return _NULL_CTX
        return self.tracer.maybe_profile(segment_index)


def resolve_obs(
    obs: Union["Observability", bool, None], *, run_id: str | None = None
) -> "Observability | None":
    """Normalize the ``obs=`` parameter contract shared by runner, fleet,
    and service: ``None`` → a default plane, ``False`` → fully disabled
    (``None`` back), an :class:`Observability` → itself."""
    if obs is False:
        return None
    if obs is None or obs is True:
        return Observability(run_id=run_id)
    return obs
