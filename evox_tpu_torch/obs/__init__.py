"""Observability plane: structured events, metrics, tracing, the flight
recorder (counterpart of ``evox_tpu/obs``, the part the resilient runner
needs).

* **Events** (:mod:`~evox_tpu_torch.obs.events`) — typed :class:`Event`
  records on an :class:`EventBus` with pluggable sinks
  (:class:`RingBufferSink`, :class:`JsonlFileSink` with size-capped
  rotation, :class:`CallbackSink` as the string-callback adapter).
* **Metrics** (:mod:`~evox_tpu_torch.obs.metrics`) — a process-local
  :class:`MetricsRegistry` of counters/gauges/histograms with label sets,
  exported as a dict snapshot or Prometheus text (the JAX package's text,
  string for string).
* **Tracing** (:mod:`~evox_tpu_torch.obs.trace`) — host-side segment spans
  plus counter tracks exported as Chrome-trace/Perfetto JSON, plus an
  opt-in ``torch.profiler`` window around the Nth segment.
* **Flight recorder** (:mod:`~evox_tpu_torch.obs.flight`) —
  per-generation signals stacked out of the fused segment (inside its CUDA
  graph on the card), ring-buffered on the host, dumped as schema-stamped
  postmortem bundles.
* **Program introspection** (:mod:`~evox_tpu_torch.obs.xla`) — the card's
  allocator gauges; a captured graph has no cost model.

The :class:`Observability` facade bundles them; the resilient runner takes
it as one ``obs=`` parameter.  Every exported artifact carries
:data:`OBS_SCHEMA_VERSION`.  All instrumentation is host-side at segment
boundaries; the one in-segment feature, the flight signals, adds outputs
to the segment and never changes the state it computes.

Not ported yet: the fleet aggregator, the introspection endpoint and the
SLO trackers (ROADMAP Queue 1, item 13.4); importing one of their names
raises :class:`ImportError`.
"""

from . import xla
from .events import CallbackSink, Event, EventBus, JsonlFileSink, RingBufferSink
from .flight import FlightRecorder, finalize_row, flight_signals, last_n, window_ema, window_slope
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    parse_series,
    reset_default_registry,
)
from .plane import Observability
from .trace import CounterSample, Span, Tracer
from .version import OBS_SCHEMA_VERSION

__all__ = [
    "OBS_SCHEMA_VERSION",
    "Event",
    "EventBus",
    "RingBufferSink",
    "JsonlFileSink",
    "CallbackSink",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "parse_series",
    "reset_default_registry",
    "Span",
    "CounterSample",
    "Tracer",
    "Observability",
    "FlightRecorder",
    "finalize_row",
    "flight_signals",
    "last_n",
    "window_ema",
    "window_slope",
    "xla",
]

_NOT_PORTED = ("FleetAggregator", "IntrospectionEndpoint", "SLO", "SLOStatus", "SLOTracker", "default_slos")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.obs.{name} is not ported yet: the fleet aggregator, the introspection endpoint and "
            f"the SLO trackers come after the resilient runner (ROADMAP Queue 1, item 13.4)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
