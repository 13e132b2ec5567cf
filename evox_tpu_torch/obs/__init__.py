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
* **SLOs** (:mod:`~evox_tpu_torch.obs.slo`) — declarative objectives
  (:class:`SLO`) scored over rolling windows by an :class:`SLOTracker`:
  burn rates and error budgets, the control plane's ``slo=`` input.
* **Live introspection** (:mod:`~evox_tpu_torch.obs.endpoint`) — a
  read-only stdlib HTTP server (:class:`IntrospectionEndpoint`) over the
  registry, a health verdict, a status document and the flight ring, on a
  daemon thread; its providers serve host-side values only.

* **Fleet aggregation** (:mod:`~evox_tpu_torch.obs.aggregate`) — a
  :class:`FleetAggregator` merges the metric snapshots of a fleet's
  heartbeats into one registry (counters summed across hosts and
  relaunches, gauges per host, histograms bucket by bucket, dead hosts
  marked stale).

The :class:`Observability` facade bundles them; the resilient runner takes
it as one ``obs=`` parameter.  Every exported artifact carries
:data:`OBS_SCHEMA_VERSION`.  All instrumentation is host-side at segment
boundaries; the one in-segment feature, the flight signals, adds outputs
to the segment and never changes the state it computes.

"""

from . import xla
from .aggregate import FleetAggregator
from .endpoint import IntrospectionEndpoint
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
from .slo import SLO, SLOStatus, SLOTracker, default_slos
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
    "IntrospectionEndpoint",
    "FleetAggregator",
    "SLO",
    "SLOStatus",
    "SLOTracker",
    "default_slos",
    "FlightRecorder",
    "finalize_row",
    "flight_signals",
    "last_n",
    "window_ema",
    "window_slope",
    "xla",
]
