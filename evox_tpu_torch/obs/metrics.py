"""Process-local metrics registry: counters, gauges, histograms
(counterpart of ``evox_tpu/obs/metrics.py``, a copy: stdlib only, and the
Prometheus text is the JAX package's, string for string, for the same
calls).

One :class:`MetricsRegistry` per process (``default_registry()``) is the
single namespace every subsystem publishes into — ``RunStats`` deltas from
the :class:`~evox_tpu_torch.resilience.ResilientRunner`, ``EvalMonitor``
counters read off the state at segment boundaries, and the async
checkpoint writer's publish/failure/block-seconds.  Two export shapes:

* :meth:`MetricsRegistry.snapshot` — a plain dict keyed by the
  label-qualified series name (``name{k="v"}``), for tests and in-process
  consumers;
* :meth:`MetricsRegistry.to_prometheus` /
  :meth:`MetricsRegistry.write_prometheus` — the Prometheus text
  exposition format, written atomically (temp + ``os.replace``) so a
  scraper's textfile collector never reads a torn snapshot.

:meth:`MetricsRegistry.heartbeat_payload` and
:meth:`MetricsRegistry.fleet_payload` are the payload shapes the JAX
package's multi-host heartbeats carry; the fleet plane's
:class:`~evox_tpu_torch.obs.FleetAggregator` (``obs/aggregate.py``) merges
them.

Everything is thread-safe (one registry lock): the async checkpoint
writer publishes from its worker thread.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterable, Mapping, Union

from .version import OBS_SCHEMA_VERSION

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "parse_series",
    "reset_default_registry",
]

# Prometheus' own default histogram buckets: a reasonable spread for the
# seconds-denominated timings (compile, execute, checkpoint block) the
# framework observes.
DEFAULT_BUCKETS = (
    0.005,
    0.01,
    0.025,
    0.05,
    0.1,
    0.25,
    0.5,
    1.0,
    2.5,
    5.0,
    10.0,
)


def _label_suffix(labels: Mapping[str, str]) -> str:
    """``{k="v",...}`` with keys sorted — one canonical series name per
    label set, whatever order call sites pass the labels in."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _unescape(value: str) -> str:
    out: list[str] = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def parse_series(series: str) -> tuple[str, dict[str, str]]:
    """Invert :func:`_label_suffix`: split a label-qualified series name
    (``name{k="v",...}``) back into ``(name, labels)``.  The ONE parser
    for the canonical series-string key shared by snapshots, heartbeat
    payloads, and the fleet aggregator — which needs the label set back
    to re-label per-host gauges with ``process_index``."""
    brace = series.find("{")
    if brace < 0:
        return series, {}
    name = series[:brace]
    inner = series[brace:]
    if not inner.endswith("}"):
        raise ValueError(f"malformed series {series!r}")
    labels: dict[str, str] = {}
    rest = inner[1:-1]
    pos = 0
    while pos < len(rest):
        eq = rest.find('="', pos)
        if eq < 0:
            raise ValueError(f"malformed series {series!r}")
        key = rest[pos:eq]
        # Find the closing quote, skipping escaped ones.
        scan = eq + 2
        while True:
            close = rest.find('"', scan)
            if close < 0:
                raise ValueError(f"malformed series {series!r}")
            backslashes = 0
            while rest[close - 1 - backslashes] == "\\":
                backslashes += 1
            if backslashes % 2 == 0:
                break
            scan = close + 1
        labels[key] = _unescape(rest[eq + 2 : close])
        pos = close + 1
        if pos < len(rest) and rest[pos] == ",":
            pos += 1
    return name, labels


class _Metric:
    """Shared handle plumbing: one instance per (name, label set)."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, labels: Mapping[str, str]):
        self._registry = registry
        self.name = name
        self.labels = dict(labels)

    @property
    def series(self) -> str:
        return self.name + _label_suffix(self.labels)


class Counter(_Metric):
    """Monotone counter.  ``inc`` with a negative amount is a ValueError —
    a counter that goes down is a gauge wearing the wrong type."""

    kind = "counter"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {amount}); use a "
                f"gauge for values that go down"
            )
        with self._registry._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._registry._lock:
            return self._value

    def _sample(self) -> dict[str, float]:
        return {self.series: self._value}


class Gauge(_Metric):
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._registry._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._registry._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._registry._lock:
            return self._value

    def _sample(self) -> dict[str, float]:
        return {self.series: self._value}


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each ``le``
    bucket counts observations at or below its bound, ``+Inf`` counts
    everything; ``_sum`` and ``_count`` ride alongside)."""

    kind = "histogram"

    def __init__(self, registry, name, labels, buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, labels)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.bounds = tuple(bounds)
        self._bucket_counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        with self._registry._lock:
            self._sum += value
            self._count += 1
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    self._bucket_counts[i] += 1
            self._bucket_counts[-1] += 1

    def merge(
        self,
        bucket_deltas: Iterable[float],
        sum_delta: float,
        count_delta: float,
    ) -> None:
        """Fold another histogram's (delta) distribution into this one —
        the fleet aggregator's bucket-wise merge.  ``bucket_deltas`` must
        match this histogram's bucket count (bounds + ``+Inf``); negative
        deltas are a ValueError (a shrinking cumulative distribution is a
        counter reset, which the caller must detect and re-base first)."""
        deltas = [float(d) for d in bucket_deltas]
        if len(deltas) != len(self._bucket_counts):
            raise ValueError(
                f"histogram {self.name} merge expects "
                f"{len(self._bucket_counts)} bucket deltas, got {len(deltas)}"
            )
        if any(d < 0 for d in deltas) or count_delta < 0:
            raise ValueError(
                f"histogram {self.name} merge deltas cannot be negative"
            )
        with self._registry._lock:
            for i, d in enumerate(deltas):
                self._bucket_counts[i] += d
            self._sum += float(sum_delta)
            self._count += int(count_delta)

    @property
    def count(self) -> int:
        with self._registry._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._registry._lock:
            return self._sum

    def _sample(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for bound, count in zip(
            (*self.bounds, math.inf), self._bucket_counts
        ):
            le = "+Inf" if math.isinf(bound) else repr(bound)
            labels = dict(self.labels, le=le)
            out[f"{self.name}_bucket" + _label_suffix(labels)] = float(count)
        out[f"{self.name}_sum" + _label_suffix(self.labels)] = self._sum
        out[f"{self.name}_count" + _label_suffix(self.labels)] = float(
            self._count
        )
        return out


class MetricsRegistry:
    """A process-local family of named metrics with label sets.

    Handles are memoized: ``registry.counter("x", tenant_id="a")`` returns
    the same :class:`Counter` on every call, so call sites need no caching
    of their own.  Re-requesting a name as a different metric type is a
    loud ``ValueError`` — two subsystems silently sharing a name across
    types would corrupt the export.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        # name -> (kind, help); series handles live in _metrics.
        self._families: dict[str, tuple[str, str]] = {}
        self._metrics: dict[tuple[str, tuple], _Metric] = {}

    # -- handle construction ----------------------------------------------
    def _get(self, cls, name: str, help: str, labels: Mapping[str, str], **kw):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            family = self._families.get(name)
            if family is not None and family[0] != cls.kind:
                raise ValueError(
                    f"metric {name!r} is already registered as a "
                    f"{family[0]}, cannot re-register as a {cls.kind}"
                )
            if family is None or (help and not family[1]):
                self._families[name] = (cls.kind, help or (family[1] if family else ""))
            metric = self._metrics.get(key)
            if metric is None:
                metric = cls(
                    self,
                    name,
                    labels,
                    **{k: v for k, v in kw.items() if v is not None},
                )
                self._metrics[key] = metric
            elif isinstance(metric, Histogram) and kw.get("buckets") is not None:
                # Same loud-conflict contract as the type check: silently
                # returning the memoized handle with DIFFERENT buckets
                # would corrupt the distribution without a signal.  A
                # caller that omits buckets accepts whatever the series
                # was registered with — so framework call sites (which
                # never pass buckets) compose with user-customized ones.
                bounds = tuple(sorted(float(b) for b in kw["buckets"]))
                if bounds != metric.bounds:
                    raise ValueError(
                        f"histogram {name!r} is already registered with "
                        f"buckets {metric.bounds}, cannot re-register "
                        f"with {bounds}"
                    )
            return metric

    def counter(self, name: str, help: str = "", **labels: Any) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: Any) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Iterable[float] | None = None,
        **labels: Any,
    ) -> Histogram:
        """``buckets=None`` (the default) means "whatever this series was
        (or will be) registered with" — ``DEFAULT_BUCKETS`` on first
        registration; an explicit bucket set that conflicts with an
        existing series raises."""
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def counter_sync(
        self, cursor: dict, name: str, value: float, help: str = ""
    ) -> None:
        """Publish a scope-local monotone stat (a ``RunStats`` field, a
        ``FleetStats`` field) as a process-level counter: increment by
        the delta against ``cursor`` (which the caller resets together
        with its stats object, so deltas stay non-negative across
        runs).  The one definition of the cursor-delta pattern the
        runner and the fleet supervisor share."""
        delta = value - cursor.get(name, 0.0)
        if delta > 0:
            self.counter(name, help).inc(delta)
        cursor[name] = value

    # -- exports ------------------------------------------------------------
    def snapshot(self) -> dict[str, float]:
        """Every series as ``{label-qualified name: value}`` — histograms
        expand into their ``_bucket``/``_sum``/``_count`` series."""
        with self._lock:
            out: dict[str, float] = {}
            for metric in self._metrics.values():
                out.update(metric._sample())
            return out

    def heartbeat_payload(self) -> dict[str, float]:
        """The flat counters-and-gauges dict that rides a
        ``HostHeartbeat`` (the JAX package's multi-host plane) beat (histogram buckets
        are dropped: beats are small JSON files republished twice a
        second; ``_sum``/``_count`` still ride so rates are computable)."""
        with self._lock:
            out: dict[str, float] = {}
            for metric in self._metrics.values():
                if isinstance(metric, Histogram):
                    out[f"{metric.name}_sum" + _label_suffix(metric.labels)] = (
                        metric._sum
                    )
                    out[
                        f"{metric.name}_count" + _label_suffix(metric.labels)
                    ] = float(metric._count)
                else:
                    out.update(metric._sample())
            return out

    def fleet_payload(self) -> dict[str, Any]:
        """The typed snapshot that rides a
        ``HostHeartbeat`` (the JAX package's multi-host plane) beat for fleet-level
        aggregation (:class:`~evox_tpu_torch.obs.FleetAggregator`): counters
        and gauges as flat ``{series: value}`` sections, histograms with
        their full bucket arrays (``bounds``/``counts``/``sum``/``count``)
        — the flat :meth:`heartbeat_payload` cannot be merged bucket-wise.
        All JSON-serializable; ``schema`` stamps the obs schema version."""
        with self._lock:
            counters: dict[str, float] = {}
            gauges: dict[str, float] = {}
            histograms: dict[str, dict[str, Any]] = {}
            for metric in self._metrics.values():
                if isinstance(metric, Histogram):
                    histograms[metric.series] = {
                        "bounds": list(metric.bounds),
                        "counts": [float(c) for c in metric._bucket_counts],
                        "sum": metric._sum,
                        "count": float(metric._count),
                    }
                elif isinstance(metric, Counter):
                    counters[metric.series] = metric._value
                else:
                    gauges[metric.series] = metric._value
            return {
                "schema": OBS_SCHEMA_VERSION,
                "counters": counters,
                "gauges": gauges,
                "histograms": histograms,
            }

    def remove_series(self, name: str, **labels: Any) -> bool:
        """Drop exactly one series (by name + label set); returns whether
        it existed.  The fleet aggregator re-labels a stale host's gauges
        (``stale="true"``) by removing the fresh series and publishing the
        marked one — series identity is the label set, so the swap is a
        remove + re-register."""
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            return self._metrics.pop(key, None) is not None

    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (``# HELP``/``# TYPE``
        per family, one sample line per series), plus the obs schema
        version as its own gauge so a scrape is self-describing."""
        with self._lock:
            by_family: dict[str, list[str]] = {}
            # Series sorted by label set; within one series the sample
            # order is preserved (histogram buckets must stay in
            # ascending ``le`` order, which lexical sorting would break).
            for metric in sorted(
                self._metrics.values(), key=lambda m: m.series
            ):
                lines = by_family.setdefault(metric.name, [])
                for series, value in metric._sample().items():
                    lines.append(f"{series} {_format_value(value)}")
            out: list[str] = [
                "# HELP evox_obs_schema_version Observability schema version.",
                "# TYPE evox_obs_schema_version gauge",
                f"evox_obs_schema_version {OBS_SCHEMA_VERSION}",
            ]
            for name in sorted(by_family):
                kind, help = self._families.get(name, ("untyped", ""))
                if help:
                    out.append(f"# HELP {name} {help}")
                out.append(f"# TYPE {name} {kind}")
                out.extend(by_family[name])
            return "\n".join(out) + "\n"

    def write_prometheus(self, path: Union[str, Path]) -> Path:
        """Atomically publish :meth:`to_prometheus` to ``path`` (temp +
        ``os.replace``): a textfile-collector scrape racing the write sees
        the old snapshot or the new one, never a torn file."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        text = self.to_prometheus()
        fd, tmp = tempfile.mkstemp(
            dir=path.parent, prefix=path.name + ".tmp."
        )
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, path)
            tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        return path

    def remove_labeled(self, label: str, value: Any) -> int:
        """Drop every series carrying ``label == value``; returns how many
        were removed.  High-churn label values (the service's
        ``tenant_id``) would otherwise accumulate immortal series — and
        grow every Prometheus snapshot and heartbeat payload — long after
        their subject is gone; the service calls this from ``forget()``."""
        value = str(value)
        with self._lock:
            doomed = [
                key
                for key, metric in self._metrics.items()
                if str(metric.labels.get(label)) == value
                and label in metric.labels
            ]
            for key in doomed:
                del self._metrics[key]
            return len(doomed)

    def clear(self) -> None:
        """Drop every registered series (tests; a fresh run in a live
        process should usually use a fresh registry instead)."""
        with self._lock:
            self._families.clear()
            self._metrics.clear()


def _format_value(value: float) -> str:
    # Non-finite first (int() would raise), in the spellings the
    # Prometheus text format actually parses.
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(value)


_DEFAULT_LOCK = threading.Lock()
_DEFAULT: MetricsRegistry | None = None


def default_registry() -> MetricsRegistry:
    """The process-local registry every subsystem publishes into unless
    handed an explicit one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh process-local registry (tests) and return it."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT
