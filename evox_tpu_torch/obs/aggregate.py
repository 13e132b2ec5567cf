"""Fleet-level metric aggregation: merge per-host registry snapshots
(counterpart of ``evox_tpu/obs/aggregate.py``, a copy: stdlib only, and the
merged registry's Prometheus text is the JAX package's for the same beats).

Every host of a supervised fleet publishes its
:class:`~evox_tpu_torch.obs.MetricsRegistry` snapshot inside its
:class:`~evox_tpu_torch.parallel.HostHeartbeat` beats
(``HostHeartbeat(metrics=registry)``: the typed
:meth:`~evox_tpu_torch.obs.MetricsRegistry.fleet_payload` with full
histogram bucket arrays).  :class:`FleetAggregator` folds the per-host
payloads into ONE fleet-level registry:

* **counters** are summed across hosts under their own series name.  Each
  host's cumulative value is tracked against a per-``(host, series)``
  cursor, so the fleet counter stays *monotone across host relaunches*: a
  relaunched process restarts its counters at zero, which the cursor
  detects (a value below the cursor, or a changed worker ``pid``) and
  re-bases — the fresh process's full value is the delta.
* **gauges** are re-labeled with the producing host
  (``{process_index="3"}``): a last-write-wins scalar has no cross-host
  sum, so the fleet view keeps one series per host.
* **histograms** are merged bucket by bucket through per-``(host, series)``
  cursor deltas into a fleet histogram with the same bounds (hosts that
  disagree on the bounds are skipped with a warning).

**Staleness.**  A host the :class:`~evox_tpu_torch.parallel.FleetHealth`
verdicts declare dead (or whose beat vanished) must not look frozen but
healthy: its gauge series are re-labeled ``stale="true"`` (last value
kept), its ``evox_fleet_host_up{process_index=}`` gauge drops to 0, and its
payload stops feeding the merge.  When the host comes back (a relaunch),
the stale series are retired, ``host_up`` returns to 1, and its counters
resume through the cursor re-base.

The module is stdlib-only at import; :meth:`FleetAggregator.update_from_dir`
imports the heartbeat reader when called.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Any, Iterable, Mapping

from .metrics import MetricsRegistry, parse_series

__all__ = ["FleetAggregator"]

HOST_LABEL = "process_index"
STALE_LABEL = "stale"


class FleetAggregator:
    """Merge per-host heartbeat metric payloads into one fleet registry.

    Usage (a supervisor or operator process)::

        agg = FleetAggregator()
        health = FleetHealth(heartbeat_dir, num_processes=4)
        while serving:
            agg.update(read_heartbeats(heartbeat_dir), health.check())
            agg.registry.write_prometheus("fleet.prom")   # or /metrics

    :param registry: the fleet-level target registry; ``None`` builds a
        private one.  A fleet supervisor passes its OWN registry so the
        ``evox_fleet_*`` supervisor series and the aggregated host series
        export as one scrape — safe because the supervisor process never
        publishes the host-side series names itself.  A *daemon* serving
        a fleet view must NOT pass its own registry (its own series
        arrive through its own beat; merging them into the same registry
        would double-count).
    :param host_label: label the per-host gauge series carry (default
        ``process_index``).
    """

    def __init__(
        self,
        *,
        registry: MetricsRegistry | None = None,
        host_label: str = HOST_LABEL,
    ):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.host_label = str(host_label)
        # One update at a time: endpoint scrapes arrive on concurrent
        # handler threads (and can race a supervisor's final fold) —
        # two folds reading the same cursor would both apply the same
        # delta and permanently inflate the fleet counters.
        self._lock = threading.Lock()
        # (host, series) -> last cumulative counter value seen.
        self._counter_cursor: dict[tuple[int, str], float] = {}
        # (host, series) -> (bucket counts, sum, count) last seen.
        self._hist_cursor: dict[tuple[int, str], tuple[list, float, float]] = {}
        # host -> pid of the beats feeding the cursors (relaunch detector).
        self._pid: dict[int, Any] = {}
        # host -> {series: (name, labels)} of the gauge series published.
        self._gauges: dict[int, dict[str, tuple[str, dict]]] = {}
        self._stale: dict[int, bool] = {}
        self._bounds_warned: set[str] = set()
        self.updates = 0

    # -- feeding -------------------------------------------------------------
    def update(
        self,
        beats: Mapping[int, Mapping[str, Any]],
        report: Any | None = None,
        *,
        stale_hosts: Iterable[int] | None = None,
    ) -> None:
        """Fold one reading of the heartbeat plane into the fleet registry.

        :param beats: ``{process_index: beat payload}`` as
            :func:`~evox_tpu_torch.parallel.read_heartbeats` returns.
        :param report: optional :class:`~evox_tpu_torch.parallel.FleetReport`
            — hosts it declares **dead** are marked stale (their last
            exported series re-labeled ``stale="true"``) instead of
            silently frozen.  Wedged/slow hosts keep feeding: their
            processes are alive and their counters are still the truth.
        :param stale_hosts: explicit staleness override for callers
            without a :class:`~evox_tpu_torch.parallel.FleetHealth` (takes
            precedence over ``report``).
        """
        if stale_hosts is not None:
            stale = set(int(h) for h in stale_hosts)
        elif report is not None:
            stale = set(getattr(report, "dead_hosts", ()) or ())
        else:
            stale = set()
        with self._lock:
            # A host we have exported before but whose beat vanished
            # outright (cleared heartbeat dir between attempts) is
            # stale too.
            stale |= set(self._gauges) - set(beats)
            for host in sorted(beats):
                if host in stale:
                    continue
                payload = beats[host].get("metrics")
                if not isinstance(payload, Mapping):
                    continue
                self._ingest(int(host), beats[host], payload)
            for host in sorted(set(beats) | stale | set(self._stale)):
                self._mark_stale(int(host), host in stale)
            self.updates += 1
        self.registry.gauge(
            "evox_fleet_aggregated_hosts",
            "Hosts whose metrics fed the last fleet aggregation.",
        ).set(len([h for h in beats if h not in stale]))

    def update_from_dir(
        self,
        directory: Any,
        health: Any | None = None,
        *,
        now: float | None = None,
    ) -> Any | None:
        """Convenience: read the heartbeat directory, render verdicts
        through ``health`` (a :class:`~evox_tpu_torch.parallel.FleetHealth`)
        when given, and :meth:`update`.  Returns the report (or ``None``
        when no health checker was supplied — staleness then falls back
        to hosts that stopped beating entirely)."""
        from ..parallel.multihost import read_heartbeats

        beats = read_heartbeats(directory)
        report = None
        if health is not None:
            report = health.check(now if now is not None else time.time())
        self.update(beats, report)
        return report

    # -- merge internals -----------------------------------------------------
    def _ingest(
        self, host: int, beat: Mapping[str, Any], payload: Mapping[str, Any]
    ) -> None:
        pid = beat.get("pid")
        relaunched = host in self._pid and self._pid[host] != pid
        if relaunched:
            # A new process: its counters restarted at zero.  Drop the
            # cursors so the fresh values re-base as full deltas.
            for key in [k for k in self._counter_cursor if k[0] == host]:
                del self._counter_cursor[key]
            for key in [k for k in self._hist_cursor if k[0] == host]:
                del self._hist_cursor[key]
        self._pid[host] = pid
        for series, value in dict(payload.get("counters") or {}).items():
            self._merge_counter(host, series, float(value))
        for series, value in dict(payload.get("gauges") or {}).items():
            self._merge_gauge(host, series, float(value))
        for series, hist in dict(payload.get("histograms") or {}).items():
            if isinstance(hist, Mapping):
                self._merge_histogram(host, series, hist)
        # Legacy flat payloads (no typed sections): best effort — treat
        # every ``*_total`` series as a counter, the rest as gauges.
        if "counters" not in payload and "gauges" not in payload:
            for series, value in payload.items():
                if not isinstance(value, (int, float)):
                    continue
                name, _ = parse_series(str(series))
                if name.endswith("_total"):
                    self._merge_counter(host, str(series), float(value))
                else:
                    self._merge_gauge(host, str(series), float(value))

    def _merge_counter(self, host: int, series: str, value: float) -> None:
        cursor = self._counter_cursor.get((host, series), 0.0)
        # value < cursor = the process-local counter restarted (relaunch
        # the pid check missed): the full new value is the delta.
        delta = value - cursor if value >= cursor else value
        self._counter_cursor[(host, series)] = value
        if delta <= 0:
            return
        name, labels = parse_series(series)
        self.registry.counter(name, **labels).inc(delta)

    def _merge_gauge(self, host: int, series: str, value: float) -> None:
        name, labels = parse_series(series)
        if self._stale.get(host):
            # Coming back from stale: retire the marked series first.
            self._retire_host_gauges(host)
            self._stale[host] = False
        labels = dict(labels, **{self.host_label: str(host)})
        self.registry.gauge(name, **labels).set(value)
        self._gauges.setdefault(host, {})[series] = (name, labels)

    def _merge_histogram(
        self, host: int, series: str, hist: Mapping[str, Any]
    ) -> None:
        bounds = [float(b) for b in hist.get("bounds") or ()]
        counts = [float(c) for c in hist.get("counts") or ()]
        if not bounds or len(counts) != len(bounds) + 1:
            return
        name, labels = parse_series(series)
        try:
            target = self.registry.histogram(name, buckets=bounds, **labels)
        except ValueError:
            # The fleet series is registered with different bounds (the
            # registry's loud-conflict contract): two host configurations
            # share a series name — skip this host's series with one
            # warning rather than blending incomparable distributions.
            if series not in self._bounds_warned:
                self._bounds_warned.add(series)
                warnings.warn(
                    f"fleet aggregation: host {host} reports histogram "
                    f"{series} with buckets {tuple(bounds)} that conflict "
                    f"with the registered fleet series; skipping"
                )
            return
        prev_counts, prev_sum, prev_count = self._hist_cursor.get(
            (host, series), ([0.0] * len(counts), 0.0, 0.0)
        )
        total = float(hist.get("count") or 0.0)
        hsum = float(hist.get("sum") or 0.0)
        if total < prev_count or len(prev_counts) != len(counts):
            # Counter reset mid-stream: re-base on the full new values.
            prev_counts, prev_sum, prev_count = [0.0] * len(counts), 0.0, 0.0
        deltas = [c - p for c, p in zip(counts, prev_counts)]
        if any(d < 0 for d in deltas):
            # Inconsistent snapshot (torn beat) — skip WITHOUT advancing
            # the cursor, so the next consistent beat deltas against the
            # last merged snapshot instead of the garbage.
            return
        self._hist_cursor[(host, series)] = (counts, hsum, total)
        target.merge(deltas, hsum - prev_sum, total - prev_count)

    # -- staleness -----------------------------------------------------------
    def _mark_stale(self, host: int, stale: bool) -> None:
        was = self._stale.get(host, False)
        self.registry.gauge(
            "evox_fleet_host_up",
            "Whether the host's heartbeat metrics are fresh (0 = stale/"
            "dead: its series carry stale=\"true\").",
            **{self.host_label: str(host)},
        ).set(0.0 if stale else 1.0)
        if stale and not was:
            # Swap every gauge series the host published to the
            # stale-marked label set, retaining the last value (evidence
            # beats a silently frozen series).
            marked: dict[str, tuple[str, dict]] = {}
            for series, (name, labels) in self._gauges.get(host, {}).items():
                handle = self.registry.gauge(name, **labels)
                value = handle.value
                self.registry.remove_series(name, **labels)
                stale_labels = dict(labels, **{STALE_LABEL: "true"})
                self.registry.gauge(name, **stale_labels).set(value)
                marked[series] = (name, stale_labels)
            if marked:
                self._gauges[host] = marked
            self._stale[host] = True
        elif not stale and was:
            # The host came back: _merge_gauge usually already retired
            # the stale series on the first fresh value, but a returning
            # host whose beats carry no gauges would otherwise export
            # host_up=1 beside its old stale="true" series forever.
            self._retire_host_gauges(host)
            self._stale[host] = False

    def _retire_host_gauges(self, host: int) -> None:
        for name, labels in self._gauges.get(host, {}).values():
            self.registry.remove_series(name, **labels)
        self._gauges[host] = {}

    # -- exports (delegate to the fleet registry) ----------------------------
    def snapshot(self) -> dict[str, float]:
        return self.registry.snapshot()

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def write_prometheus(self, path: Any):
        return self.registry.write_prometheus(path)
