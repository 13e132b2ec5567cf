"""Declarative SLOs: rolling-window burn rates and error budgets
(counterpart of ``evox_tpu/obs/slo.py``, a copy: stdlib only, the same
burn-rate math, ``describe()`` rows and Prometheus series).

A serving stack that sheds and browns out from *raw* signals (queue
pressure, last round seconds) journals decisions whose evidence is ad-hoc
cadence math.  This module formalizes the
objectives: an :class:`SLO` declares what "good" means for one signal of
one tenant class — per-segment latency under a bound, per-tenant
generation throughput over a floor, admission-rejection rate under a
ceiling — and an :class:`SLOTracker` scores every observation against it
over a rolling window, exporting the two numbers an operator (and the
controller) actually acts on:

* **burn rate** — ``bad_fraction / (1 - target)``: the rate the error
  budget is being consumed, normalized so ``1.0`` means "exactly
  sustainable" (the SRE convention).  A burn rate of 2 over the window
  means the budget would be gone in half the window.
* **budget remaining** — ``1 - burn_rate``: the fraction of the window's
  error budget still unspent.  Negative = the objective is already
  violated for this window.

Exported as gauges: ``evox_slo_burn_rate{slo=,class=,window=}`` and
``evox_slo_budget_remaining{slo=,class=,window=}``, plus the raw event
counters ``evox_slo_events_total{slo=,class=,good=}``.

The tracker is deterministic under an injected clock (``at=`` on every
observation, ``now=`` on every query) so burn-rate math is testable
against hand-computed fixtures, and thread-safe (observations arrive from
the daemon's scheduling thread while the endpoint scrapes).

The :class:`~evox_tpu_torch.control.Controller` consumes the tracker (its
``slo=`` wiring): burn rate becomes journaled evidence behind brown-out
entry (``burn_rate``/``burn_enter`` keys) and budget exhaustion tightens
the per-class shed threshold (``budget_remaining``) — formal objectives
replacing the ad-hoc thresholds, with the same pure-decider replay
contract.

Stdlib-only at import, like the whole obs package.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterable

from .metrics import MetricsRegistry

__all__ = ["SLO", "SLOTracker", "SLOStatus", "default_slos"]

# The signal streams the serving stack feeds (callers may define their
# own signal names freely; these are the conventional ones).
SIGNAL_SEGMENT_SECONDS = "segment_seconds"
SIGNAL_TENANT_GENS = "tenant_gens_per_sec"
SIGNAL_ADMISSION = "admission"
# Gateway request availability: pre-judged events (good = the request
# was served without a 5xx; 4xx client mistakes are good events — the
# service answered correctly).  Fed by evox_tpu_torch.service.Gateway.
SIGNAL_GATEWAY = "gateway_availability"
# Cold-start recovery time: wall seconds of journal replay + fold +
# tenant resubmission, observed once per daemon/router start.  Fed by
# evox_tpu.service.ServiceDaemon / TenantRouter; journal compaction is
# the mechanism that keeps this bounded (O(live state), not O(lifetime)).
SIGNAL_RECOVERY = "recovery_replay_seconds"


@dataclass(frozen=True)
class SLO:
    """One service-level objective for one signal of one tenant class.

    :param name: objective label (rides the ``slo=`` metric label).
    :param signal: which observation stream feeds it (e.g.
        ``"segment_seconds"``, ``"tenant_gens_per_sec"``,
        ``"admission"``).
    :param target: the good-event fraction objective, in ``(0, 1)`` —
        e.g. ``0.99`` = at most 1% of events may be bad per window.
    :param threshold: the good/bad boundary for valued observations:
        with ``comparison="le"`` a value is good iff ``value <=
        threshold`` (latency bounds); with ``"ge"`` iff ``value >=
        threshold`` (throughput floors).  ``None`` for streams whose
        events arrive pre-judged (admission accepted/shed).
    :param comparison: ``"le"`` or ``"ge"``.
    :param window_seconds: rolling window the burn rate is computed over.
    :param tenant_class: admission class the objective applies to
        (observations carry a class; ``"*"`` matches every class).
    """

    name: str
    signal: str
    target: float
    threshold: float | None = None
    comparison: str = "le"
    window_seconds: float = 300.0
    tenant_class: str = "standard"

    def __post_init__(self) -> None:
        if not (0.0 < self.target < 1.0):
            raise ValueError(
                f"SLO {self.name!r}: target must be in (0, 1), got "
                f"{self.target}"
            )
        if self.window_seconds <= 0:
            raise ValueError(
                f"SLO {self.name!r}: window_seconds must be > 0, got "
                f"{self.window_seconds}"
            )
        if self.comparison not in ("le", "ge"):
            raise ValueError(
                f"SLO {self.name!r}: comparison must be 'le' or 'ge', got "
                f"{self.comparison!r}"
            )

    def good(self, value: float) -> bool:
        """Judge one valued observation against the threshold."""
        if self.threshold is None:
            raise ValueError(
                f"SLO {self.name!r} has no threshold; its events arrive "
                f"pre-judged (use record(), not observe())"
            )
        if self.comparison == "le":
            return float(value) <= self.threshold
        return float(value) >= self.threshold

    @property
    def error_budget(self) -> float:
        return 1.0 - self.target

    @property
    def window_label(self) -> str:
        w = self.window_seconds
        if w % 3600 == 0:
            return f"{int(w // 3600)}h"
        if w % 60 == 0:
            return f"{int(w // 60)}m"
        return f"{int(w)}s"


@dataclass(frozen=True)
class SLOStatus:
    """One SLO's rolling-window standing at a point in time."""

    slo: SLO
    good: int
    bad: int
    burn_rate: float | None  # None while the window holds no events
    budget_remaining: float | None

    @property
    def total(self) -> int:
        return self.good + self.bad


def default_slos(
    *,
    tenant_class: str = "standard",
    segment_seconds: float = 2.0,
    gens_per_sec: float = 1.0,
    availability: float = 0.99,
    window_seconds: float = 300.0,
    recovery_seconds: float | None = None,
) -> list[SLO]:
    """The conventional serving-objective triple for one tenant class:
    segment latency under a bound, per-tenant throughput over a floor,
    and admission availability (rejections are the bad events).  Set
    ``recovery_seconds`` to also bound cold-start recovery time (the
    class-agnostic ``recovery-time`` objective over
    :data:`SIGNAL_RECOVERY` — journal compaction is what keeps it
    honest)."""
    slos = [
        SLO(
            "segment-latency",
            SIGNAL_SEGMENT_SECONDS,
            target=availability,
            threshold=segment_seconds,
            comparison="le",
            window_seconds=window_seconds,
            tenant_class=tenant_class,
        ),
        SLO(
            "tenant-throughput",
            SIGNAL_TENANT_GENS,
            target=availability,
            threshold=gens_per_sec,
            comparison="ge",
            window_seconds=window_seconds,
            tenant_class=tenant_class,
        ),
        SLO(
            "admission",
            SIGNAL_ADMISSION,
            target=availability,
            window_seconds=window_seconds,
            tenant_class=tenant_class,
        ),
    ]
    if recovery_seconds is not None:
        slos.append(
            SLO(
                "recovery-time",
                SIGNAL_RECOVERY,
                target=availability,
                threshold=float(recovery_seconds),
                comparison="le",
                window_seconds=window_seconds,
                tenant_class="*",
            )
        )
    return slos


class SLOTracker:
    """Score observations against declared SLOs over rolling windows.

    :param slos: the objectives; duplicate ``(name, tenant_class)`` pairs
        are a ValueError (the metric label set would collide).
    :param registry: optional :class:`~evox_tpu_torch.obs.MetricsRegistry` the
        burn-rate / budget gauges publish into on every
        :meth:`publish` (failure-isolated: a broken registry never
        breaks the tracker).
    :param clock: time source for observations without an explicit
        ``at=`` (injectable for deterministic tests).
    """

    def __init__(
        self,
        slos: Iterable[SLO],
        *,
        registry: MetricsRegistry | None = None,
        clock: Any = time.monotonic,
    ):
        self.slos = list(slos)
        seen: set[tuple[str, str]] = set()
        for slo in self.slos:
            key = (slo.name, slo.tenant_class)
            if key in seen:
                raise ValueError(
                    f"duplicate SLO {slo.name!r} for class "
                    f"{slo.tenant_class!r}"
                )
            seen.add(key)
        self.registry = registry
        self.clock = clock
        self._lock = threading.Lock()
        # per SLO: deque of (timestamp, good: bool, n)
        self._events: dict[tuple[str, str], deque] = {
            (s.name, s.tenant_class): deque() for s in self.slos
        }

    # -- feeding -------------------------------------------------------------
    def _matching(self, signal: str, tenant_class: str) -> list[SLO]:
        return [
            s
            for s in self.slos
            if s.signal == signal
            and (s.tenant_class == "*" or s.tenant_class == str(tenant_class))
        ]

    def observe(
        self,
        signal: str,
        value: float,
        *,
        tenant_class: str = "standard",
        n: int = 1,
        at: float | None = None,
    ) -> None:
        """Score one valued observation (latency, throughput) against
        every matching thresholded SLO."""
        for slo in self._matching(signal, tenant_class):
            if slo.threshold is None:
                continue
            self._record(slo, slo.good(value), n, at)

    def record(
        self,
        signal: str,
        good: bool,
        *,
        tenant_class: str = "standard",
        n: int = 1,
        at: float | None = None,
    ) -> None:
        """Feed one pre-judged event (an admission accepted, a submission
        shed) to every matching SLO."""
        for slo in self._matching(signal, tenant_class):
            self._record(slo, bool(good), n, at)

    def _record(self, slo: SLO, good: bool, n: int, at: float | None) -> None:
        t = float(at) if at is not None else float(self.clock())
        with self._lock:
            self._events[(slo.name, slo.tenant_class)].append((t, good, int(n)))

    # -- queries -------------------------------------------------------------
    def _trim(self, slo: SLO, now: float) -> deque:
        events = self._events[(slo.name, slo.tenant_class)]
        horizon = now - slo.window_seconds
        while events and events[0][0] < horizon:
            events.popleft()
        return events

    def status(self, slo: SLO, *, now: float | None = None) -> SLOStatus:
        """The SLO's standing over its rolling window.  Burn rate is
        ``bad_fraction / error_budget`` (``1.0`` = consuming the budget
        exactly at the sustainable rate); budget remaining is
        ``1 - burn_rate``.  Both ``None`` while the window is empty —
        no evidence is not good news and not bad news."""
        t = float(now) if now is not None else float(self.clock())
        with self._lock:
            events = self._trim(slo, t)
            good = sum(n for _, g, n in events if g)
            bad = sum(n for _, g, n in events if not g)
        total = good + bad
        if total == 0:
            return SLOStatus(slo, 0, 0, None, None)
        burn = (bad / total) / slo.error_budget
        return SLOStatus(slo, good, bad, burn, 1.0 - burn)

    def statuses(self, *, now: float | None = None) -> list[SLOStatus]:
        return [self.status(s, now=now) for s in self.slos]

    def worst(
        self, *, tenant_class: str | None = None, now: float | None = None
    ) -> SLOStatus | None:
        """The highest-burn SLO (optionally restricted to one tenant
        class); ``None`` when no matching window holds events."""
        candidates = [
            st
            for st in self.statuses(now=now)
            if st.burn_rate is not None
            and (
                tenant_class is None
                or st.slo.tenant_class in ("*", str(tenant_class))
            )
        ]
        if not candidates:
            return None
        return max(candidates, key=lambda st: st.burn_rate)

    # -- export --------------------------------------------------------------
    def publish(self, *, now: float | None = None) -> None:
        """Publish every SLO's burn-rate / budget gauges and event
        counters into the registry (failure-isolated)."""
        if self.registry is None:
            return
        try:
            for st in self.statuses(now=now):
                labels = {
                    "slo": st.slo.name,
                    "tenant_class": st.slo.tenant_class,
                    "window": st.slo.window_label,
                }
                if st.burn_rate is not None:
                    self.registry.gauge(
                        "evox_slo_burn_rate",
                        "Error-budget burn rate over the rolling window "
                        "(1.0 = exactly sustainable).",
                        **labels,
                    ).set(st.burn_rate)
                    self.registry.gauge(
                        "evox_slo_budget_remaining",
                        "Fraction of the window's error budget unspent "
                        "(negative = objective violated).",
                        **labels,
                    ).set(st.budget_remaining)
                self.registry.gauge(
                    "evox_slo_window_events",
                    "Events in the SLO's rolling window.",
                    **labels,
                ).set(st.total)
        except Exception:  # pragma: no cover - broken registry
            pass

    def describe(self, *, now: float | None = None) -> list[dict[str, Any]]:
        """JSON-ready standing of every SLO (the ``/statusz`` section)."""
        out: list[dict[str, Any]] = []
        for st in self.statuses(now=now):
            out.append(
                {
                    "slo": st.slo.name,
                    "tenant_class": st.slo.tenant_class,
                    "signal": st.slo.signal,
                    "target": st.slo.target,
                    "threshold": st.slo.threshold,
                    "window": st.slo.window_label,
                    "good": st.good,
                    "bad": st.bad,
                    "burn_rate": st.burn_rate,
                    "budget_remaining": st.budget_remaining,
                }
            )
        return out
