"""The closed-loop controller: observe → decide → act, deterministically
(counterpart of ``evox_tpu/control/controller.py``, a copy: pure host code,
the same deciders, evidence dicts and journal records).

The observation plane (flight recorder, per-segment timings, metrics
registry) and the durable journal feed the *decide* half of the loop.  A
:class:`Controller` consumes

* the flight recorder's per-generation signal window (via the
  NaN-robust trend queries in :mod:`evox_tpu_torch.obs.flight` — one
  window math shared with ad-hoc postmortem analysis),
* ``RunStats.segment_timings`` (measured capture / execute /
  checkpoint-block seconds per segment; on the card a segment's
  "compile" is the capture of its CUDA graph), and
* live scheduler state (queue pressure, class depths, round seconds),

and renders structured, journaled :class:`~evox_tpu_torch.control.Decision`\\ s
that the :class:`~evox_tpu_torch.resilience.ResilientRunner` and the
:class:`~evox_tpu_torch.hpo.HPORunner` *act* on (the service's consults —
tenant, brown-out, shed, autoscale, compaction — are here too; the
daemon calls them, the router is not ported yet):

* **trend verdicts** — fitness-slope stagnation, diversity-collapse
  trajectory, and quarantine-storm prediction computed from the flight
  window (EMA/slope), so restarts fire *before* a run wedges rather
  than after a threshold-probe window elapses;
* **self-tuning cadence** — the next segment's scan length sized from
  measured capture/execute ratios and checkpoint-block seconds
  (generalizing ``checkpoint_wall_interval``);
* **graduated degradation** — per-tenant restart/quarantine/evict
  scoring, brown-out entry/exit with hysteresis, and SLO-aware shed
  thresholds recomputed from live per-segment timings.

**Determinism.**  Every decision's action is a pure function of its
evidence dict (the module-level ``decide_*`` functions), and the
evidence — measured values plus the thresholds in force — is journaled
with the decision, so :meth:`Controller.replay_decisions` reproduces the
identical decision sequence from a replayed journal bit-for-bit, whichever
package wrote the journal.

**Robustness.**  The controller is strictly advisory and strictly
host-side: every public consult method is exception-guarded and
degrades to "no opinion" — the consumer's existing threshold probes
remain the baseline behavior.  The first failure of each control plane
(trend / cadence / brownout / shed) latches that plane off, emits one
``degrade`` decision and one structured warning event, and the run
continues; a missing/NaN signal, a detached flight recorder, a torn
decision record, or a failed journal append can never crash a run.
Nothing here touches the card.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Iterable, Mapping, Sequence

from .decision import Decision

__all__ = [
    "Controller",
    "decide",
    "decide_autoscale",
    "decide_brownout",
    "decide_cadence",
    "decide_compact",
    "decide_hpo_grow",
    "decide_shed",
    "decide_tenant",
    "decide_trend",
]


# ---------------------------------------------------------------------------
# Pure deciders: evidence dict -> action.  These are the replay contract —
# given the journaled evidence, each reproduces the journaled action
# bit-for-bit.  No wall clock, no randomness, no state.
# ---------------------------------------------------------------------------


def _num(evidence: Mapping[str, Any], key: str) -> float | None:
    value = evidence.get(key)
    return None if value is None else float(value)


def decide_trend(evidence: Mapping[str, Any]) -> str | None:
    """Trend verdict from a flight-window evidence dict; ``None`` when no
    detector trips.  Detectors (each armed only when its threshold is in
    the evidence AND its signal estimate exists — NaN-robust estimation
    upstream returns ``None`` for unusable signals):

    * ``stagnation`` — the best-fitness slope projects less than
      ``stagnation_tol`` total improvement over the window's generation
      span, and the span has reached ``stagnation_window`` generations;
    * ``collapse`` — population diversity is falling and its EMA,
      extrapolated ``collapse_horizon`` generations by the slope, drops
      under ``diversity_floor`` (the *trajectory* detector: it fires
      while the instantaneous value still looks healthy);
    * ``storm`` — the cumulative quarantine counter grows at
      ``storm_rate`` or more individuals per generation (predicts the
      probe's non-finite verdict before the state actually wedges).

    Multiple tripped detectors concatenate (``"stagnation+collapse"``),
    most-chronic first."""
    reasons: list[str] = []
    tol = _num(evidence, "stagnation_tol")
    min_span = _num(evidence, "stagnation_window")
    slope = _num(evidence, "best_slope")
    span = _num(evidence, "span") or 0.0
    if (
        tol is not None
        and min_span is not None
        and min_span > 0
        and slope is not None
        and span >= min_span
        and (-slope) * span <= tol
    ):
        reasons.append("stagnation")
    floor = _num(evidence, "diversity_floor")
    d_slope = _num(evidence, "diversity_slope")
    d_ema = _num(evidence, "diversity_ema")
    horizon = _num(evidence, "collapse_horizon") or 0.0
    if (
        floor is not None
        and d_slope is not None
        and d_ema is not None
        and d_slope < 0.0
        and d_ema + d_slope * horizon < floor
    ):
        reasons.append("collapse")
    rate = _num(evidence, "storm_rate")
    n_slope = _num(evidence, "nonfinite_slope")
    if rate is not None and n_slope is not None and n_slope >= rate:
        reasons.append("storm")
    return "+".join(reasons) if reasons else None


def decide_cadence(evidence: Mapping[str, Any]) -> int:
    """Next segment's scan length from measured timing evidence:
    the largest power of two within ``target_seconds`` of execution
    (``None`` = unbounded), grown further while the per-boundary
    overhead (segment capture + checkpoint block) exceeds ``overhead_cap``
    as a fraction of segment wall — never past ``checkpoint_every``.
    Power-of-two quantization bounds the distinct captured segments at
    ``log2(checkpoint_every) + 1`` (plus a run's ragged tail), exactly like
    ``checkpoint_wall_interval``."""
    per_gen = max(_num(evidence, "per_gen_seconds") or 0.0, 1e-9)
    every = max(int(_num(evidence, "checkpoint_every") or 1), 1)
    target = _num(evidence, "target_seconds")
    cap = _num(evidence, "overhead_cap")
    boundary = _num(evidence, "boundary_seconds") or 0.0
    limit = (target / per_gen) if target else float(every)
    chunk = 1
    while chunk * 2 <= limit and chunk * 2 <= every:
        chunk *= 2
    if cap:
        # Boundary-overhead floor beats the wall target: amortize a heavy
        # checkpoint/capture cost over a longer scan even when that
        # stretches the segment past target_seconds.
        while (
            boundary / (boundary + chunk * per_gen) > cap and chunk * 2 <= every
        ):
            chunk *= 2
    return chunk


def decide_brownout(evidence: Mapping[str, Any]) -> str:
    """Brown-out transition with hysteresis: ``"enter"`` when inactive
    and queue pressure reaches ``enter`` OR the SLO burn rate reaches
    ``burn_enter`` (the formalized-objective trigger — evidence carries
    ``burn_rate`` when the controller has an :class:`~evox_tpu_torch.obs.SLOTracker`
    attached), ``"exit"`` when active and every armed signal has calmed
    (pressure at/below ``exit``, burn at/below ``burn_exit``), else
    ``"hold"``.  Evidence without the burn keys (pre-SLO journals)
    reproduces the original pressure-only hysteresis bit-for-bit."""
    pressure = _num(evidence, "pressure")
    enter = _num(evidence, "enter")
    exit_ = _num(evidence, "exit")
    burn = _num(evidence, "burn_rate")
    burn_enter = _num(evidence, "burn_enter")
    burn_exit = _num(evidence, "burn_exit")
    active = bool(evidence.get("active"))
    if pressure is None and burn is None:
        return "hold"
    over_pressure = (
        pressure is not None and enter is not None and pressure >= enter
    )
    over_burn = (
        burn is not None and burn_enter is not None and burn >= burn_enter
    )
    if not active and (over_pressure or over_burn):
        return "enter"
    if active and (exit_ is not None or burn_exit is not None):
        pressure_calm = (
            exit_ is None or pressure is None or pressure <= exit_
        )
        burn_calm = burn_exit is None or burn is None or burn <= burn_exit
        if pressure_calm and burn_calm:
            return "exit"
    return "hold"


def decide_shed(evidence: Mapping[str, Any]) -> int:
    """Effective queue budget for one admission class: the configured
    ``queue_budget``, tightened so a tenant admitted at the back of the
    queue still lands within ``slo_wait_seconds`` at the measured
    ``segment_seconds`` cadence (``lanes`` tenants drain per segment
    wave); tightened again — halved — while the class's SLO error budget
    is exhausted (``budget_remaining <= 0`` in the evidence: admitting
    at full rate while the objective is already violated digs the hole
    deeper).  Unknown timing / absent SLO evidence leaves each term
    untouched, so pre-SLO journals replay bit-for-bit."""
    budget = int(_num(evidence, "queue_budget") or 0)
    slo = _num(evidence, "slo_wait_seconds")
    seconds = _num(evidence, "segment_seconds")
    lanes = max(int(_num(evidence, "lanes") or 1), 1)
    effective = budget
    if slo and seconds and seconds > 0.0:
        effective = min(budget, max(1, int(slo / seconds) * lanes))
    remaining = _num(evidence, "budget_remaining")
    if remaining is not None and remaining <= 0.0:
        effective = max(1, effective // 2)
    return effective


def decide_tenant(evidence: Mapping[str, Any]) -> str:
    """Graduated degradation action for a tenant whose trend verdict
    tripped: ``"evict"`` on a quarantine-storm prediction when the
    operator opted in (``evict_on_storm`` — park the tenant on its
    checkpoint instead of burning restarts replaying a poisoned
    window), else ``"restart"`` while the restart budget lasts, else
    ``"quarantine"`` (freeze the lane)."""
    verdict = str(evidence.get("verdict") or "")
    if "storm" in verdict.split("+") and bool(evidence.get("evict_on_storm")):
        return "evict"
    used = int(_num(evidence, "restarts_used") or 0)
    budget = int(_num(evidence, "max_restarts") or 0)
    return "restart" if used < budget else "quarantine"


def decide_hpo_grow(evidence: Mapping[str, Any]) -> str:
    """Elastic inner-population growth for a meta-optimization ladder
    (``evox_tpu_torch.hpo``): ``"hold"``, or the target inner population as a
    decimal string.  Grows when the triggering candidate's *inner*
    best-fitness slope projects less than ``stagnation_tol`` total
    improvement over the windowed span (minimizing frame — the
    ``decide_trend`` stagnation form, applied to the inner series), the
    span has reached ``stagnation_window`` inner generations, and the
    ladder has headroom (``inner_pop * growth_factor``, capped at
    ``max_inner_pop``, still exceeds the current population).  Missing
    signals hold — growth is advisory, never load-bearing."""
    tol = _num(evidence, "stagnation_tol")
    min_span = _num(evidence, "stagnation_window")
    slope = _num(evidence, "best_slope")
    span = _num(evidence, "span") or 0.0
    if (
        tol is None
        or min_span is None
        or min_span <= 0
        or slope is None
        or span < min_span
        or (-slope) * span > tol
    ):
        return "hold"
    pop = int(_num(evidence, "inner_pop") or 0)
    if pop < 1:
        return "hold"
    factor = _num(evidence, "growth_factor") or 2.0
    new_pop = max(int(round(pop * factor)), pop + 1)
    cap = _num(evidence, "max_inner_pop")
    if cap is not None:
        new_pop = min(new_pop, int(cap))
    if new_pop <= pop:
        return "hold"
    return str(new_pop)


def decide_autoscale(evidence: Mapping[str, Any]) -> str:
    """Fleet-size policy for a :class:`evox_tpu.service.TenantRouter`:
    ``"grow"`` / ``"drain:<i>"`` / ``"retire:<i>"`` / ``"hold"``.

    Pressure wins: sustained shedding (``shed_rounds`` consecutive
    shedding rounds at/over ``shed_sustain``) or SLO burn (``burn_rate``
    at/over ``burn_enter``) requests growth while ``members`` is under
    ``max_members`` (``None`` = unbounded).  Without pressure the fleet
    shrinks drain-first: a fully-drained draining member (its index in
    ``drained_member``) retires; otherwise, when nothing is queued and
    the non-draining count exceeds ``min_members``, the idlest member
    (``idle_member`` — zero live tenants) starts draining.  Missing or
    ``None`` signals hold — scaling is advisory, never load-bearing."""
    members = int(_num(evidence, "members") or 0)
    if members < 1:
        return "hold"
    shed_sustain = _num(evidence, "shed_sustain")
    shed_rounds = _num(evidence, "shed_rounds") or 0.0
    burn_enter = _num(evidence, "burn_enter")
    burn = _num(evidence, "burn_rate")
    pressured = (
        shed_sustain is not None
        and shed_sustain > 0
        and shed_rounds >= shed_sustain
    ) or (burn_enter is not None and burn is not None and burn >= burn_enter)
    if pressured:
        cap = _num(evidence, "max_members")
        if cap is None or members < cap:
            return "grow"
        return "hold"
    drained = evidence.get("drained_member")
    if drained is not None:
        return f"retire:{int(drained)}"
    idle = evidence.get("idle_member")
    draining = int(_num(evidence, "draining") or 0)
    min_members = int(_num(evidence, "min_members") or 1)
    queued = int(_num(evidence, "queued") or 0)
    if idle is not None and queued == 0 and (members - draining) > min_members:
        return f"drain:{int(idle)}"
    return "hold"


def decide_compact(evidence: Mapping[str, Any]) -> str:
    """Journal-compaction policy for a daemon or router journal:
    ``"compact"`` / ``"hold"``.

    Compaction pays a boundary-time stall (full replay + snapshot +
    atomic swap), so it fires only when the journal has provably
    outgrown the live state.  The suffix since the last snapshot
    (``journal_records``) must exceed the live-tenant count
    (``live_tenants`` — folding fewer records than live entries cannot
    shrink the journal), and then any armed bound may trip: the record
    threshold (``compact_records``), the byte threshold
    (``compact_bytes`` against ``journal_bytes``), or the recovery-time
    SLO (last measured ``replay_seconds`` at/over
    ``max_replay_seconds``).  Missing or unarmed signals hold —
    compaction is advisory, the append-only journal is always a correct
    fallback."""
    records = _num(evidence, "journal_records")
    if records is None or records <= 0:
        return "hold"
    live = _num(evidence, "live_tenants") or 0.0
    if records <= live:
        return "hold"
    max_replay = _num(evidence, "max_replay_seconds")
    replay = _num(evidence, "replay_seconds")
    if (
        max_replay is not None
        and max_replay > 0
        and replay is not None
        and replay >= max_replay
    ):
        return "compact"
    rec_cap = _num(evidence, "compact_records")
    if rec_cap is not None and rec_cap > 0 and records >= rec_cap:
        return "compact"
    byte_cap = _num(evidence, "compact_bytes")
    jbytes = _num(evidence, "journal_bytes")
    if (
        byte_cap is not None
        and byte_cap > 0
        and jbytes is not None
        and jbytes >= byte_cap
    ):
        return "compact"
    return "hold"


_DECIDERS: dict[str, Callable[[Mapping[str, Any]], Any]] = {
    "autoscale": decide_autoscale,
    "compact": decide_compact,
    "trend": lambda e: decide_trend(e) or "",
    "cadence": lambda e: str(decide_cadence(e)),
    "brownout": decide_brownout,
    "shed-threshold": lambda e: str(decide_shed(e)),
    "tenant": decide_tenant,
    "hpo-grow": decide_hpo_grow,
    "degrade": lambda e: "threshold-probes",
}


def decide(kind: str, evidence: Mapping[str, Any]) -> str:
    """Dispatch one journaled decision kind to its pure decider — the
    single entry point :meth:`Controller.replay_decisions` recomputes
    actions through."""
    decider = _DECIDERS.get(kind)
    if decider is None:
        raise ValueError(f"unknown decision kind {kind!r}")
    return str(decider(evidence))


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class Controller:
    """Trend-driven, journaled control plane for runner / service / daemon.

    Usage (solo runner)::

        controller = Controller(stagnation_window=16,
                                diversity_floor=1e-8,
                                journal=RequestJournal("run/journal.jsonl"))
        runner = ResilientRunner(wf, "run", health=HealthProbe(),
                                 restart=RollbackToCheckpoint(),
                                 controller=controller)
        runner.run(state, 500)
        controller.decisions     # every decision, with evidence
        # fresh process: Controller.replay_decisions(journal.replay()[0])
        # reproduces the same (kind, action) sequence bit-for-bit.

    Every policy is opt-in: a default ``Controller()`` has no detector
    armed, fires no decision, and leaves the supervised run bit-identical
    to a controller-less one.  All consult methods are exception-guarded
    — the first failure of a plane latches it off with one ``degrade``
    decision and a structured warning, and the consumer's existing
    threshold probes remain in force (the run never crashes on the
    controller's account).

    :param journal: optional
        :class:`~evox_tpu_torch.service.RequestJournal` every decision is
        appended to (kind ``"decision"``) — *advisory* appends: a failed
        append warns and the decision still applies (refusing admission
        is the journal's job; second-guessing a running segment is not).
        The daemon wires its own journal in automatically.
    :param stagnation_window: generations of flight-window span required
        before the stagnation detector may fire; ``0`` (default)
        disables it.
    :param stagnation_tol: minimum projected best-fitness improvement
        (minimizing frame) across the window that counts as progress.
    :param diversity_floor: arm the collapse-trajectory detector — fires
        when the diversity EMA, extrapolated ``collapse_horizon``
        generations along its (negative) slope, falls under this floor;
        ``None`` disables.
    :param collapse_horizon: lookahead generations for the collapse
        extrapolation.
    :param storm_rate: arm the quarantine-storm predictor — fires when
        the cumulative ``num_nonfinite`` counter grows at this many
        individuals per generation or faster; ``None`` disables.
    :param trend_window: how many newest flight rows feed the trend
        estimators (``None`` = the whole ring).
    :param target_seconds: arm self-tuning cadence — size the next
        segment's scan toward this execution wall per segment (the
        measured-ratio generalization of ``checkpoint_wall_interval``).
    :param overhead_cap: cadence may additionally grow the scan while
        per-boundary overhead (capture + checkpoint block) exceeds this
        fraction of segment wall; ``None`` disables the overhead term.
    :param evict_on_storm: graduated degradation — a service tenant
        whose trend verdict includes ``storm`` is *evicted* (parked on
        its checkpoint) instead of burning restarts.
    :param brownout_enter: override the consumer's brown-out entry
        pressure (``None`` = use the daemon's configured threshold).
    :param brownout_exit: override the exit pressure (``None`` = half
        the entry threshold, the daemon's historical hysteresis).
    :param slo_wait_seconds: arm SLO-aware shed thresholds — admission
        class budgets are tightened so queued tenants land within this
        many seconds at the live measured segment cadence.
    :param slo: optional :class:`~evox_tpu_torch.obs.SLOTracker` — the
        formalized objectives behind degradation decisions.  When
        attached, the worst matching burn rate / budget remaining rides
        the journaled evidence: brown-out entry additionally triggers on
        ``burn_rate >= brownout_burn`` (exit requires burn back under
        half of it), and a class whose error budget is exhausted
        (``budget_remaining <= 0``) has its shed threshold halved.  The
        daemon wires its own tracker in automatically (first binder
        wins); a failed tracker consult degrades the owning plane like
        any other controller failure.
    :param brownout_burn: SLO burn-rate threshold for brown-out entry
        (e.g. ``2.0`` = budget burning at twice the sustainable rate);
        ``None`` disables the burn trigger even with a tracker attached.
    :param grace: generations a trend verdict stays quiet after firing
        (per tenant), so the rolled-back window cannot instantly re-trip
        the same detector; defaults to the largest armed window.
    """

    def __init__(
        self,
        *,
        journal: Any | None = None,
        stagnation_window: int = 0,
        stagnation_tol: float = 0.0,
        diversity_floor: float | None = None,
        collapse_horizon: int = 8,
        storm_rate: float | None = None,
        trend_window: int | None = None,
        target_seconds: float | None = None,
        overhead_cap: float | None = None,
        evict_on_storm: bool = False,
        brownout_enter: float | None = None,
        brownout_exit: float | None = None,
        slo_wait_seconds: float | None = None,
        slo: Any | None = None,
        brownout_burn: float | None = None,
        grace: int | None = None,
    ):
        if stagnation_window < 0:
            raise ValueError(
                f"stagnation_window must be >= 0, got {stagnation_window}"
            )
        if collapse_horizon < 0:
            raise ValueError(
                f"collapse_horizon must be >= 0, got {collapse_horizon}"
            )
        if storm_rate is not None and storm_rate <= 0:
            raise ValueError(f"storm_rate must be > 0, got {storm_rate}")
        if target_seconds is not None and target_seconds <= 0:
            raise ValueError(
                f"target_seconds must be > 0, got {target_seconds}"
            )
        if overhead_cap is not None and not (0.0 < overhead_cap < 1.0):
            raise ValueError(
                f"overhead_cap must be in (0, 1), got {overhead_cap}"
            )
        if slo_wait_seconds is not None and slo_wait_seconds <= 0:
            raise ValueError(
                f"slo_wait_seconds must be > 0, got {slo_wait_seconds}"
            )
        if brownout_burn is not None and brownout_burn <= 0:
            raise ValueError(
                f"brownout_burn must be > 0, got {brownout_burn}"
            )
        self.journal = journal
        self.stagnation_window = int(stagnation_window)
        self.stagnation_tol = float(stagnation_tol)
        self.diversity_floor = (
            None if diversity_floor is None else float(diversity_floor)
        )
        self.collapse_horizon = int(collapse_horizon)
        self.storm_rate = None if storm_rate is None else float(storm_rate)
        self.trend_window = trend_window
        self.target_seconds = (
            None if target_seconds is None else float(target_seconds)
        )
        self.overhead_cap = (
            None if overhead_cap is None else float(overhead_cap)
        )
        self.evict_on_storm = bool(evict_on_storm)
        self.brownout_enter = (
            None if brownout_enter is None else float(brownout_enter)
        )
        self.brownout_exit = (
            None if brownout_exit is None else float(brownout_exit)
        )
        self.slo_wait_seconds = (
            None if slo_wait_seconds is None else float(slo_wait_seconds)
        )
        self.slo = slo
        self.brownout_burn = (
            None if brownout_burn is None else float(brownout_burn)
        )
        if grace is None:
            grace = max(
                self.stagnation_window, self.collapse_horizon, 4
            )
        self.grace = int(grace)
        self.decisions: list[Decision] = []
        self.failures: list[str] = []
        self.journal_append_failures = 0
        self._seq = 0
        self._obs: Any | None = None
        self._degraded: set[str] = set()
        self._quiet_until: dict[str, int] = {}
        self._shed_cache: dict[str, int] = {}
        self._journal_warned = False

    # -- wiring --------------------------------------------------------------
    def bind(self, obs: Any | None) -> None:
        """Attach the consumer's :class:`~evox_tpu_torch.obs.Observability`
        plane (first binder wins): decisions publish ``control`` events
        and ``evox_control_*`` metrics through it.  ``None`` is a no-op
        — the controller then warns through ``warnings.warn`` only."""
        if self._obs is None and obs is not None:
            self._obs = obs

    @property
    def trend_enabled(self) -> bool:
        return (
            self.stagnation_window > 0
            or self.diversity_floor is not None
            or self.storm_rate is not None
        ) and "trend" not in self._degraded

    @property
    def cadence_enabled(self) -> bool:
        return (
            self.target_seconds is not None or self.overhead_cap is not None
        ) and "cadence" not in self._degraded

    @property
    def degraded(self) -> bool:
        """Whether any control plane has latched off after a failure
        (the run continues on the consumer's threshold probes)."""
        return bool(self._degraded)

    # -- internals -----------------------------------------------------------
    def _event(self, msg: str, *, warn: bool = False, **payload: Any) -> None:
        if self._obs is not None:
            self._obs.event(
                "control",
                msg,
                severity="warning" if warn else "info",
                **payload,
            )
        elif warn:
            warnings.warn(msg)

    def _emit(
        self,
        kind: str,
        action: str,
        *,
        generation: int,
        evidence: Mapping[str, Any],
        policy: str,
        tenant_id: str | None = None,
        warn: bool = False,
    ) -> Decision:
        """Record one decision: assign its sequence number, keep it,
        journal it (advisory), and publish the event + metric."""
        decision = Decision(
            seq=self._seq,
            kind=kind,
            generation=int(generation),
            action=str(action),
            policy=policy,
            evidence=dict(evidence),
            tenant_id=tenant_id,
        )
        self._seq += 1
        self.decisions.append(decision)
        if self.journal is not None:
            try:
                # Nested under "decision": the manifest's own "kind"
                # (the decision family) must not collide with the journal
                # record's kind field.
                self.journal.append("decision", decision=decision.to_manifest())
            except Exception as e:  # noqa: BLE001 - advisory by contract
                self.journal_append_failures += 1
                if not self._journal_warned:
                    self._journal_warned = True
                    self._event(
                        f"decision journal append failed "
                        f"({type(e).__name__}: {e}); decisions continue "
                        f"in-memory only",
                        warn=True,
                    )
        if self._obs is not None:
            self._obs.counter(
                "evox_control_decisions_total",
                "Control-plane decisions taken, by kind.",
                kind=kind,
            ).inc()
        self._event(
            f"decision #{decision.seq} {kind}: {action}"
            + (f" (tenant {tenant_id})" if tenant_id else "")
            + f" at generation {decision.generation}",
            warn=warn,
            kind=kind,
            action=action,
            seq=decision.seq,
            generation=decision.generation,
            tenant_id=tenant_id,
        )
        return decision

    def note_failure(
        self, plane: str, why: str, *, generation: int = 0
    ) -> None:
        """A control plane failed (missing signals, detached recorder,
        broken math): latch it off, emit ONE ``degrade`` decision and
        one structured warning, and let the consumer's threshold probes
        carry on.  Later failures of the same plane count silently."""
        self.failures.append(f"{plane}: {why}")
        if plane in self._degraded:
            return
        self._degraded.add(plane)
        self._emit(
            "degrade",
            "threshold-probes",
            generation=generation,
            evidence={"plane": plane, "reason": why},
            policy="degrade",
        )
        self._event(
            f"control plane {plane!r} degraded to threshold probes: {why}",
            warn=True,
            plane=plane,
            reason=why,
        )
        if self._obs is not None:
            self._obs.gauge(
                "evox_control_degraded",
                "Whether any control plane has latched off (threshold "
                "probes only).",
            ).set(1.0)

    def _guard(
        self,
        plane: str,
        fn: Callable[[], Any],
        *,
        generation: int = 0,
        default: Any = None,
    ) -> Any:
        if plane in self._degraded:
            return default
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - must never crash a run
            self.note_failure(
                plane, f"{type(e).__name__}: {e}", generation=generation
            )
            return default

    # -- trend verdicts ------------------------------------------------------
    def trend_verdict(
        self,
        rows: Sequence[Mapping[str, Any]] | None,
        *,
        generation: int,
        tenant_id: str | None = None,
    ) -> Decision | None:
        """Render a trend verdict from one flight window (newest rows of
        the recorder's ring, or a bundle's rows).  Returns the journaled
        :class:`~evox_tpu_torch.control.Decision` when a detector trips,
        ``None`` otherwise.  Never raises: ``rows=None`` (a detached
        flight recorder) and internal failures degrade the trend plane
        to the consumer's threshold probes with a structured warning."""
        if not self.trend_enabled:
            return None
        if rows is None:
            self.note_failure(
                "trend",
                "flight recorder detached or unavailable",
                generation=generation,
            )
            return None
        key = tenant_id if tenant_id is not None else "__run__"
        if generation <= self._quiet_until.get(key, -1):
            return None
        return self._guard(
            "trend",
            lambda: self._trend_verdict(rows, generation, tenant_id, key),
            generation=generation,
        )

    def _trend_verdict(
        self,
        rows: Sequence[Mapping[str, Any]],
        generation: int,
        tenant_id: str | None,
        key: str,
    ) -> Decision | None:
        from ..obs.flight import window_ema, window_slope

        rows = list(rows)
        window = self.trend_window
        sample = rows[-window:] if window else rows
        gens = [float(r["generation"]) for r in sample if "generation" in r]
        span = (max(gens) - min(gens)) if len(gens) >= 2 else 0.0
        evidence: dict[str, Any] = {
            "rows": len(sample),
            "span": float(span),
            "best_slope": window_slope(sample, "best_fitness"),
            "stagnation_window": (
                float(self.stagnation_window) if self.stagnation_window else None
            ),
            "stagnation_tol": (
                float(self.stagnation_tol) if self.stagnation_window else None
            ),
            "diversity_ema": window_ema(sample, "pop_diversity"),
            "diversity_slope": window_slope(sample, "pop_diversity"),
            "diversity_floor": self.diversity_floor,
            "collapse_horizon": float(self.collapse_horizon),
            "nonfinite_slope": window_slope(sample, "num_nonfinite"),
            "storm_rate": self.storm_rate,
        }
        action = decide_trend(evidence)
        if action is None:
            return None
        self._quiet_until[key] = int(generation) + self.grace
        return self._emit(
            "trend",
            action,
            generation=generation,
            evidence=evidence,
            policy="trend",
            tenant_id=tenant_id,
            warn=True,
        )

    # -- self-tuning cadence -------------------------------------------------
    def next_chunk(
        self,
        timings: Iterable[Any],
        *,
        checkpoint_every: int,
        generation: int,
        current: int,
    ) -> int | None:
        """The next segment's scan length from measured
        :class:`~evox_tpu_torch.resilience.SegmentTiming` records — ``None``
        while cadence is disabled or no usable timing exists yet (the
        consumer keeps its configured cadence).  A changed chunk is one
        journaled ``cadence`` decision.  Never raises."""
        if not self.cadence_enabled:
            return None
        return self._guard(
            "cadence",
            lambda: self._next_chunk(
                timings, checkpoint_every, generation, current
            ),
            generation=generation,
        )

    def _next_chunk(
        self,
        timings: Iterable[Any],
        checkpoint_every: int,
        generation: int,
        current: int,
    ) -> int | None:
        per_gen, boundary = self._cadence_ema(timings)
        if per_gen is None:
            return None
        evidence = {
            "per_gen_seconds": per_gen,
            "boundary_seconds": boundary,
            "target_seconds": self.target_seconds,
            "overhead_cap": self.overhead_cap,
            "checkpoint_every": int(checkpoint_every),
        }
        chunk = decide_cadence(evidence)
        if chunk != int(current):
            self._emit(
                "cadence",
                str(chunk),
                generation=generation,
                evidence=evidence,
                policy="cadence",
            )
        return chunk

    @staticmethod
    def _cadence_ema(
        timings: Iterable[Any], window: int = 8, alpha: float = 0.5
    ) -> tuple[float | None, float]:
        """EMA of (execution seconds per generation, boundary-overhead
        seconds) over the newest ``window`` segments.  Per-segment
        generation counts come from successive ``generation`` diffs;
        rollback segments (negative diff) are skipped."""
        usable: list[tuple[float, float]] = []
        last_gen = 0
        for t in timings:
            gens = int(t.generation) - last_gen
            last_gen = int(t.generation)
            if gens <= 0 or t.execute_seconds <= 0:
                continue
            usable.append(
                (
                    float(t.execute_seconds) / gens,
                    float(t.compile_seconds)
                    + float(t.checkpoint_block_seconds),
                )
            )
        usable = usable[-window:]
        if not usable:
            return None, 0.0
        per_gen, boundary = usable[0]
        for p, b in usable[1:]:
            per_gen = (1.0 - alpha) * per_gen + alpha * p
            boundary = (1.0 - alpha) * boundary + alpha * b
        return per_gen, boundary

    # -- graduated degradation ----------------------------------------------
    def tenant_action(
        self,
        trend: Decision,
        *,
        restarts_used: int,
        max_restarts: int,
        generation: int,
        tenant_id: str | None = None,
    ) -> Decision | None:
        """Map a tenant's trend verdict onto the degradation ladder
        (``restart`` → ``quarantine`` → ``evict``) as one journaled
        ``tenant`` decision.  Never raises."""
        return self._guard(
            "tenant",
            lambda: self._emit(
                "tenant",
                decide_tenant(
                    {
                        "verdict": trend.action,
                        "restarts_used": int(restarts_used),
                        "max_restarts": int(max_restarts),
                        "evict_on_storm": self.evict_on_storm,
                    }
                ),
                generation=generation,
                evidence={
                    "verdict": trend.action,
                    "restarts_used": int(restarts_used),
                    "max_restarts": int(max_restarts),
                    "evict_on_storm": self.evict_on_storm,
                },
                policy="tenant",
                tenant_id=tenant_id,
                warn=True,
            ),
            generation=generation,
        )

    def hpo_grow(
        self,
        *,
        evidence: Mapping[str, Any],
        generation: int,
        tenant_id: str | None = None,
    ):
        """Consult the elastic inner-population ladder
        (:mod:`evox_tpu_torch.hpo`) with one grow-evidence dict (built by
        :func:`evox_tpu_torch.hpo.grow_evidence` — the triggering candidate's
        windowed inner best-fitness slope plus the ladder thresholds in
        force).  Returns the journaled ``hpo-grow``
        :class:`~evox_tpu_torch.control.Decision` when
        :func:`decide_hpo_grow` says grow, ``None`` on hold.  Fired
        growths observe the same per-key quiet window as trend verdicts
        (the regrown ladder's fresh series must not instantly re-trip).
        Never raises — failures degrade the ``hpo-grow`` plane to "no
        growth" with one structured warning, and the meta-run continues
        on its threshold probes."""

        def act():
            key = f"hpo-grow:{tenant_id or '__run__'}"
            if generation <= self._quiet_until.get(key, -1):
                return None
            action = decide_hpo_grow(evidence)
            if action == "hold":
                return None
            self._quiet_until[key] = int(generation) + self.grace
            return self._emit(
                "hpo-grow",
                action,
                generation=generation,
                evidence=evidence,
                policy="hpo-grow",
                tenant_id=tenant_id,
                warn=True,
            )

        return self._guard("hpo-grow", act, generation=generation)

    def autoscale(
        self,
        *,
        evidence: Mapping[str, Any],
        generation: int = 0,
    ) -> str:
        """Consult the fleet-size policy with one router-built evidence
        dict (live/draining member counts, sustained-shed rounds, worst
        SLO burn, queue depth, idle/drained member indexes).  Returns
        :func:`decide_autoscale`'s action — ``"grow"`` /
        ``"drain:<i>"`` / ``"retire:<i>"`` / ``"hold"`` — with every
        non-hold action journaled as an ``autoscale``
        :class:`~evox_tpu_torch.control.Decision` (replayable bit-for-bit)
        under the shared per-key quiet window, so a grown or drained
        fleet gets ``grace`` rounds to settle before the next scaling
        verdict.  Never raises — failures degrade the ``autoscale``
        plane to ``"hold"`` with one structured warning and the fleet
        keeps its current size."""

        def act() -> str:
            key = "autoscale"
            if generation <= self._quiet_until.get(key, -1):
                return "hold"
            action = decide_autoscale(evidence)
            if action == "hold":
                return "hold"
            self._quiet_until[key] = int(generation) + self.grace
            self._emit(
                "autoscale",
                action,
                generation=generation,
                evidence=evidence,
                policy="autoscale",
                warn=action == "grow",
            )
            return action

        return self._guard(
            "autoscale", act, generation=generation, default="hold"
        )

    def compact(
        self,
        *,
        evidence: Mapping[str, Any],
        generation: int = 0,
    ) -> str:
        """Consult the journal-compaction policy with one evidence dict
        (journal bytes, records since snapshot, live-tenant count, last
        measured replay seconds, armed thresholds).  Returns
        :func:`decide_compact`'s action — ``"compact"`` / ``"hold"`` —
        with every non-hold action journaled as a ``compact``
        :class:`~evox_tpu_torch.control.Decision` (replayable bit-for-bit)
        under the shared per-key quiet window, so a freshly-compacted
        journal gets ``grace`` boundaries to accumulate before the next
        verdict.  Never raises — failures degrade the ``compact`` plane
        to ``"hold"`` and serving continues on the uncompacted
        journal."""

        def act() -> str:
            key = "compact"
            if generation <= self._quiet_until.get(key, -1):
                return "hold"
            action = decide_compact(evidence)
            if action == "hold":
                return "hold"
            self._quiet_until[key] = int(generation) + self.grace
            self._emit(
                "compact",
                action,
                generation=generation,
                evidence=evidence,
                policy="compact",
                warn=False,
            )
            return action

        return self._guard(
            "compact", act, generation=generation, default="hold"
        )

    def brownout(
        self,
        *,
        pressure: float,
        active: bool,
        enter: float | None = None,
        exit: float | None = None,
        generation: int = 0,
    ) -> str:
        """Brown-out hysteresis: ``"enter"``/``"exit"``/``"hold"``.
        The controller's own ``brownout_enter``/``brownout_exit``
        override the consumer's thresholds when set; exit defaults to
        half of enter (the daemon's historical hysteresis).  Transitions
        are journaled ``brownout`` decisions; ``hold`` is silent.  Never
        raises (failures degrade to ``"hold"``)."""
        enter = self.brownout_enter if self.brownout_enter is not None else enter
        exit_ = self.brownout_exit if self.brownout_exit is not None else exit
        if exit_ is None and enter is not None:
            exit_ = enter / 2.0
        evidence = {
            "pressure": float(pressure),
            "enter": None if enter is None else float(enter),
            "exit": None if exit_ is None else float(exit_),
            "active": bool(active),
        }

        def act() -> str:
            if self.slo is not None and self.brownout_burn is not None:
                # Formalized-objective trigger: the worst burn rate rides
                # the journaled evidence (the decide stays pure over it;
                # exit hysteresis at half the entry burn, matching the
                # pressure convention).
                worst = self.slo.worst()
                evidence["burn_rate"] = (
                    None if worst is None else worst.burn_rate
                )
                evidence["burn_enter"] = self.brownout_burn
                evidence["burn_exit"] = self.brownout_burn / 2.0
                evidence["slo"] = None if worst is None else worst.slo.name
            action = decide_brownout(evidence)
            if action != "hold":
                self._emit(
                    "brownout",
                    action,
                    generation=generation,
                    evidence=evidence,
                    policy="brownout",
                    warn=action == "enter",
                )
            return action

        return self._guard(
            "brownout", act, generation=generation, default="hold"
        )

    def shed_threshold(
        self,
        *,
        queue_budget: int,
        segment_seconds: float | None,
        lanes: int,
        tenant_class: str = "standard",
        generation: int = 0,
    ) -> int:
        """SLO-aware effective queue budget for one admission class,
        recomputed from the live segment cadence.  A changed budget is
        one journaled ``shed-threshold`` decision per class.  Never
        raises (failures return the configured budget)."""
        evidence = {
            "queue_budget": int(queue_budget),
            "slo_wait_seconds": self.slo_wait_seconds,
            "segment_seconds": (
                None if segment_seconds is None else float(segment_seconds)
            ),
            "lanes": int(lanes),
            "tenant_class": str(tenant_class),
        }

        def act() -> int:
            if self.slo is not None:
                # The class's worst error-budget standing rides the
                # evidence: an exhausted budget halves the shed
                # threshold (decide_shed stays pure over it).
                worst = self.slo.worst(tenant_class=tenant_class)
                evidence["budget_remaining"] = (
                    None if worst is None else worst.budget_remaining
                )
                evidence["slo"] = None if worst is None else worst.slo.name
            budget = decide_shed(evidence)
            if self._shed_cache.get(tenant_class) != budget:
                self._shed_cache[tenant_class] = budget
                self._emit(
                    "shed-threshold",
                    str(budget),
                    generation=generation,
                    evidence=evidence,
                    policy="shed",
                )
            return budget

        return self._guard(
            "shed", act, generation=generation, default=int(queue_budget)
        )

    # -- replay --------------------------------------------------------------
    @staticmethod
    def replay_decisions(records: Iterable[Any]) -> list[Decision]:
        """Recompute every journaled ``decision`` record's action from
        its journaled evidence through the pure deciders.  ``records``
        accepts :class:`~evox_tpu_torch.service.JournalRecord` instances or
        raw ``{"kind", "data"}`` dicts (a replayed journal, or rows read
        straight off ``journal.jsonl``).  Comparing the result against
        the journaled decisions verifies bit-for-bit reproducibility —
        a mismatch means the telemetry did not determine the decision,
        which is exactly the defect this contract exists to catch."""
        import dataclasses

        out: list[Decision] = []
        for rec in records:
            kind = getattr(rec, "kind", None)
            data = getattr(rec, "data", None)
            if kind is None and isinstance(rec, Mapping):
                kind = rec.get("kind")
                data = rec.get("data")
            if kind != "decision" or not isinstance(data, Mapping):
                continue
            payload = data.get("decision", data)
            if not isinstance(payload, Mapping):
                continue
            journaled = Decision.from_manifest(payload)
            out.append(
                dataclasses.replace(
                    journaled, action=decide(journaled.kind, journaled.evidence)
                )
            )
        return out
