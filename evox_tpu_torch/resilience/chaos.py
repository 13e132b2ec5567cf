"""Chaos conductor: deterministic whole-stack fault orchestration
(counterpart of ``evox_tpu/resilience/chaos.py``: the same plan DSL,
digests, validation messages, canonical event journal, audits, report
and statusz section; the fleet it drives is the port's).

Every fault plane this repo grew — process SIGKILL to members and the
router (:mod:`tests` model it as *abandonment*: drop the object with no
shutdown path, rebuild over the same root), :class:`.FaultyStore` disk
faults by save index, :class:`.FaultyTransport` wire faults by request
index, :class:`.FaultyProblem` lane faults by tenant, straggler and
partition windows — composes here into ONE seeded, JSON-serializable
timeline:

* :class:`ChaosPlan` — the scenario DSL.  A plan is plain data
  (``to_json`` / ``from_json`` round-trips; :meth:`ChaosPlan.digest` is
  the SHA-256 of its canonical JSON), audited at construction time by
  the same :func:`.validate_schedule` discipline every injector uses
  (negative rounds, out-of-range members, a member scheduled to be both
  SIGKILLed and partitioned in the same round — contradictory fates —
  all fail loudly before anything runs).  :meth:`ChaosPlan.from_seed`
  derives a whole scenario from one integer, deterministically.
* :class:`ChaosConductor` — runs a routed multi-member fleet through
  the plan round by round, journals every injected event into a
  canonical ``chaos_events.jsonl`` (no wall-clock inside the records:
  the same ``(seed, plan digest)`` reproduces the file **bit for
  bit**), and between rounds audits the
  :data:`~evox_tpu_torch.resilience.invariants.INVARIANTS` registry against a
  :func:`build_audit_context` snapshot of the live fleet.  Each
  violation is dumped as a structured postmortem evidence bundle
  through the :class:`~evox_tpu_torch.obs.FlightRecorder` path.
* :class:`ChaosReport` — the run's JSON-ready verdict: rounds, acks,
  completions, the injected-event journal digest, every violation, and
  the per-member SLO burn-rate report (``tools/soak_torch.py`` turns the same
  report into the scale-ladder artifact).

The conductor is a *test harness with a statusz face*: attach it and
the router/daemon ``/statusz`` grows a ``chaos`` section
(:meth:`ChaosConductor.statusz_payload`), and ``evoxtop`` renders the
soak strip from it.

**The device.**  Every member the conductor builds (and rebuilds after a
kill) runs its daemon on ``device``: the card unless the caller passes
another, as ``ServiceMember`` does; the CPU tests pass ``device="cpu"``.
The built-in workload's specs are built on the host: the router's member
link carries device-free spec blobs, and each member decodes them onto its
own device.  A killed member is abandoned, not shut down: the dropped
daemon keeps what Python keeps alive (its packs, captured graphs and their
memory pools) but is never stepped or replayed again, and the router beats
the rebuilt member synchronously each round, so nothing of the old one
reaches the fleet's liveness verdicts.
"""

from __future__ import annotations

import hashlib
import json
import random as _random
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping

from ..obs import FlightRecorder, default_slos
from ..service import (
    AdmissionError,
    RequestJournal,
    ServiceMember,
    TenantRouter,
    TenantSpec,
    TenantStatus,
)
from ..utils import ExecutableCache
from ..utils.checkpoint import atomic_write_text
from .faults import FaultyProblem, FaultyStore
from .schedule import validate_schedule
from .invariants import (
    AuditContext,
    InvariantViolation,
    audit_invariants,
)
from .transport import FaultyTransport

__all__ = [
    "ChaosPlan",
    "ChaosConductor",
    "ChaosReport",
    "build_audit_context",
]

#: Plan ops and the fields each requires beyond ``round`` / ``op``.
_EVENT_FIELDS: dict[str, set[str]] = {
    "kill-member": {"member"},
    "kill-router": set(),
    "partition-member": {"member", "until"},
    "straggle-member": {"member", "until", "delay_seconds"},
}

_CANONICAL = {"sort_keys": True, "separators": (",", ":")}


def _canonical_json(payload: Any) -> str:
    return json.dumps(payload, **_CANONICAL)


@dataclass
class ChaosPlan:
    """One deterministic whole-stack fault scenario, as plain data.

    :param name: scenario label (rides the report and the statusz strip).
    :param seed: the scenario's identity; :meth:`from_seed` derives every
        schedule from it, and the conductor stamps it into the report so
        any failure reproduces from ``(seed, digest())`` alone.
    :param rounds: scheduling rounds the conductor drives (the drain
        phase afterwards runs fault-free until every tenant completes).
    :param members: fleet size (≥ 1).
    :param tenants: tenants submitted over the run.
    :param submit_rounds: per-tenant submission round, ``len == tenants``,
        each in ``[0, rounds)``.
    :param events: process/link timeline ops —
        ``{"round", "op": "kill-member", "member"}``,
        ``{"round", "op": "kill-router"}``,
        ``{"round", "op": "partition-member", "member", "until"}``
        (the member's link drops everything for rounds ``[round,
        until)``), ``{"round", "op": "straggle-member", "member",
        "until", "delay_seconds"}``.
    :param store_faults: :class:`.FaultyStore` kwargs per disk scope —
        key ``"router"`` (the router journal's store) or
        ``"member:<i>"`` (that member's whole store: journal appends
        and checkpoint publishes share the save-index schedule).
    :param wire_faults: :class:`.FaultyTransport` kwargs per member
        link, keyed by member index as a string (JSON keys are strings).
        A rebuilt link (member or router kill) restarts the request
        index at 0 and re-fires the schedule — deterministically.
    :param lane_faults: :class:`.FaultyProblem` per-lane fault spec per
        tenant index (string key); applied to that tenant's problem at
        submission, keyed by its pinned uid.
    :param n_steps: generation budget per tenant.
    :param lanes_per_pack: member pack width.
    :param segment_steps: member segment cadence.
    """

    name: str
    seed: int
    rounds: int
    members: int
    tenants: int
    submit_rounds: list[int] = field(default_factory=list)
    events: list[dict[str, Any]] = field(default_factory=list)
    store_faults: dict[str, dict[str, Any]] = field(default_factory=dict)
    wire_faults: dict[str, dict[str, Any]] = field(default_factory=dict)
    lane_faults: dict[str, dict[str, Any]] = field(default_factory=dict)
    n_steps: int = 8
    lanes_per_pack: int = 4
    segment_steps: int = 4

    def __post_init__(self) -> None:
        self.validate()

    # -- construction-time audit --------------------------------------------
    def validate(self) -> None:
        """The :func:`.validate_schedule` discipline, one level up: every
        contradiction a plan can encode fails here, never mid-run."""
        for name, value, floor in (
            ("members", self.members, 1),
            ("rounds", self.rounds, 1),
            ("tenants", self.tenants, 0),
            ("n_steps", self.n_steps, 1),
            ("lanes_per_pack", self.lanes_per_pack, 1),
            ("segment_steps", self.segment_steps, 1),
        ):
            if int(value) < floor:
                raise ValueError(
                    f"ChaosPlan.{name} must be >= {floor}, got {value}"
                )
        if len(self.submit_rounds) != self.tenants:
            raise ValueError(
                f"ChaosPlan.submit_rounds must schedule every tenant "
                f"exactly once ({self.tenants} tenants, "
                f"{len(self.submit_rounds)} rounds given)"
            )
        for t, r in enumerate(self.submit_rounds):
            if not (0 <= int(r) < self.rounds):
                raise ValueError(
                    f"ChaosPlan.submit_rounds[{t}] = {r} is outside "
                    f"[0, {self.rounds})"
                )
        kills: dict[int, set[int]] = {}
        partitions: dict[int, set[int]] = {}
        straggles: dict[int, set[int]] = {}
        for n, ev in enumerate(self.events):
            op = ev.get("op")
            if op not in _EVENT_FIELDS:
                raise ValueError(
                    f"ChaosPlan.events[{n}] has unknown op {op!r}; valid "
                    f"ops are {sorted(_EVENT_FIELDS)}"
                )
            required = {"round", "op"} | _EVENT_FIELDS[op]
            validate_schedule(
                f"ChaosPlan.events[{n}] ({op})",
                fields=ev,
                known=required,
            )
            missing = sorted(required - set(ev))
            if missing:
                raise ValueError(
                    f"ChaosPlan.events[{n}] ({op}) is missing field(s) "
                    f"{missing}"
                )
            r = int(ev["round"])
            if not (0 <= r < self.rounds):
                raise ValueError(
                    f"ChaosPlan.events[{n}] ({op}) fires at round {r}, "
                    f"outside [0, {self.rounds})"
                )
            if op == "kill-router":
                continue
            m = int(ev["member"])
            if not (0 <= m < self.members):
                raise ValueError(
                    f"ChaosPlan.events[{n}] ({op}) targets member {m}, "
                    f"outside [0, {self.members})"
                )
            if op == "kill-member":
                kills.setdefault(m, set()).add(r)
                continue
            until = int(ev["until"])
            if not (r < until <= self.rounds):
                raise ValueError(
                    f"ChaosPlan.events[{n}] ({op}) window [{r}, {until}) "
                    f"is empty or runs past round {self.rounds}"
                )
            window = set(range(r, until))
            if op == "partition-member":
                partitions.setdefault(m, set()).update(window)
            else:
                if float(ev["delay_seconds"]) < 0:
                    raise ValueError(
                        f"ChaosPlan.events[{n}] (straggle-member) "
                        f"delay_seconds must be >= 0, got "
                        f"{ev['delay_seconds']}"
                    )
                straggles.setdefault(m, set()).update(window)
        # Contradictory fates per member, the injector exclusivity rule
        # one level up: a SIGKILL cannot land over a partitioned link
        # (nothing reaches the process), and a link cannot both drop
        # everything and deliver late.
        for m in sorted(set(kills) | set(partitions) | set(straggles)):
            validate_schedule(
                f"ChaosPlan member {m}",
                indices={
                    "kill-member": sorted(kills.get(m, ())),
                    "partition-member": sorted(partitions.get(m, ())),
                    "straggle-member": sorted(straggles.get(m, ())),
                },
                exclusive=[
                    ("kill-member", "partition-member"),
                    ("partition-member", "straggle-member"),
                ],
            )
        for scope, kwargs in sorted(self.store_faults.items()):
            if scope != "router":
                prefix, _, index = scope.partition(":")
                if prefix != "member" or not index.isdigit() or not (
                    0 <= int(index) < self.members
                ):
                    raise ValueError(
                        f"ChaosPlan.store_faults scope {scope!r} is not "
                        f"'router' or 'member:<i>' with i in "
                        f"[0, {self.members})"
                    )
            FaultyStore(**kwargs)  # construction IS the audit
        for key, kwargs in sorted(self.wire_faults.items()):
            if not str(key).isdigit() or not (0 <= int(key) < self.members):
                raise ValueError(
                    f"ChaosPlan.wire_faults key {key!r} is not a member "
                    f"index in [0, {self.members})"
                )
            FaultyTransport(None, **kwargs)
        for key, spec in sorted(self.lane_faults.items()):
            if not str(key).isdigit() or not (0 <= int(key) < self.tenants):
                raise ValueError(
                    f"ChaosPlan.lane_faults key {key!r} is not a tenant "
                    f"index in [0, {self.tenants})"
                )
            validate_schedule(
                f"ChaosPlan.lane_faults[{key}]",
                fields=spec,
                known=set(FaultyProblem._LANE_FAULT_FIELDS),
            )

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_json(cls, payload: Mapping[str, Any]) -> "ChaosPlan":
        return cls(**dict(payload))

    def digest(self) -> str:
        """SHA-256 of the canonical (sorted-key, compact) plan JSON: the
        scenario's reproducibility handle."""
        return hashlib.sha256(
            _canonical_json(self.to_json()).encode("utf-8")
        ).hexdigest()

    # -- derivation ----------------------------------------------------------
    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        name: str | None = None,
        members: int = 3,
        tenants: int = 9,
        rounds: int = 8,
        kills: int = 2,
        wire: int = 2,
        disk: int = 2,
        lanes: int = 1,
        partitions: int = 1,
        n_steps: int = 8,
        lanes_per_pack: int = 4,
        segment_steps: int = 4,
    ) -> "ChaosPlan":
        """Derive a whole valid scenario from one integer.

        The generated mix leans on the *self-healing* fault flavors
        (ENOSPC/EIO heal on retry, dropped/torn/duplicated wire requests
        resolve through the journaled-placement retry path) so a seeded
        plan always leaves the fleet able to finish; the harsher flavors
        (torn journal appends, NaN lanes) stay available to hand-written
        plans."""
        rng = _random.Random(int(seed))
        submit_horizon = max(1, rounds // 2)
        submit_rounds = [rng.randrange(submit_horizon) for _ in range(tenants)]
        events: list[dict[str, Any]] = []
        killed_members: set[int] = set()
        kill_rounds = sorted(
            rng.sample(range(1, rounds), min(kills, rounds - 1))
        )
        for r in kill_rounds:
            target = rng.randrange(members + 1)
            if target == members:
                events.append({"round": r, "op": "kill-router"})
            else:
                events.append(
                    {"round": r, "op": "kill-member", "member": target}
                )
                killed_members.add(target)
        untouched = [m for m in range(members) if m not in killed_members]
        for _ in range(partitions):
            if not untouched or rounds < 3:
                break
            m = untouched.pop(rng.randrange(len(untouched)))
            start = rng.randrange(1, rounds - 1)
            until = min(rounds - 1, start + 1 + rng.randrange(2))
            if until <= start:
                until = start + 1
            events.append(
                {
                    "round": start,
                    "op": "partition-member",
                    "member": m,
                    "until": until,
                }
            )
        wire_faults: dict[str, dict[str, Any]] = {}
        for m in rng.sample(range(members), min(wire, members)):
            flavor = rng.choice(
                ("drop_replies", "duplicate_requests", "torn_replies",
                 "drop_requests")
            )
            wire_faults[str(m)] = {flavor: [rng.randrange(3)]}
        store_faults: dict[str, dict[str, Any]] = {}
        scopes = ["router"] + [f"member:{i}" for i in range(members)]
        for scope in rng.sample(scopes, min(disk, len(scopes))):
            flavor = rng.choice(("enospc_saves", "eio_saves"))
            # Low save indices land on journal appends (the first saves a
            # fresh store sees), the retry path the planes harden.
            store_faults[scope] = {flavor: [rng.randrange(2)]}
        lane_faults: dict[str, dict[str, Any]] = {}
        if tenants:
            for t in rng.sample(range(tenants), min(lanes, tenants)):
                lane_faults[str(t)] = {
                    "plateau_from": 1,
                    "plateau_until": 3,
                    "plateau_floor": 1.0,
                }
        return cls(
            name=name or f"seeded-{int(seed)}",
            seed=int(seed),
            rounds=rounds,
            members=members,
            tenants=tenants,
            submit_rounds=submit_rounds,
            events=events,
            store_faults=store_faults,
            wire_faults=wire_faults,
            lane_faults=lane_faults,
            n_steps=n_steps,
            lanes_per_pack=lanes_per_pack,
            segment_steps=segment_steps,
        )


@dataclass
class ChaosReport:
    """One chaos run's JSON-ready verdict."""

    plan_name: str
    plan_digest: str
    seed: int
    rounds_run: int
    tenants: int
    completed: int
    acks: int
    pending: int
    injected_events: int
    violations: list[dict[str, Any]]
    event_log: str
    event_log_sha256: str
    slo_burn_report: dict[str, Any]
    counters: dict[str, float]
    elapsed_seconds: float

    def to_json(self) -> dict[str, Any]:
        return asdict(self)


# -- fleet snapshot → audit context ------------------------------------------


def _read_journal(path: Any) -> tuple[list[dict[str, Any]], bool]:
    """Parse a request journal file read-only into plain ``{"kind",
    "data"}`` records, never mutating it (the owning plane's ``replay``
    handles quarantine); unparseable lines (a torn tail) are skipped.
    Returns ``(records, compacted)`` — compacted when a
    ``snapshot-anchor`` record is present."""
    records: list[dict[str, Any]] = []
    compacted = False
    p = Path(path)
    try:
        raw = p.read_bytes()
    except OSError:
        return records, compacted
    for line in raw.splitlines():
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        body = obj.get("body") or {}
        kind = body.get("kind")
        if kind == "snapshot-anchor":
            compacted = True
            continue
        records.append({"kind": kind, "data": dict(body.get("data") or {})})
    return records, compacted


def build_audit_context(
    router: TenantRouter,
    *,
    acks: Any = (),
    round: int = 0,
    forgotten: Any = (),
    counters: Mapping[str, float] | None = None,
    previous_counters: Mapping[str, float] | None = None,
) -> AuditContext:
    """Snapshot a live routed fleet into the plain
    :class:`~evox_tpu_torch.resilience.invariants.AuditContext` the invariant
    registry audits — journals parsed read-only from disk, placements
    and residency from the live objects.  Used by the conductor between
    rounds, by ``tools/soak_torch.py`` between churn waves, and directly by
    tests."""
    router_records, router_compacted = _read_journal(router.journal.path)
    compacted_scopes: set[str] = {"router"} if router_compacted else set()
    member_records: dict[int, list[dict[str, Any]]] = {}
    resident: dict[int, set[str]] = {}
    completed: set[str] = set()
    slo_reports: dict[str, list[dict[str, Any]]] = {}
    records_since: dict[str, int] = {}
    compact_records: dict[str, int | None] = {}
    live_members = {i for i in router.members if router._usable(i)}
    for i, member in sorted(router.members.items()):
        scope = f"member:{i}"
        recs, compacted = _read_journal(member.daemon.journal.path)
        member_records[i] = recs
        if compacted:
            compacted_scopes.add(scope)
        tenants_dir = Path(member.root) / "tenants"
        if tenants_dir.is_dir():
            resident[i] = {p.name for p in tenants_dir.iterdir() if p.is_dir()}
        else:
            resident[i] = set()
        for tid, record in member.daemon.service._tenants.items():
            if record.status is TenantStatus.COMPLETED:
                completed.add(str(tid))
        if member.daemon.slo is not None:
            slo_reports[scope] = member.daemon.slo.describe()
        records_since[scope] = int(
            getattr(member.daemon.journal, "records_since_snapshot", 0) or 0
        )
        compact_records[scope] = member.daemon.compact_records
    records_since["router"] = int(
        getattr(router.journal, "records_since_snapshot", 0) or 0
    )
    compact_records["router"] = router.compact_records
    placements = {
        str(tid): {"member": int(p["member"]), "uid": int(p["uid"])}
        for tid, p in router._placements.items()
    }
    base_counters: dict[str, float] = {
        "router.uid_next": float(router._uid_next),
    }
    # Journal record counts are monotone by append-only-ness — except
    # across a compaction, which folds them by design.
    if "router" not in compacted_scopes:
        base_counters["router.journal_records"] = float(len(router_records))
    for i, recs in member_records.items():
        if f"member:{i}" not in compacted_scopes:
            base_counters[f"member:{i}.journal_records"] = float(len(recs))
    if counters:
        base_counters.update({str(k): float(v) for k, v in counters.items()})
    return AuditContext(
        round=int(round),
        acks=list(acks),
        router_records=router_records,
        member_records=member_records,
        placements=placements,
        completed=completed,
        forgotten=set(forgotten),
        live_members=live_members,
        resident=resident,
        counters=base_counters,
        previous_counters=dict(previous_counters or {}),
        slo_reports=slo_reports,
        records_since_snapshot=records_since,
        compact_records=compact_records,
        compacted_scopes=compacted_scopes,
    )


# -- link wrappers -----------------------------------------------------------


class _PartitionedLink:
    """A member link inside a partition window: nothing is delivered,
    nothing comes back (the router's ``member-link`` refusal path)."""

    def __init__(self, member_index: int):
        self.member_index = int(member_index)
        self.events: list[tuple[int, str]] = []
        self._n = 0

    def request(
        self, method: str, path: str, headers: dict, body: bytes
    ) -> tuple[int, dict, bytes]:
        index = self._n
        self._n += 1
        self.events.append((index, "partition-drop"))
        raise ConnectionError(
            f"injected: member {self.member_index} link partitioned"
        )


class _StragglerLink:
    """A member link inside a straggle window: everything is delivered,
    late."""

    def __init__(self, inner: Any, seconds: float):
        self.inner = inner
        self.seconds = float(seconds)
        self.events: list[tuple[int, str]] = []
        self._n = 0

    def request(
        self, method: str, path: str, headers: dict, body: bytes
    ) -> tuple[int, dict, bytes]:
        index = self._n
        self._n += 1
        self.events.append((index, "straggle"))
        time.sleep(self.seconds)
        return self.inner.request(method, path, headers, body)


def _silent(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


# -- the conductor -----------------------------------------------------------


class ChaosConductor:
    """Drive a routed multi-member fleet through one :class:`ChaosPlan`.

    :param root: run directory (members at ``m<i>/``, router at
        ``router/``, the canonical injected-event journal at
        ``chaos_events.jsonl``, the report at ``chaos_report.json``,
        postmortem bundles under ``postmortems/``).
    :param plan: the scenario.
    :param spec_factory: optional ``(tenant_index, uid) -> TenantSpec``
        replacing the built-in tiny PSO/Ackley workload (the conductor
        still applies the plan's lane faults on top).
    :param member_kwargs: extra :class:`~evox_tpu_torch.service.ServiceDaemon`
        kwargs for every member build (e.g. ``compact_records``).
    :param router_kwargs: extra :class:`~evox_tpu_torch.service.TenantRouter`
        kwargs.
    :param slos: feed each member :func:`~evox_tpu_torch.obs.default_slos`
        so the run ends with a real burn-rate report (``False`` to skip).
    :param audit_every: audit cadence in rounds.
    :param max_drain_rounds: fault-free rounds allowed after the plan to
        let every tenant finish before the run is declared wedged.
    :param device: where every member's daemon runs (``None``: the card).
    """

    EVENT_LOG = "chaos_events.jsonl"
    REPORT = "chaos_report.json"

    def __init__(
        self,
        root: Any,
        plan: ChaosPlan,
        *,
        spec_factory: Callable[[int, int], TenantSpec] | None = None,
        member_kwargs: Mapping[str, Any] | None = None,
        router_kwargs: Mapping[str, Any] | None = None,
        slos: bool = True,
        audit_every: int = 1,
        recorder: FlightRecorder | None = None,
        exec_cache: ExecutableCache | None = None,
        max_drain_rounds: int = 200,
        device: Any = None,
    ):
        plan.validate()
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.plan = plan
        self.spec_factory = spec_factory
        self.member_kwargs = dict(member_kwargs or {})
        self.router_kwargs = dict(router_kwargs or {})
        self.slos = bool(slos)
        self.audit_every = max(1, int(audit_every))
        self.max_drain_rounds = int(max_drain_rounds)
        self.device = device
        self.exec_cache = (
            exec_cache
            if exec_cache is not None
            else ExecutableCache(self.root / "exec")
        )
        self.recorder = recorder or FlightRecorder(
            self.root / "postmortems", run_id=plan.digest()[:12]
        )
        self.members: dict[int, ServiceMember] = {}
        self.router: TenantRouter | None = None
        self.round = -1
        self.rounds_run = 0
        self.acks: list[dict[str, Any]] = []
        self.injected: list[dict[str, Any]] = []
        self.violations: list[InvariantViolation] = []
        self.pending: list[int] = []
        self.forgotten: set[str] = set()
        self._completed: set[str] = set()
        self._prev_counters: dict[str, float] = {}
        # Injected-fault sources drained into the canonical event journal:
        # ``(source, epoch, injector, events_seen)``.  Epochs count link /
        # store rebuilds so re-fired schedules stay distinguishable.
        self._injectors: list[dict[str, Any]] = []
        self._builds: dict[str, int] = {}
        self._wire: dict[int, FaultyTransport] = {}
        self._partitions: dict[int, int] = {}
        self._straggles: dict[int, tuple[int, float]] = {}

    # -- fleet construction --------------------------------------------------
    def _track_injector(self, source: str, injector: Any) -> int:
        epoch = self._builds.get(source, 0)
        self._builds[source] = epoch + 1
        self._injectors.append(
            {"source": source, "epoch": epoch, "obj": injector, "seen": 0}
        )
        return epoch

    def _build_member(self, index: int) -> ServiceMember:
        kwargs: dict[str, Any] = dict(
            lanes_per_pack=self.plan.lanes_per_pack,
            segment_steps=self.plan.segment_steps,
            seed=0,
            exec_cache=self.exec_cache,
            device=self.device,
        )
        if self.slos:
            kwargs["slos"] = default_slos()
        kwargs.update(self.member_kwargs)
        store_kwargs = self.plan.store_faults.get(f"member:{index}")
        if store_kwargs:
            store = FaultyStore(**store_kwargs)
            self._track_injector(f"store:member:{index}", store)
            kwargs["store"] = store
        member = ServiceMember(
            index,
            self.root / f"m{index}",
            heartbeat_dir=self.root / "beats",
            **kwargs,
        )
        member.daemon.chaos = self
        return member

    def _rewire(self, index: int, *, fresh_wire: bool) -> None:
        """Compose the member's link: base member → wire injector →
        straggle wrapper → partition wrapper (outermost wins)."""
        if self.router is None:  # pragma: no cover - internal misuse
            raise RuntimeError("conductor fleet is not built yet")
        base: Any = self.router.members[index]
        link: Any = base
        wire_kwargs = self.plan.wire_faults.get(str(index))
        if wire_kwargs:
            if fresh_wire or index not in self._wire:
                transport = FaultyTransport(base, **wire_kwargs)
                self._track_injector(f"wire:{index}", transport)
                self._wire[index] = transport
            else:
                self._wire[index].inner = base
            link = self._wire[index]
        straggle = self._straggles.get(index)
        if straggle is not None:
            wrapper = _StragglerLink(link, straggle[1])
            self._track_injector(f"straggle:{index}", wrapper)
            link = wrapper
        if index in self._partitions:
            wrapper = _PartitionedLink(index)
            self._track_injector(f"partition:{index}", wrapper)
            link = wrapper
        self.router.links[index] = link

    def _build_router(self) -> TenantRouter:
        kwargs: dict[str, Any] = dict(
            fleet_dead_after=300.0,
            fleet_start_grace=0.0,
        )
        kwargs.update(self.router_kwargs)
        router = TenantRouter(
            self.root / "router",
            [self.members[i] for i in sorted(self.members)],
            **kwargs,
        )
        store_kwargs = self.plan.store_faults.get("router")
        if store_kwargs:
            store = FaultyStore(**store_kwargs)
            self._track_injector("store:router", store)
            router.journal.close()
            router.journal = RequestJournal(
                router.root / TenantRouter.JOURNAL_NAME, store=store
            )
            if router.controller is not None:
                router.controller.journal = router.journal
        router.chaos = self
        self.router = router
        for index in self.members:
            self._rewire(index, fresh_wire=True)
        _silent(router.start)
        return router

    # -- plan ops ------------------------------------------------------------
    def _record(self, **event: Any) -> None:
        self.injected.append(dict(event))

    def _kill_member(self, index: int) -> None:
        """SIGKILL as abandonment: the old object is dropped with no
        shutdown path, a fresh member is rebuilt over the same root and
        replays its own journal."""
        if self.router is None:  # pragma: no cover - internal misuse
            raise RuntimeError("conductor fleet is not built yet")
        self.members.pop(index, None)
        member = self._build_member(index)
        self.members[index] = member
        self.router._register(member)
        self.router._dead.discard(index)
        self._rewire(index, fresh_wire=True)
        _silent(member.start)

    def _kill_router(self) -> None:
        """SIGKILL the control plane: abandon the router object and
        rebuild over the same journal — placements must replay."""
        self.router = None
        self._build_router()

    def _apply_event(self, ev: Mapping[str, Any]) -> None:
        op = str(ev["op"])
        if op == "kill-member":
            index = int(ev["member"])
            self._record(round=self.round, source="plan", kind=op,
                         member=index)
            self._kill_member(index)
        elif op == "kill-router":
            self._record(round=self.round, source="plan", kind=op)
            self._kill_router()
        elif op == "partition-member":
            index = int(ev["member"])
            self._record(round=self.round, source="plan", kind=op,
                         member=index, until=int(ev["until"]))
            self._partitions[index] = int(ev["until"])
            self._rewire(index, fresh_wire=False)
        elif op == "straggle-member":
            index = int(ev["member"])
            self._record(round=self.round, source="plan", kind=op,
                         member=index, until=int(ev["until"]),
                         delay_seconds=float(ev["delay_seconds"]))
            self._straggles[index] = (
                int(ev["until"]),
                float(ev["delay_seconds"]),
            )
            self._rewire(index, fresh_wire=False)

    def _expire_windows(self) -> None:
        for index, until in sorted(self._partitions.items()):
            if until <= self.round:
                del self._partitions[index]
                self._record(round=self.round, source="plan",
                             kind="partition-end", member=index)
                self._rewire(index, fresh_wire=False)
        for index, (until, _seconds) in sorted(self._straggles.items()):
            if until <= self.round:
                del self._straggles[index]
                self._record(round=self.round, source="plan",
                             kind="straggle-end", member=index)
                self._rewire(index, fresh_wire=False)

    def _drain_injectors(self) -> None:
        for entry in self._injectors:
            events = entry["obj"].events
            for index, kind in events[entry["seen"]:]:
                self._record(
                    round=self.round,
                    source=entry["source"],
                    epoch=entry["epoch"],
                    index=int(index),
                    kind=str(kind),
                )
            entry["seen"] = len(events)

    # -- workload ------------------------------------------------------------
    def tenant_id(self, index: int) -> str:
        return f"c{int(index):05d}"

    def _spec(self, index: int) -> TenantSpec:
        uid = int(index)
        if self.spec_factory is not None:
            spec = self.spec_factory(index, uid)
        else:
            import torch

            from ..algorithms import PSO
            from ..problems.numerical import Ackley

            dim = 4
            spec = TenantSpec(
                self.tenant_id(index),
                PSO(
                    8,
                    torch.full((dim,), -32.0),
                    torch.full((dim,), 32.0),
                    device="cpu",
                ),
                Ackley(),
                n_steps=self.plan.n_steps,
                uid=uid,
            )
        lane_spec = self.plan.lane_faults.get(str(index))
        if lane_spec:
            from dataclasses import replace

            spec = replace(
                spec,
                problem=FaultyProblem(
                    spec.problem, lane_faults={spec.uid: dict(lane_spec)}
                ),
            )
        return spec

    def _try_submit(self, index: int) -> bool:
        if self.router is None:  # pragma: no cover - internal misuse
            raise RuntimeError("conductor fleet is not built yet")
        spec = self._spec(index)
        try:
            record = _silent(self.router.submit, spec)
        except AdmissionError:
            # Retryable by contract: the placement (if journaled) is
            # reused by the retry next round — never re-minted.
            return False
        self.acks.append(
            {
                "tenant_id": spec.tenant_id,
                "uid": int(record.uid),
                "kind": "submit",
                "round": int(self.round),
            }
        )
        return True

    # -- auditing ------------------------------------------------------------
    def _audit(self) -> list[InvariantViolation]:
        if self.router is None:  # pragma: no cover - internal misuse
            raise RuntimeError("conductor fleet is not built yet")
        counters = {
            "conductor.acks": float(len(self.acks)),
            "conductor.injected": float(len(self.injected)),
            "conductor.rounds": float(self.rounds_run),
        }
        ctx = build_audit_context(
            self.router,
            acks=self.acks,
            round=self.round,
            forgotten=self.forgotten,
            counters=counters,
            previous_counters=self._prev_counters,
        )
        self._completed = set(ctx.completed)
        self._last_slo_reports = dict(ctx.slo_reports)
        self._prev_counters = dict(ctx.counters)
        found = audit_invariants(ctx)
        self.recorder.record_rows(
            {
                "chaos_round": [float(self.round)],
                "chaos_acks": [float(len(self.acks))],
                "chaos_injected": [float(len(self.injected))],
                "chaos_live_tenants": [
                    float(len(ctx.placements) - len(ctx.completed))
                ],
                "chaos_violations": [
                    float(len(self.violations) + len(found))
                ],
            },
            executed=1,
            start_generation=max(0, self.round),
        )
        for violation in found:
            self.violations.append(violation)
            self.recorder.dump(
                "invariant", detail=violation.to_json(), force=True
            )
        self._publish_gauges()
        return found

    def _publish_gauges(self) -> None:
        if self.router is None:
            return
        self.router._gauge(
            "evox_chaos_rounds",
            float(self.rounds_run),
            "Chaos scheduling rounds conducted.",
        )
        self.router._gauge(
            "evox_chaos_injected_events",
            float(len(self.injected)),
            "Faults injected by the chaos conductor, lifetime.",
        )
        self.router._gauge(
            "evox_chaos_invariant_violations",
            float(len(self.violations)),
            "Invariant violations detected by the chaos audit.",
        )
        self.router._gauge(
            "evox_chaos_pending_submissions",
            float(len(self.pending)),
            "Tenants awaiting a successful acked submission.",
        )

    def _write_event_log(self) -> Path:
        path = self.root / self.EVENT_LOG
        lines = [_canonical_json(event) for event in self.injected]
        text = "\n".join(lines)
        if text:
            text += "\n"
        atomic_write_text(path, text)
        return path

    # -- the run -------------------------------------------------------------
    def _round(self, r: int, new_tenants: list[int]) -> None:
        self.round = r
        self.rounds_run += 1
        self._expire_windows()
        if r < self.plan.rounds:
            for ev in self.plan.events:
                if int(ev["round"]) == r:
                    self._apply_event(ev)
        self.pending.extend(new_tenants)
        self.pending = [t for t in self.pending if not self._try_submit(t)]
        if self.router is None:  # pragma: no cover - internal misuse
            raise RuntimeError("conductor fleet is not built yet")
        _silent(self.router.step)
        self._drain_injectors()
        if r % self.audit_every == 0:
            self._audit()
            self._write_event_log()

    def _all_done(self) -> bool:
        return not self.pending and all(
            self.tenant_id(t) in self._completed
            for t in range(self.plan.tenants)
        )

    def run(self) -> ChaosReport:
        """Conduct the plan, audit continuously, drain to completion,
        and return (and persist) the report."""
        started = time.monotonic()
        self._last_slo_reports: dict[str, Any] = {}
        for index in range(self.plan.members):
            self.members[index] = self._build_member(index)
        self._build_router()
        schedule: dict[int, list[int]] = {}
        for tenant, r in enumerate(self.plan.submit_rounds):
            schedule.setdefault(int(r), []).append(tenant)
        for r in range(self.plan.rounds):
            self._round(r, schedule.get(r, []))
        extra = 0
        while extra < self.max_drain_rounds and not self._all_done():
            self._round(self.plan.rounds + extra, [])
            extra += 1
        self._audit()
        event_log = self._write_event_log()
        digest = hashlib.sha256(event_log.read_bytes()).hexdigest()
        worst: float | None = None
        for rows in self._last_slo_reports.values():
            for row in rows:
                burn = row.get("burn_rate")
                if burn is not None and (worst is None or burn > worst):
                    worst = float(burn)
        report = ChaosReport(
            plan_name=self.plan.name,
            plan_digest=self.plan.digest(),
            seed=self.plan.seed,
            rounds_run=self.rounds_run,
            tenants=self.plan.tenants,
            completed=len(self._completed),
            acks=len(self.acks),
            pending=len(self.pending),
            injected_events=len(self.injected),
            violations=[v.to_json() for v in self.violations],
            event_log=str(event_log),
            event_log_sha256=digest,
            slo_burn_report={
                "worst_burn_rate": worst,
                "scopes": self._last_slo_reports,
            },
            counters=dict(self._prev_counters),
            elapsed_seconds=time.monotonic() - started,
        )
        atomic_write_text(
            self.root / self.REPORT,
            json.dumps(report.to_json(), indent=2, sort_keys=True),
        )
        return report

    # -- statusz face --------------------------------------------------------
    def statusz_payload(self) -> dict[str, Any]:
        """The ``chaos`` section the attached router/daemon statusz (and
        the ``evoxtop`` soak strip) renders."""
        worst: float | None = None
        for rows in getattr(self, "_last_slo_reports", {}).values():
            for row in rows:
                burn = row.get("burn_rate")
                if burn is not None and (worst is None or burn > worst):
                    worst = float(burn)
        return {
            "plan": self.plan.name,
            "digest": self.plan.digest()[:12],
            "seed": self.plan.seed,
            "round": self.round,
            "rounds": self.plan.rounds,
            "injected_events": len(self.injected),
            "violations": len(self.violations),
            "acks": len(self.acks),
            "pending": len(self.pending),
            "completed": len(self._completed),
            "live_tenants": max(0, len(self.acks) - len(self._completed)),
            "worst_burn_rate": worst,
        }

    def close(self) -> None:
        if self.router is not None:
            self.router.close()
        for member in self.members.values():
            member.close()
