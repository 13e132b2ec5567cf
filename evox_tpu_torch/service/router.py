"""Cross-host tenant scheduler: capacity-aware, journaled, crash-safe
(counterpart of ``evox_tpu/service/router.py``: the same journal records,
fold, placement rule, refusals, migration and status documents).

A :class:`TenantRouter` fronts N per-host
:class:`~evox_tpu_torch.service.ServiceMember`\\ s and owns the
authoritative tenant → member map, built to the same survive-anything
standard as the journal planes underneath it:

* **Capacity-aware bucket affinity.**  Members advertise capacity (free
  lanes per bucket, per-class queue depths, measured segment cadence,
  program-cache warmth) through the existing
  :class:`~evox_tpu_torch.parallel.HostHeartbeat` payload; the router
  places each submit on the member already running that ``bucket_key``
  with a free lane — packs stay dense and captured programs get reused —
  falling back to the least-loaded live member.
* **Journal-before-ack placement.**  Every placement is appended to the
  router's own :class:`~evox_tpu_torch.service.RequestJournal` as a
  ``kind="placement"`` record (tenant, pinned ``uid``, member, class,
  bucket, encoded spec, and the client's forwarded ``Idempotency-Key``)
  **before** the forward and the ack, so gateway exactly-once semantics
  hold end-to-end through the extra hop: a router SIGKILL+restart rebuilds
  the placement map — and the gateway its dedup map — from one read-only
  replay, then reconciles any journaled-but-unforwarded placement against
  the member's own journal.
* **Survivor migration.**  The router consumes
  :class:`~evox_tpu_torch.parallel.FleetHealth` dead/wedged/slow verdicts
  each round: a dead member's tenants are migrated onto survivors by
  copying their per-tenant checkpoint namespaces and resubmitting with the
  pinned ``uid`` (identity-keyed streams: the resume contract, now
  cross-daemon), every move journaled as a ``kind="migration"`` record.
  Resumed state is bit-identical to an uninterrupted run; wedged/slow
  members keep their tenants but take no new placements.
* **Chaos degrades, never wedges.**  Forwards cross a transport-shaped
  member link (``router.links[i]`` — wrap it in
  :class:`~evox_tpu_torch.resilience.FaultyTransport` to inject drops,
  torn replies, delays, duplicates); a failed forward becomes a structured
  :class:`~evox_tpu_torch.service.AdmissionError` the gateway maps to
  503 + ``Retry-After``, and a duplicated or reply-dropped forward is
  reconciled by ``uid`` so admission stays exactly-once.
* **Controller-driven autoscale.**  A pure, journaled
  :func:`~evox_tpu_torch.control.decide_autoscale` decider drains-then-
  retires idle members and requests growth under sustained shed pressure
  or SLO burn; ``spawn_member=`` turns grow decisions into live members.

The router exposes the daemon surface the gateway fronts (``submit`` /
``steer`` / ``park`` / ``step`` / ``journal`` / ``service`` view /
``device`` / ``_last_segment_seconds`` / introspection providers), so
``Gateway(TenantRouter(...), tokens=...)`` serves a whole fleet through
one authenticated front door.

**Devices.**  Every member must run on one device (the constructor
refuses others): a migrated tenant is bit-identical only on the device it
ran on.  The member link carries **device-free** spec blobs: the router
encodes a spec with every tensor on the host and every pickled
``torch.device`` the host's (:func:`_link_blob`), whatever device the
caller built it on, so a retry built on the other side of the host/card
line is the same tenant, and the member decodes the blob onto its own
device.  ``router.device`` is therefore the host: a gateway in front
decodes submitted specs there, and they reach the card only in the
member's decode, on the serving thread.  The read-only providers
(``_statusz``, ``_healthz``, ``_metrics_text``, member ``capacity()``)
read host state only — endpoint and beat threads call them while the
serving thread may hold a CUDA graph capture open.
"""

from __future__ import annotations

import json
import shutil
import time
from dataclasses import replace as dataclass_replace
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Sequence, Union

import torch

from ..obs.aggregate import FleetAggregator
from ..obs.endpoint import IntrospectionEndpoint
from ..obs.metrics import MetricsRegistry
from ..obs.version import OBS_SCHEMA_VERSION
from .daemon import STEER_KNOBS, _bucket_label, _decode_spec, _encode_spec
from .journal import JournalError, RequestJournal
from .member import MEMBER_API_PREFIX, ServiceMember
from .service import AdmissionError, retry_after_seconds
from .tenant import TenantSpec, bucket_key

__all__ = ["TenantRouter", "fold_router_records"]

#: How many migration / autoscale events the statusz tail keeps.
_EVENT_TAIL = 50

# Where the router holds a spec: the link's blobs are device-free.
_HOST = torch.device("cpu")


def _link_blob(spec: TenantSpec) -> str:
    """The spec as the member link carries it and the placement record
    journals it: encoded with every tensor storage on the host and every
    pickled ``torch.device`` the host's (one encode, a decode onto the
    host, a second encode), so the same tenant built on the card or on
    the host gives the same bytes — the retry check compares them."""
    return _encode_spec(_decode_spec(_encode_spec(spec), _HOST))


def fold_router_records(
    records: Sequence[Any], base: dict[str, Any] | None = None
) -> tuple[dict[str, Any], list[str]]:
    """Pure fold of a router journal record stream onto an optional
    snapshot base state; returns ``(state, anomalies)``.

    The same function is both replay's fold (:meth:`TenantRouter.start`
    seeds from ``journal.snapshot_state`` and folds the suffix) and
    compaction's (:meth:`~evox_tpu_torch.service.RequestJournal.compact`
    folds the whole history into the next snapshot), so a
    snapshot-anchored cold start computes exactly the placement map a full
    replay would.

    ``state`` is canonical-JSON-serializable: ``placements`` maps
    tenant_id → the folded placement record (uid, member, class, bucket,
    encoded spec, ``auto`` for migration-minted moves — ``confirmed`` is
    runtime-only and always False on restore), plus sorted ``drained`` /
    ``retired`` member-index lists and the next free ``uid_next``.
    At-least-once semantics are the journal's: duplicates collapse, last
    placement wins."""
    base = base or {}
    placements: dict[str, dict[str, Any]] = {
        str(t): dict(p) for t, p in (base.get("placements") or {}).items()
    }
    drained = {int(i) for i in base.get("drained") or []}
    retired = {int(i) for i in base.get("retired") or []}
    uid_next = int(base.get("uid_next") or 0)
    idem: dict[str, dict[str, Any]] = {
        str(k): dict(v) for k, v in (base.get("idem") or {}).items()
    }
    anomalies: list[str] = []
    for rec in records:
        data = rec.data
        key = data.get("idem")
        principal = data.get("principal")
        if key and principal:
            # Mirrors Gateway._rebuild_idem exactly — the snapshot must
            # preserve the dedup map a full-journal replay would build.
            idem[f"{principal}:{key}"] = {
                "route": rec.kind,
                "tenant_id": data.get("tenant_id"),
                "uid": data.get("uid"),
                "knobs": {
                    k: data[k]
                    for k in STEER_KNOBS
                    if rec.kind == "steer" and k in data
                },
            }
        if rec.kind in ("placement", "migration"):
            tid = str(data.get("tenant_id"))
            placements[tid] = {
                "tenant_id": tid,
                "uid": int(data.get("uid", 0)),
                "member": int(data.get("member", 0)),
                "class": str(data.get("class", "standard")),
                "bucket": str(data.get("bucket", "")),
                "spec": str(data.get("spec", "")),
                "auto": rec.kind == "migration",
            }
            if rec.kind == "migration":
                # Keep the move's provenance so the statusz migration
                # tail survives compaction.
                placements[tid]["from"] = data.get("from")
                if data.get("reason"):
                    placements[tid]["reason"] = str(data["reason"])
            uid_next = max(uid_next, int(data.get("uid", 0)) + 1)
        elif rec.kind == "drain-member":
            drained.add(int(data.get("member", -1)))
        elif rec.kind == "retire-member":
            index = int(data.get("member", -1))
            retired.add(index)
            drained.discard(index)
    return (
        {
            "placements": placements,
            "drained": sorted(drained),
            "retired": sorted(retired),
            "uid_next": uid_next,
            "idem": idem,
        },
        anomalies,
    )


class _FleetTenants(Mapping):
    """Read-only tenant view across the fleet, resolved through the
    placement map (the owning member's record wins — a migrated tenant may
    transiently exist on two roots)."""

    def __init__(self, router: "TenantRouter"):
        self._router = router

    def get(self, tenant_id: Any, default: Any = None) -> Any:
        record = self._router._tenant_record(tenant_id)
        return record if record is not None else default

    def __getitem__(self, tenant_id: Any) -> Any:
        record = self._router._tenant_record(tenant_id)
        if record is None:
            raise KeyError(tenant_id)
        return record

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._router._placements))

    def __len__(self) -> int:
        return len(self._router._placements)


class _FleetService:
    """The slice of the :class:`OptimizationService` surface the gateway
    touches (``_tenants`` lookups and checkpoint ``namespace``), answered
    fleet-wide through the placement map."""

    def __init__(self, router: "TenantRouter"):
        self._router = router
        self._tenants = _FleetTenants(router)

    def namespace(self, tenant_id: str) -> Path:
        member = self._router._owner(tenant_id)
        if member is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return member.daemon.service.namespace(tenant_id)


class TenantRouter:
    """Capacity-aware scheduler fronting N per-host daemon members.

    Usage::

        members = [ServiceMember(i, root / f"members/{i}",
                                 heartbeat_dir=root / "heartbeats",
                                 lanes_per_pack=8, segment_steps=16,
                                 seed=0)
                   for i in range(2)]
        router = TenantRouter(root, members)
        router.start()            # replay placements, reconcile members
        router.submit(TenantSpec("alice-1", PSO(...), Ackley(),
                                 n_steps=400))
        while router.step():      # rounds + health checks + autoscale
            pass
        # SIGKILL at ANY point, then in a fresh process: same
        # constructor over the same roots; start() replays the journal
        # to the same placement map and dedups retried submits.

    :param root: router directory — the placement journal
        (``router_journal.jsonl``) and, unless the members name one, the
        fleet heartbeat directory (``heartbeats/``) live under it.
    :param members: the fleet.  Indexes must be unique and roots
        distinct; ``seed``, ``segment_steps`` and the daemons' ``device``
        must agree across members (a migrated tenant's trajectory is only
        bit-identical when its identity-keyed stream, cadence and device
        are).
    :param controller: optional :class:`~evox_tpu_torch.control.Controller`
        for journaled autoscale decisions; one journaling into the
        router's own journal is built when absent.
    :param min_members: autoscale never drains below this many live
        members.
    :param max_members: autoscale never grows past this (``None`` =
        unbounded).
    :param autoscale_shed_rounds: arm the shed-pressure growth trigger —
        this many *consecutive* rounds with fresh sheds requests growth;
        ``None`` disables.
    :param autoscale_burn: arm the SLO-burn growth trigger — the worst
        member burn rate at/over this requests growth; ``None`` disables.
    :param autoscale_drain: arm scale-down — surplus idle members (zero
        live tenants, nothing queued fleet-wide, more than ``min_members``
        non-draining) drain first, then retire once empty.  Off by
        default: an unarmed router never shrinks itself.
    :param spawn_member: optional ``index -> ServiceMember`` factory a
        ``grow`` decision calls to add a live member; without it grow
        decisions are journaled and surfaced (``growth_requested``) for an
        external operator.
    :param fleet_dead_after: heartbeat staleness (seconds) after which a
        member is declared dead and its tenants migrate.  Set it above the
        longest round the fleet runs: a member beats once a round, so a
        threshold under a round declares a busy survivor dead.
    :param fleet_start_grace: grace before a member that never beat is
        judged (forwarded to :class:`~evox_tpu_torch.parallel.FleetHealth`).
    :param store: checkpoint store for the router journal (chaos-
        injectable; defaults to a plain
        :class:`~evox_tpu_torch.utils.CheckpointStore`).
    :param endpoint: arm a router-level introspection endpoint (``True`` =
        OS-assigned port, int = that port) serving the fleet-aggregated
        ``/metrics``, member-verdict ``/healthz``, and the router
        ``/statusz`` section; the gateway rides it when attached.
    :param on_event: optional structured-event callback (mirrors the
        daemon's).
    """

    JOURNAL_NAME = "router_journal.jsonl"

    def __init__(
        self,
        root: Union[str, Path],
        members: Sequence[ServiceMember],
        *,
        controller: Any | None = None,
        min_members: int = 1,
        max_members: int | None = None,
        autoscale_shed_rounds: int | None = None,
        autoscale_burn: float | None = None,
        autoscale_drain: bool = False,
        spawn_member: Callable[[int], ServiceMember] | None = None,
        fleet_dead_after: float = 5.0,
        fleet_start_grace: float = 30.0,
        store: Any | None = None,
        endpoint: Union[int, bool, None] = None,
        endpoint_host: str = "127.0.0.1",
        on_event: Callable[[str], None] | None = None,
        compact_records: int | None = None,
        compact_bytes: int | None = None,
        max_replay_seconds: float | None = None,
    ):
        if not members:
            raise ValueError("a router needs at least one member")
        for name, value in (
            ("compact_records", compact_records),
            ("compact_bytes", compact_bytes),
            ("max_replay_seconds", max_replay_seconds),
        ):
            if value is not None and value <= 0:
                raise ValueError(f"{name} must be > 0, got {value}")
        if min_members < 1:
            raise ValueError(f"min_members must be >= 1, got {min_members}")
        if max_members is not None and max_members < min_members:
            raise ValueError(
                f"max_members ({max_members}) < min_members ({min_members})"
            )
        self.root = Path(root)
        self.heartbeat_dir = self.root / "heartbeats"
        self.on_event = on_event
        self._registry = MetricsRegistry()
        self.journal = RequestJournal(
            self.root / self.JOURNAL_NAME,
            store=store,
            registry=self._registry,
        )
        self.members: dict[int, ServiceMember] = {}
        #: Transport per member index — the forward seam.  Replace an
        #: entry with ``FaultyTransport(router.members[i], ...)`` to
        #: inject member-link chaos.
        self.links: dict[int, Any] = {}
        beat_dirs = {
            Path(m.heartbeat.directory).resolve()
            for m in members
            if m.heartbeat is not None
        }
        if len(beat_dirs) > 1:
            raise ValueError(
                f"members beat into different heartbeat directories "
                f"({sorted(map(str, beat_dirs))}); FleetHealth verdicts "
                f"need one shared beat plane"
            )
        if beat_dirs:
            self.heartbeat_dir = beat_dirs.pop()
        seeds: set[Any] = set()
        cadences: set[int] = set()
        devices: set[torch.device] = set()
        roots: set[Path] = set()
        for member in members:
            if member.index in self.members:
                raise ValueError(f"duplicate member index {member.index}")
            root_key = member.root.resolve()
            if root_key in roots or root_key == self.root.resolve():
                raise ValueError(
                    f"member {member.index} root {member.root} is not "
                    f"distinct (each member needs its own journal and "
                    f"tenant namespaces)"
                )
            roots.add(root_key)
            seeds.add(member.daemon.service.seed)
            cadences.add(member.daemon.segment_steps)
            devices.add(member.daemon.device)
            self._register(member)
        if len(seeds) > 1 or len(cadences) > 1:
            raise ValueError(
                f"members disagree on seed ({sorted(map(str, seeds))}) or "
                f"segment_steps ({sorted(cadences)}); migration is only "
                f"bit-identical across identically-configured members"
            )
        if len(devices) > 1:
            raise ValueError(
                f"members run on different devices "
                f"({sorted(map(str, devices))}); a migrated tenant is only "
                f"bit-identical on the device it ran on"
            )
        #: Where the router takes specs: the host (the link's blobs are
        #: device-free; each member decodes onto ``member_device``).
        self.device = _HOST
        if controller is None:
            from ..control import Controller

            controller = Controller(journal=self.journal)
        elif getattr(controller, "journal", None) is None:
            controller.journal = self.journal
        self.controller = controller
        self.min_members = int(min_members)
        self.max_members = None if max_members is None else int(max_members)
        self.autoscale_shed_rounds = (
            None if autoscale_shed_rounds is None else int(autoscale_shed_rounds)
        )
        self.autoscale_burn = (
            None if autoscale_burn is None else float(autoscale_burn)
        )
        self.autoscale_drain = bool(autoscale_drain)
        self.spawn_member = spawn_member
        self.fleet_dead_after = float(fleet_dead_after)
        self.fleet_start_grace = float(fleet_start_grace)
        self.compact_records = (
            None if compact_records is None else int(compact_records)
        )
        self.compact_bytes = (
            None if compact_bytes is None else int(compact_bytes)
        )
        self.max_replay_seconds = (
            None if max_replay_seconds is None else float(max_replay_seconds)
        )
        self.replay_seconds: float | None = None
        self.compactions = 0
        self.compaction_failures = 0
        self.started = False
        self.service = _FleetService(self)
        # tenant_id -> {"uid", "member", "class", "bucket", "spec",
        # "confirmed", "auto"} — the authoritative placement map, always
        # journal-backed (every mutation appends before it applies).
        self._placements: dict[str, dict[str, Any]] = {}
        self._uid_next = 0
        self._dead: set[int] = set()
        self._wedged: set[int] = set()
        self._slow: set[int] = set()
        self._migrations: list[dict[str, Any]] = []
        self._autoscale_events: list[dict[str, Any]] = []
        self.growth_requested = 0
        self._rounds = 0
        self._shed_rounds = 0
        self._last_sheds = 0
        self._link_faults: dict[int, int] = {}
        self._fleet_health: Any | None = None
        self._aggregator = FleetAggregator()
        self.endpoint: IntrospectionEndpoint | None = None
        if endpoint is not None and endpoint is not False:
            self.endpoint = IntrospectionEndpoint(
                metrics=self._metrics_text,
                healthz=self._healthz,
                statusz=self._statusz,
                flight=self._flight_window,
                instrument=self._registry,
                host=endpoint_host,
                port=0 if endpoint is True else int(endpoint),
            )
        # An attached Gateway registers itself here (same seam as the
        # daemon's): /statusz then grows its "gateway" section.
        self.gateway: Any | None = None
        # An attached chaos conductor registers itself here the same way:
        # /statusz grows a "chaos" section.
        self.chaos: Any | None = None

    # -- wiring ---------------------------------------------------------------
    def _register(self, member: ServiceMember) -> None:
        if member.heartbeat is None:
            from ..parallel.multihost import HostHeartbeat

            member.heartbeat = HostHeartbeat(
                self.heartbeat_dir,
                process_index=member.index,
                extra=member.capacity,
                metrics=member.daemon._registry,
            )
        self.members[member.index] = member
        self.links.setdefault(member.index, member)
        self._fleet_health = None  # world changed; rebuild on next check

    def _event(self, msg: str, *, warn: bool = False) -> None:
        if self.on_event is not None:
            self.on_event(msg)
        elif warn:
            import warnings

            warnings.warn(msg)

    def _inc(self, name: str, help: str = "", **labels: Any) -> None:
        try:
            self._registry.counter(name, help, **labels).inc()
        except Exception:  # pragma: no cover - broken registry
            pass

    def _gauge(self, name: str, value: float, help: str = "") -> None:
        try:
            self._registry.gauge(name, help).set(value)
        except Exception:  # pragma: no cover - broken registry
            pass

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> int:
        """Start every live member (each replays its own journal), then
        replay the router journal into the placement map and reconcile: a
        journaled placement whose member never admitted the tenant (killed
        post-journal / pre-forward) is forwarded now, so an acked decision
        is never lost and a never-forwarded one completes exactly once.
        Returns the number of placements restored.  Idempotent."""
        if self.started:
            return 0
        self.started = True
        if self.endpoint is not None and not self.endpoint.started:
            self.endpoint.start()
        t_replay = time.perf_counter()
        records, damage = self.journal.replay(quarantine=True)
        for note in self.journal.replay_notes:
            # Snapshot-fallback recovery anomalies: an operator must see
            # every degraded path taken.
            self._inc(
                "evox_router_snapshot_fallbacks_total",
                "Degraded recovery paths taken at router replay "
                "(snapshot fallback, restored swap, gap warnings).",
            )
            self._event(f"router journal recovery: {note}", warn=True)
        if damage is not None:
            self._inc(
                "evox_router_journal_tail_quarantines_total",
                "Damaged router-journal tails quarantined at replay.",
            )
            self._event(
                f"router journal replay: damaged tail ({damage.reason}); "
                f"{damage.bytes_quarantined} bytes quarantined",
                warn=True,
            )
        base = self.journal.snapshot_state
        if base is not None:
            self._event(
                f"router journal replay anchored at snapshot seq "
                f"{self.journal.snapshot_seq} "
                f"({len(records)} suffix records to fold)"
            )
        # Fold snapshot base + record suffix with the same pure fold
        # compaction snapshots through — both cold-start paths compute
        # identical placement maps.
        state, anomalies = fold_router_records(records, base=base)
        for msg in anomalies:
            self._event(f"router journal replay: {msg}", warn=True)
        for tid, placement in state["placements"].items():
            self._placements[tid] = {
                **placement,
                "confirmed": False,
                "auto": bool(placement.get("auto")),
            }
            if placement.get("auto"):
                self._note_migration(placement, replayed=True)
        self._uid_next = max(self._uid_next, int(state["uid_next"]))
        for index in state["drained"]:
            member = self.members.get(int(index))
            if member is not None:
                member.draining = True
        for index in state["retired"]:
            member = self.members.get(int(index))
            if member is not None:
                member.retired = True
                member.draining = False
        restored = len(self._placements)
        for member in self.members.values():
            if not member.retired:
                member.start()
        self._reconcile(auto_only=False)
        # The recovery-time signal: router replay + fold + member replays
        # + reconcile (everything between cold start and serving again).
        self.replay_seconds = time.perf_counter() - t_replay
        self._gauge(
            "evox_recovery_replay_seconds",
            self.replay_seconds,
            "Wall seconds of the last cold-start router recovery "
            "(journal replay + fold + member starts + reconcile).",
        )
        self._journal_gauges()
        if restored:
            self._event(
                f"router replay: {len(records)} records -> {restored} "
                f"placements across {len(self.members)} members "
                f"({self.replay_seconds:.3f}s recovery)"
            )
        return restored

    def close(self) -> None:
        if self.endpoint is not None:
            self.endpoint.stop()
        self.journal.close()
        for member in self.members.values():
            member.close()

    def step(self) -> bool:
        """One fleet round: consume fleet-health verdicts (migrating any
        dead member's tenants), step every live member, reconcile pending
        migration forwards, and consult the autoscale decider.  Returns
        whether any member made progress."""
        self.start()
        self._rounds += 1
        self.poll_fleet()
        busy = False
        for index in sorted(self.members):
            member = self.members[index]
            if index in self._dead or member.retired:
                continue
            busy = member.step() or busy
        # A reconcile forward lands AFTER its member's step this round —
        # the round is not idle, or `run()` would drain out with the
        # freshly re-delivered tenant still queued.
        busy = self._reconcile(auto_only=True) > 0 or busy
        self._consult_autoscale()
        self._maybe_compact()
        return busy

    def run(self, max_rounds: int | None = None) -> None:
        """Drain the fleet (mirrors ``ServiceDaemon.run`` semantics)."""
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            rounds += 1
            if not self.step():
                return

    # -- placement ------------------------------------------------------------
    def _usable(self, index: int, *, for_placement: bool = False) -> bool:
        member = self.members.get(index)
        if member is None or member.retired or index in self._dead:
            return False
        if for_placement and (member.draining or index in self._wedged):
            return False
        return True

    def _owner(self, tenant_id: str) -> ServiceMember | None:
        placement = self._placements.get(tenant_id)
        if placement is None:
            return None
        return self.members.get(placement["member"])

    def _tenant_record(self, tenant_id: str) -> Any:
        member = self._owner(tenant_id)
        if member is not None:
            record = member.daemon.service._tenants.get(tenant_id)
            if record is not None:
                return record
        for member in self.members.values():
            record = member.daemon.service._tenants.get(tenant_id)
            if record is not None:
                return record
        return None

    def _place(self, bucket: str, *, exclude: set[int] | None = None) -> int:
        """Choose a member for one placement: bucket affinity first (a
        live member already running this bucket with a free lane — packs
        stay dense, captured programs get reused), else the least-loaded
        live member; ties break to the lowest index."""
        exclude = exclude or set()
        candidates = [
            i
            for i in sorted(self.members)
            if i not in exclude and self._usable(i, for_placement=True)
        ]
        if not candidates:
            raise AdmissionError(
                "no live member can take placements (all dead, draining, "
                "wedged, or retired); retry after the fleet recovers",
                reason="no-members",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            )
        capacities = {i: self.members[i].capacity() for i in candidates}
        affinity = [
            i
            for i in candidates
            if int(capacities[i].get("free_lanes", {}).get(bucket, 0)) > 0
        ]
        pool = affinity or candidates
        return min(
            pool,
            key=lambda i: (
                int(capacities[i].get("running", 0))
                + int(capacities[i].get("queued", 0)),
                i,
            ),
        )

    def submit(
        self,
        spec: TenantSpec,
        *,
        tenant_class: str = "standard",
        journal_extra: dict[str, Any] | None = None,
    ) -> Any:
        """Place and admit one tenant durably.  The ``uid`` is pinned at
        placement time (the identity the tenant keeps wherever it lands or
        later migrates), the ``placement`` record — carrying the gateway's
        forwarded idempotency key via ``journal_extra`` and the spec's
        device-free blob — is fsync'd BEFORE the forward and the ack, and
        a failed forward degrades to a retryable :class:`AdmissionError`
        whose journaled placement is reused (never re-appended, never
        double-admitted) by the retry."""
        self.start()
        tenant_id = spec.tenant_id
        prior = self._placements.get(tenant_id)
        if prior is not None and spec.uid is not None and int(spec.uid) != int(
            prior["uid"]
        ):
            raise AdmissionError(
                f"tenant {tenant_id!r} is placed with uid {prior['uid']}; "
                f"a resubmission may not change identity "
                f"(got uid {spec.uid})",
                reason="uid-mismatch",
            )
        uid = (
            int(prior["uid"])
            if prior is not None
            else (int(spec.uid) if spec.uid is not None else self._uid_next)
        )
        pinned = dataclass_replace(spec, uid=uid)
        bucket = _bucket_label(bucket_key(pinned))
        blob = _link_blob(pinned)
        was_confirmed = bool(prior and prior.get("confirmed"))
        if was_confirmed:
            if prior["spec"] != blob or prior["class"] != str(tenant_class):
                raise AdmissionError(
                    f"tenant {tenant_id!r} is already admitted; a "
                    f"duplicate id with a different spec or class is a "
                    f"collision (forget the tenant first)",
                    reason="id-collision",
                )
            record = self._tenant_record(tenant_id)
            if record is not None and int(record.uid) == uid:
                # Replay of an acked admission (a retry whose first ack was
                # lost downstream of the router, possibly across a router
                # restart): the journaled placement is the authority —
                # idempotent ack, no append, no forward.
                return record
        migrated_from: int | None = None
        if prior is not None and self._usable(prior["member"]):
            # Sticky: resubmissions/retries stay on the owning member even
            # while it drains (affinity beats drain for resident tenants).
            target = int(prior["member"])
        else:
            target = self._place(bucket)
            if prior is not None:
                migrated_from = int(prior["member"])
        placement = {
            "tenant_id": tenant_id,
            "uid": uid,
            "member": target,
            "class": str(tenant_class),
            "bucket": bucket,
            "spec": blob,
            "confirmed": False,
            "auto": False,
        }
        if (
            prior is not None
            and not was_confirmed
            and prior["member"] == target
            and prior["spec"] == blob
            and prior["class"] == str(tenant_class)
        ):
            # Retry of an un-acked placement: the journaled decision stands
            # — complete it instead of appending a duplicate.
            placement = prior
        elif migrated_from is not None:
            self._copy_namespace(migrated_from, target, tenant_id)
            self._append_required(
                "migration",
                tenant_id=tenant_id,
                uid=uid,
                member=target,
                **{"from": migrated_from, "class": str(tenant_class)},
                bucket=bucket,
                spec=blob,
                reason="resubmit-dead-owner",
                **(journal_extra or {}),
            )
            self._note_migration(
                {
                    "tenant_id": tenant_id,
                    "uid": uid,
                    "member": target,
                    "from": migrated_from,
                    "reason": "resubmit-dead-owner",
                }
            )
        else:
            self._append_required(
                "placement",
                tenant_id=tenant_id,
                uid=uid,
                member=target,
                **{"class": str(tenant_class)},
                bucket=bucket,
                spec=blob,
                **(journal_extra or {}),
            )
        self._placements[tenant_id] = placement
        self._uid_next = max(self._uid_next, uid + 1)
        # Every path to this ack has a journaled placement: the one branch
        # that skips the append above (`placement = prior`) retries an
        # un-acked placement whose record is durable from the first try.
        return self._forward_submit(placement, allow_collision=not was_confirmed)

    def _append_required(self, kind: str, **data: Any) -> None:
        """Journal one ack-path record; a failed append is a retryable
        refusal (the daemon's submit contract, one plane up)."""
        try:
            self.journal.append(kind, **data)
        except JournalError as e:
            raise AdmissionError(
                f"the router {kind} record could not be made durable ({e})",
                reason="journal-failed",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            ) from e
        self._inc(
            "evox_router_journal_records_total",
            "Router journal records durably appended, by kind.",
            kind=kind,
        )

    def _append_advisory(self, kind: str, **data: Any) -> None:
        try:
            self.journal.append(kind, **data)
        except JournalError as e:
            self._event(
                f"router journal append of advisory {kind!r} failed ({e})",
                warn=True,
            )

    # -- the forward seam -----------------------------------------------------
    def _forward(
        self, index: int, route: str, payload: dict[str, Any]
    ) -> tuple[int, dict[str, Any]]:
        """One mutating forward across the member link.  Transport faults
        (dropped/torn/delayed — anything
        :class:`~evox_tpu_torch.resilience.FaultyTransport` raises) and
        unparseable replies become a structured retryable ``member-link``
        refusal; the member's own structured refusals pass through as
        ``(status, reply)``."""
        link = self.links.get(index, self.members.get(index))
        body = json.dumps(payload).encode("utf-8")
        try:
            status, _headers, raw = link.request(
                "POST", MEMBER_API_PREFIX + route, {}, body
            )
            reply = json.loads(raw.decode("utf-8"))
            if not isinstance(reply, dict):
                raise ValueError(f"non-object reply: {reply!r}")
        except (ConnectionError, ValueError, UnicodeDecodeError) as e:
            self._link_faults[index] = self._link_faults.get(index, 0) + 1
            self._inc(
                "evox_router_link_faults_total",
                "Member-link forwards lost to transport faults, by member.",
                member=str(index),
            )
            self._event(
                f"member {index} link fault on {route}: "
                f"{type(e).__name__}: {e}",
                warn=True,
            )
            raise AdmissionError(
                f"member {index} link failed ({type(e).__name__}: {e}); "
                f"the decision is journaled — retry lands exactly once",
                reason="member-link",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            ) from e
        return int(status), reply

    def _forward_submit(
        self, placement: dict[str, Any], *, allow_collision: bool
    ) -> Any:
        index = placement["member"]
        status, reply = self._forward(
            index,
            "/submit",
            {"spec": placement["spec"], "tenant_class": placement["class"]},
        )
        member = self.members[index]
        tenant_id = placement["tenant_id"]
        if status == 201:
            placement["confirmed"] = True
            self._inc(
                "evox_router_placements_total",
                "Tenants placed onto members, by member.",
                member=str(index),
            )
            return member.daemon.tenant(tenant_id)
        if status == 409 and allow_collision:
            # An earlier forward of THIS placement landed (reply dropped,
            # duplicated request, or a pre-restart forward): the member
            # holds our tenant under the pinned uid — that IS the ack.
            record = member.daemon.service._tenants.get(tenant_id)
            if record is not None and int(record.uid) == int(placement["uid"]):
                placement["confirmed"] = True
                return record
        raise self._reply_refusal(status, reply, index)

    def _reply_refusal(
        self, status: int, reply: dict[str, Any], index: int
    ) -> Exception:
        reason = str(reply.get("error", "member-error"))
        detail = str(reply.get("detail", reply))
        if status == 404:
            return KeyError(detail)
        if status == 400:
            return ValueError(detail)
        if status == 409 and reason == "conflict":
            return RuntimeError(detail)
        seconds = reply.get("retry_after_seconds")
        if seconds is None and status in (429, 503, 500):
            seconds = retry_after_seconds(1, self._last_segment_seconds)
        return AdmissionError(
            f"member {index} refused: {detail}",
            reason=reason,
            retry_after_segments=reply.get("retry_after_segments"),
            retry_after_seconds=seconds,
        )

    def steer(
        self,
        tenant_id: str,
        *,
        n_steps: int | None = None,
        checkpoint_every: int | None = None,
        max_restarts: int | None = None,
        journal_extra: dict[str, Any] | None = None,
    ) -> dict[str, int]:
        """Forward one durable steer to the owning member (its journal
        acks the knobs before the reply), then journal the router's own
        ``steer`` record carrying the idempotency key so a retry across a
        router restart dedups.  Steers are value-idempotent, so
        forward-then-journal is safe: a duplicate forward collapses at the
        member's replay fold."""
        self.start()
        placement = self._placements.get(tenant_id)
        if placement is None:
            raise KeyError(
                f"unknown tenant {tenant_id!r} (never placed by this router)"
            )
        if not self._usable(placement["member"]):
            raise AdmissionError(
                f"tenant {tenant_id!r} is placed on member "
                f"{placement['member']}, which is down; it migrates at the "
                f"next health check — retry",
                reason="member-down",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            )
        payload: dict[str, Any] = {"tenant_id": tenant_id}
        for name, value in (
            ("n_steps", n_steps),
            ("checkpoint_every", checkpoint_every),
            ("max_restarts", max_restarts),
        ):
            if value is not None:
                payload[name] = int(value)
        status, reply = self._forward(placement["member"], "/steer", payload)
        if status != 200:
            raise self._reply_refusal(status, reply, placement["member"])
        knobs = {k: int(v) for k, v in dict(reply.get("knobs", {})).items()}
        self._append_required(
            "steer",
            tenant_id=tenant_id,
            uid=placement["uid"],
            member=placement["member"],
            **knobs,
            **(journal_extra or {}),
        )
        return knobs

    def park(self, tenant_id: str) -> str:
        """Forward one durable park/withdraw to the owning member (its
        ``evict`` record is the ack); the router's advisory ``park``
        record keeps the placement tail navigable."""
        self.start()
        placement = self._placements.get(tenant_id)
        if placement is None:
            raise KeyError(
                f"unknown tenant {tenant_id!r} (never placed by this router)"
            )
        if not self._usable(placement["member"]):
            raise AdmissionError(
                f"tenant {tenant_id!r} is placed on member "
                f"{placement['member']}, which is down; retry after the "
                f"next health check",
                reason="member-down",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            )
        status, reply = self._forward(
            placement["member"], "/park", {"tenant_id": tenant_id}
        )
        if status != 200:
            raise self._reply_refusal(status, reply, placement["member"])
        self._append_advisory(
            "park",
            tenant_id=tenant_id,
            uid=placement["uid"],
            member=placement["member"],
        )
        return str(reply.get("was", ""))

    def result(self, tenant_id: str) -> Any:
        member = self._owner(tenant_id)
        if member is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return member.daemon.result(tenant_id)

    def tenant(self, tenant_id: str) -> Any:
        record = self._tenant_record(tenant_id)
        if record is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        return record

    # -- reconciliation / migration -------------------------------------------
    def _reconcile(self, *, auto_only: bool) -> int:
        """Complete journaled-but-unconfirmed placements.  At start
        (``auto_only=False``) every unconfirmed placement is checked
        against its member — present under the pinned uid means the
        pre-kill forward landed; absent means it never did, so forward now
        (exactly-once: the journal decided, this delivers).  In steady
        state only migration placements auto-retry; a client-facing
        placement whose forward failed waits for the client's retry (the
        ack path stays client-driven).  Returns how many forwards were
        (re)delivered — work queued on a member whose round already ran,
        so the caller's round is not idle."""
        forwarded = 0
        for tenant_id, placement in list(self._placements.items()):
            if placement["confirmed"]:
                continue
            if auto_only and not placement.get("auto"):
                continue
            if not self._usable(placement["member"]):
                continue
            member = self.members[placement["member"]]
            record = member.daemon.service._tenants.get(tenant_id)
            if record is not None and int(record.uid) == int(placement["uid"]):
                placement["confirmed"] = True
                continue
            try:
                self._forward_submit(placement, allow_collision=True)
                forwarded += 1
            except (AdmissionError, KeyError, ValueError, RuntimeError) as e:
                self._event(
                    f"reconcile of {tenant_id!r} on member "
                    f"{placement['member']} deferred: {e}",
                    warn=True,
                )
        return forwarded

    def poll_fleet(self, now: float | None = None) -> Any:
        """Read the heartbeat plane and act on the verdicts: newly-dead
        members hand their tenants to survivors (journaled migrations);
        wedged/slow members are fenced from new placements.  Returns the
        :class:`~evox_tpu_torch.parallel.FleetReport` (or ``None`` when no
        member heartbeats exist yet)."""
        watched = [
            i
            for i, m in self.members.items()
            if m.heartbeat is not None and not m.retired
        ]
        if not watched or not self.heartbeat_dir.is_dir():
            return None
        world = max(watched) + 1
        from ..parallel.multihost import FleetHealth

        if self._fleet_health is None or self._fleet_health.num_processes != world:
            self._fleet_health = FleetHealth(
                self.heartbeat_dir,
                world,
                dead_after=self.fleet_dead_after,
                start_grace=self.fleet_start_grace,
            )
        # Live knob: an operator (or test) may retune the staleness
        # threshold on a running router; the next verdict honors it.
        self._fleet_health.dead_after = self.fleet_dead_after
        report = self._fleet_health.check(now)
        watched_set = set(watched)
        self._wedged = {
            i for i in report.wedged_hosts if i in watched_set
        } - self._dead
        self._slow = {i for i in report.slow_hosts if i in watched_set} - self._dead
        for index in report.dead_hosts:
            if index in watched_set and index not in self._dead:
                self._dead.add(index)
                reasons = list(
                    getattr(report.verdicts.get(index), "reasons", [])
                )
                self._event(
                    f"member {index} is dead "
                    f"({'; '.join(reasons) or 'stale heartbeat'}); "
                    f"migrating its tenants to survivors",
                    warn=True,
                )
                self._migrate_member(index)
        return report

    def _migrate_member(self, index: int) -> None:
        """Move every tenant placed on a dead member onto survivors: copy
        the per-tenant checkpoint namespace, journal the ``migration``
        record, and resubmit under the pinned uid — the survivor resumes
        from the last checkpoint bit-identically."""
        moved = 0
        for tenant_id, placement in sorted(self._placements.items()):
            if placement["member"] != index:
                continue
            try:
                target = self._place(placement["bucket"], exclude={index})
            except AdmissionError as e:
                self._event(
                    f"tenant {tenant_id!r} is stranded on dead member "
                    f"{index}: {e}",
                    warn=True,
                )
                continue
            self._copy_namespace(index, target, tenant_id)
            try:
                self._append_required(
                    "migration",
                    tenant_id=tenant_id,
                    uid=placement["uid"],
                    member=target,
                    **{"from": index, "class": placement["class"]},
                    bucket=placement["bucket"],
                    spec=placement["spec"],
                    reason="dead-member",
                )
            except AdmissionError as e:
                self._event(
                    f"migration of {tenant_id!r} could not be journaled "
                    f"({e}); it stays on the dead member until a retry",
                    warn=True,
                )
                continue
            self._placements[tenant_id] = {
                **placement,
                "member": target,
                "confirmed": False,
                "auto": True,
            }
            self._note_migration(
                {
                    "tenant_id": tenant_id,
                    "uid": placement["uid"],
                    "member": target,
                    "from": index,
                    "reason": "dead-member",
                }
            )
            try:
                self._forward_submit(
                    self._placements[tenant_id], allow_collision=True
                )
            except (AdmissionError, KeyError, ValueError, RuntimeError) as e:
                self._event(
                    f"migration forward of {tenant_id!r} to member "
                    f"{target} deferred ({e}); reconciled next round",
                    warn=True,
                )
            moved += 1
        if moved:
            self._event(f"migrated {moved} tenants off dead member {index}")

    def _copy_namespace(self, source: int, target: int, tenant_id: str) -> None:
        """Bring a tenant's checkpoint namespace to its new member (the
        resume substrate).  Checkpoints are published atomically (a
        temporary file, fsync, rename), so the copy holds only whole
        archives and the target resumes from the newest complete one.
        Best-effort: a tenant that never checkpointed has nothing to copy
        and resumes from generation zero, exactly as a single-daemon
        restart would."""
        src_member = self.members.get(source)
        dst_member = self.members.get(target)
        if src_member is None or dst_member is None:
            return
        src = src_member.daemon.service.namespace(tenant_id)
        if not src.is_dir():
            return
        dst = dst_member.daemon.service.namespace(tenant_id)
        try:
            shutil.copytree(src, dst, dirs_exist_ok=True)
        except OSError as e:
            self._event(
                f"namespace copy of {tenant_id!r} (member {source} -> "
                f"{target}) failed: {e}; the tenant resumes from its last "
                f"state available on the target",
                warn=True,
            )

    def _note_migration(
        self, data: Mapping[str, Any], *, replayed: bool = False
    ) -> None:
        entry = {
            "tenant_id": data.get("tenant_id"),
            "uid": data.get("uid"),
            "from": data.get("from"),
            "to": data.get("member"),
            "reason": data.get("reason", "replayed" if replayed else ""),
        }
        self._migrations.append(entry)
        del self._migrations[:-_EVENT_TAIL]
        if not replayed:
            self._inc(
                "evox_router_migrations_total",
                "Tenants migrated between members, by reason.",
                reason=str(entry["reason"]),
            )

    # -- autoscale ------------------------------------------------------------
    def _consult_autoscale(self) -> str:
        """Build this round's autoscale evidence and consult the journaled
        decider: ``grow`` under sustained shed pressure or SLO burn,
        ``drain:<i>``/``retire:<i>`` for surplus idle members (drain first
        — no new placements; retire once drained).  Every non-hold action
        is a journaled, bit-for-bit replayable decision."""
        if (
            self.autoscale_shed_rounds is None
            and self.autoscale_burn is None
            and not self.autoscale_drain
        ):
            return "hold"  # nothing armed: the fleet never resizes itself
        live = [
            i
            for i, m in self.members.items()
            if not m.retired and i not in self._dead
        ]
        draining = [i for i in live if self.members[i].draining]
        total_sheds = sum(self.members[i].daemon.stats.sheds for i in live)
        if total_sheds > self._last_sheds:
            self._shed_rounds += 1
        else:
            self._shed_rounds = 0
        self._last_sheds = total_sheds
        burn = None
        for i in live:
            slo = self.members[i].daemon.slo
            if slo is None:
                continue
            try:
                worst = slo.worst()
            except Exception:  # noqa: BLE001 - advisory signal
                continue
            if worst is not None and (burn is None or worst.burn_rate > burn):
                burn = float(worst.burn_rate)
        placed_live: dict[int, int] = {}
        for placement in self._placements.values():
            record = self._tenant_record(placement["tenant_id"])
            status = getattr(
                getattr(record, "status", None), "value", "completed"
            )
            if status != "completed":
                placed_live[placement["member"]] = (
                    placed_live.get(placement["member"], 0) + 1
                )
        drained = [i for i in draining if placed_live.get(i, 0) == 0]
        idle = [
            i
            for i in live
            if not self.members[i].draining and placed_live.get(i, 0) == 0
        ]
        queued = sum(
            int(self.members[i].capacity().get("queued", 0)) for i in live
        )
        evidence = {
            "members": len(live),
            "draining": len(draining),
            "min_members": self.min_members,
            "max_members": self.max_members,
            "shed_rounds": self._shed_rounds,
            "shed_sustain": self.autoscale_shed_rounds,
            "burn_rate": burn,
            "burn_enter": self.autoscale_burn,
            "queued": queued,
            "idle_member": (
                min(idle) if idle and self.autoscale_drain else None
            ),
            "drained_member": min(drained) if drained else None,
        }
        action = self.controller.autoscale(
            evidence=evidence, generation=self._rounds
        )
        if action and action != "hold":
            self._apply_autoscale(str(action))
        return str(action or "hold")

    def _apply_autoscale(self, action: str) -> None:
        entry = {"round": self._rounds, "action": action}
        self._autoscale_events.append(entry)
        del self._autoscale_events[:-_EVENT_TAIL]
        if action == "grow":
            self.growth_requested += 1
            if self.spawn_member is None:
                self._event(
                    "autoscale requests fleet growth (no spawn_member "
                    "factory attached; surfaced for the operator)",
                    warn=True,
                )
                return
            index = max(self.members) + 1
            member = self.spawn_member(index)
            self._register(member)
            member.start()
            self._event(f"autoscale grew the fleet: member {index} joined")
            return
        verb, _, raw = action.partition(":")
        try:
            index = int(raw)
        except ValueError:
            return
        member = self.members.get(index)
        if member is None or member.retired or index in self._dead:
            return
        if verb == "drain":
            self._append_advisory("drain-member", member=index)
            member.draining = True
            self._event(
                f"autoscale drains member {index}: no new placements; "
                f"retires once its tenants finish"
            )
        elif verb == "retire":
            self._append_advisory("retire-member", member=index)
            member.retired = True
            member.draining = False
            if member.heartbeat is not None:
                member.heartbeat.stop()
            self._fleet_health = None
            self._event(
                f"autoscale retired drained member {index} "
                f"(read-only; completed results stay fetchable)"
            )

    # -- journal compaction ----------------------------------------------------
    def _journal_gauges(self) -> None:
        """Publish the journal-growth gauges the compaction SLO watches."""
        self._gauge(
            "evox_journal_bytes",
            self.journal.size_bytes,
            "Router journal file size in bytes.",
        )
        self._gauge(
            "evox_journal_records",
            self.journal.records_since_snapshot,
            "Router journal records since the last snapshot anchor "
            "(the whole history when never compacted).",
        )
        if self.journal.snapshot_at is not None:
            self._gauge(
                "evox_journal_snapshot_age_seconds",
                max(0.0, time.time() - self.journal.snapshot_at),
                "Seconds since the router journal's last snapshot.",
            )

    def _compaction_armed(self) -> bool:
        return (
            self.compact_records is not None
            or self.compact_bytes is not None
            or self.max_replay_seconds is not None
        )

    def _maybe_compact(self) -> None:
        """Boundary-time router-journal compaction: journal-growth
        evidence → the same pure journaled ``compact`` decider the daemon
        consults → the crash-safe snapshot/swap protocol, snapshotting the
        placement map.  Never raises — a refused or failed compaction
        warns and routing continues on the uncompacted journal."""
        self._journal_gauges()
        if not self._compaction_armed():
            return
        evidence = {
            "journal_bytes": self.journal.size_bytes,
            "journal_records": self.journal.records_since_snapshot,
            "live_tenants": len(self._placements),
            "replay_seconds": self.replay_seconds,
            "compact_records": self.compact_records,
            "compact_bytes": self.compact_bytes,
            "max_replay_seconds": self.max_replay_seconds,
        }
        action = self.controller.compact(
            evidence=evidence, generation=self._rounds
        )
        if action == "compact":
            self._compact_journal()

    def _compact_journal(self) -> None:
        """One crash-safe compaction through the journal's protocol,
        folding the placement map with the same pure fold replay uses."""

        def fold(
            base: dict[str, Any] | None, records: list[Any]
        ) -> dict[str, Any]:
            state, _anomalies = fold_router_records(records, base=base)
            return state

        t0 = time.perf_counter()
        try:
            result = self.journal.compact(fold)
        except JournalError as e:
            self.compaction_failures += 1
            self._inc(
                "evox_router_compaction_failures_total",
                "Router-journal compactions that failed (routing "
                "continued on the uncompacted journal).",
            )
            self._event(f"router journal compaction failed ({e})", warn=True)
            return
        self.compactions += 1
        self._inc(
            "evox_router_compactions_total",
            "Successful router-journal compactions.",
        )
        self._journal_gauges()
        self._event(
            f"router journal compacted at seq {result.seq}: "
            f"{result.folded_records} records ({result.bytes_before} "
            f"bytes) folded into {result.snapshot_path.name}; journal "
            f"now {result.bytes_after} bytes"
            + (
                f"; GC'd {len(result.removed)} superseded artifacts"
                if result.removed
                else ""
            )
            + f" ({time.perf_counter() - t0:.3f}s)"
        )

    def _journal_statusz(self) -> dict[str, Any]:
        """The journal/recovery strip ``evoxtop`` renders — same shape as
        the daemon's."""
        snapshot_at = self.journal.snapshot_at
        strip: dict[str, Any] = {
            "bytes": self.journal.size_bytes,
            "records_since_snapshot": self.journal.records_since_snapshot,
            "snapshot_seq": self.journal.snapshot_seq,
            "snapshot_age_seconds": (
                None
                if snapshot_at is None
                else max(0.0, time.time() - snapshot_at)
            ),
            "replay_seconds": self.replay_seconds,
            "compactions": self.compactions,
            "compaction_failures": self.compaction_failures,
            "fallbacks": self.journal.snapshot_fallbacks,
            "armed": self._compaction_armed(),
        }
        if self.controller is not None:
            strip["decisions"] = [
                m
                for m in (
                    d.to_manifest()
                    for d in list(self.controller.decisions)[-40:]
                )
                if m.get("kind") == "compact"
            ][-4:]
        return strip

    # -- gateway-compat surface ----------------------------------------------
    @property
    def _last_segment_seconds(self) -> float | None:
        cadences = [
            m.daemon._last_segment_seconds
            for i, m in self.members.items()
            if self._usable(i) and m.daemon._last_segment_seconds is not None
        ]
        return max(cadences) if cadences else None

    @property
    def slo(self) -> Any | None:
        """The first live member's SLO tracker (the gateway scores its
        availability signal somewhere real); ``None`` when no member
        carries one."""
        for i in sorted(self.members):
            if self._usable(i) and self.members[i].daemon.slo is not None:
                return self.members[i].daemon.slo
        return None

    # -- introspection providers (read-only, fail-safe, host state only) -----
    def _metrics_text(self) -> str:
        from ..parallel.multihost import read_heartbeats

        beats = (
            read_heartbeats(self.heartbeat_dir)
            if self.heartbeat_dir.is_dir()
            else {}
        )
        if beats:
            report = None
            if self._fleet_health is not None:
                try:
                    report = self._fleet_health.check()
                except Exception:  # noqa: BLE001 - scrape must not throw
                    report = None
            self._aggregator.update(beats, report)
            return self._aggregator.to_prometheus()
        return self._registry.to_prometheus()

    def _healthz(self) -> tuple[bool, dict[str, Any]]:
        dead = sorted(self._dead)
        payload: dict[str, Any] = {
            "router": True,
            "started": self.started,
            "members": len(self.members),
            "live_members": sum(1 for i in self.members if self._usable(i)),
            "dead_members": dead,
            "tenants": len(self._placements),
        }
        # Read-only: render the last supervisor's verdicts without
        # re-judging (a probe must not mint migrations — step() does).
        if self._fleet_health is not None:
            try:
                payload.update(self._fleet_health.check().to_json())
            except Exception as e:  # noqa: BLE001 - a probe must answer
                payload["fleet_error"] = f"{type(e).__name__}: {e}"
        healthy = self.started and not dead
        payload["healthy"] = healthy
        return healthy, payload

    def _statusz(self) -> dict[str, Any]:
        members: dict[str, Any] = {}
        placed_counts: dict[int, int] = {}
        for placement in list(self._placements.values()):
            placed_counts[placement["member"]] = (
                placed_counts.get(placement["member"], 0) + 1
            )
        for index in sorted(self.members):
            member = self.members[index]
            if index in self._dead:
                state = "dead"
            elif member.retired:
                state = "retired"
            elif member.draining:
                state = "draining"
            elif index in self._wedged:
                state = "wedged"
            elif index in self._slow:
                state = "slow"
            else:
                state = "ok"
            try:
                capacity = member.capacity()
            except Exception as e:  # noqa: BLE001 - read-only, fail-safe
                capacity = {"error": f"{type(e).__name__}: {e}"}
            members[str(index)] = {
                "state": state,
                "placements": placed_counts.get(index, 0),
                "link_faults": self._link_faults.get(index, 0),
                "capacity": capacity,
            }
        tenants: dict[str, Any] = {}
        counts: dict[str, int] = {}
        for tenant_id, placement in list(self._placements.items()):
            record = self._tenant_record(tenant_id)
            status = getattr(getattr(record, "status", None), "value", "unknown")
            counts[status] = counts.get(status, 0) + 1
            tenants[tenant_id] = {
                "status": status,
                "uid": placement["uid"],
                "member": placement["member"],
                "class": placement["class"],
                "bucket": placement["bucket"],
                "generations": int(getattr(record, "generations", 0)),
                "n_steps": int(
                    getattr(getattr(record, "spec", None), "n_steps", 0)
                ),
            }
        out: dict[str, Any] = {
            "schema": OBS_SCHEMA_VERSION,
            "time": time.time(),
            "started": self.started,
            "round_seconds": self._last_segment_seconds,
            "tenants": tenants,
            "tenant_counts": counts,
            "router": {
                "members": members,
                "placements": len(self._placements),
                "uid_next": self._uid_next,
                "rounds": self._rounds,
                "shed_rounds": self._shed_rounds,
                "growth_requested": self.growth_requested,
                "migrations": list(self._migrations[-20:]),
                "autoscale": list(self._autoscale_events[-20:]),
            },
            "journal": self._journal_statusz(),
        }
        if self.controller is not None:
            out["decisions"] = [
                d.to_manifest() for d in list(self.controller.decisions)[-20:]
            ]
        if self.gateway is not None:
            try:
                out["gateway"] = self.gateway.statusz_payload()
            except Exception as e:  # noqa: BLE001 - read-only, fail-safe
                out["gateway"] = {"error": f"{type(e).__name__}: {e}"}
        if self.chaos is not None:
            try:
                out["chaos"] = self.chaos.statusz_payload()
            except Exception as e:  # noqa: BLE001 - read-only, fail-safe
                out["chaos"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def _flight_window(self, tenant_id: str) -> Any:
        member = self._owner(tenant_id)
        if member is None:
            return None
        return member.daemon._flight_window(tenant_id)
