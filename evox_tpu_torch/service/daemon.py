"""The durable serving daemon: a service you can kill at any point
(counterpart of ``evox_tpu/service/daemon.py``).

:class:`ServiceDaemon` composes the multi-tenant
:class:`~evox_tpu_torch.service.OptimizationService` with three durability
planes so that a long-lived serving process *survives its own death*:

1. **Crash-safe request journal**
   (:class:`~evox_tpu_torch.service.RequestJournal`)
   — every submit/evict/retire/complete/preempt is an atomic, fsync'd,
   checksummed record appended *before* the operation is acknowledged.  A
   daemon SIGKILLed at any lifecycle point restarts by replaying the
   journal: the trusted prefix reconstructs the exact set of live tenants
   (at-least-once, deduped by uid), each tenant's checkpoint namespace
   supplies the values, and the run continues bit-identically (minus
   preemption counters) — ``tests/test_torch_daemon.py`` pins the full
   kill-at-every-boundary matrix.

2. **Persistent program cache**
   (:class:`~evox_tpu_torch.utils.ExecutableCache`) — the packed segment
   and init programs of each bucket are captured once per process (a
   captured CUDA graph cannot be serialized), and their *capture records*
   persist what a capture needs beforehand, the kernel libraries, so a
   restarted daemon (or a new tenant landing in a declared bucket) runs no
   ``nvcc``.  ``stats.captures`` counts
   the captures beside the cache's hits, so a hit is never read as
   "nothing captured".  Corrupt, stale, or wrong-topology entries are
   quarantined ``*.corrupt`` and captured anew — never trusted.
   Optionally the bytecode cache of the process is pointed at
   ``<root>/xla_cache`` (the JAX package's name), and handed to its fleet's
   workers.

3. **SLO-aware admission and degradation** — the bounded queue is split
   into per-:class:`TenantClass` budgets; a submission past its class
   budget is **shed** with a structured
   ``AdmissionError(reason="shed", retry_after_segments=...)`` hint
   (computed from the live scheduler state) instead of degrading admitted
   tenants.  Before refusing work, the daemon can **brown out**: when
   queue pressure crosses ``brownout_threshold`` it stretches the segment
   cadence by ``brownout_factor`` (both cadences pre-warmed — no capture),
   trading boundary-work overhead for throughput; hysteresis returns the
   cadence to normal when pressure halves.  Admitted tenants' per-tenant
   gen/s stays within the bulkhead contract throughout (overload
   measured by ``chip_smoke.py``'s ``daemon_overload``).

Tenants run on the daemon's ``device`` (the card unless the caller passes
another): a spec decoded from the journal is rebuilt there, whatever
device its pickle recorded.

Under a :class:`~evox_tpu_torch.resilience.FleetSupervisor`, the daemon is the
worker: :meth:`fleet_supervisor` builds a supervisor whose relaunched
workers replay the shared journal and resume every tenant's namespace on
the surviving fleet — host loss becomes tenant migration.
"""

from __future__ import annotations

import base64
import io
import os
import pickle
import time
import types
import warnings
from dataclasses import dataclass, field, replace as dataclass_replace
from pathlib import Path
from typing import Any, Callable, Sequence, Union

import torch

from ..obs.aggregate import FleetAggregator
from ..obs.endpoint import IntrospectionEndpoint
from ..obs.metrics import MetricsRegistry
from ..obs.slo import (
    SIGNAL_ADMISSION,
    SIGNAL_RECOVERY,
    SIGNAL_SEGMENT_SECONDS,
    SIGNAL_TENANT_GENS,
    SLOTracker,
)
from ..obs.version import OBS_SCHEMA_VERSION
from ..resilience.preemption import Preempted, PreemptionGuard
from ..utils.checkpoint import CheckpointStore, ReadOnlyCheckpointStore
from ..utils.exec_cache import ExecutableCache, enable_xla_compilation_cache
from .journal import JournalError, RequestJournal
from .service import (
    AdmissionError,
    OptimizationService,
    retry_after_seconds,
)
from .tenant import TenantRecord, TenantSpec, TenantStatus

__all__ = [
    "ServiceDaemon",
    "TenantClass",
    "DaemonStats",
    "STEER_KNOBS",
    "fold_daemon_records",
]

#: The journaled ``steer`` record's adjustable scheduling knobs: the
#: tenant's generation budget, checkpoint cadence, and restart budget.
#: Values only — steering changes when the scheduler acts on a tenant,
#: never what any lane computes, which is why a replayed steer is
#: bit-identical by construction.
STEER_KNOBS = ("n_steps", "checkpoint_every", "max_restarts")


@dataclass(frozen=True)
class TenantClass:
    """One admission class: its share of the bounded queue.

    :param name: class label (the ``tenant_class=`` a submission names).
    :param queue_budget: how many submissions of this class may wait for
        a lane at once; the next one is shed with a retry-after hint.
    :param sheddable: whether overload sheds this class at its budget
        (``False`` reserves shedding for the hard service queue bound —
        e.g. an internal maintenance class).
    """

    name: str
    queue_budget: int
    sheddable: bool = True

    def __post_init__(self) -> None:
        if self.queue_budget < 0:
            raise ValueError(
                f"queue_budget must be >= 0, got {self.queue_budget}"
            )


@dataclass
class DaemonStats:
    """Observable record of what the daemon (beyond the service) did."""

    replayed_records: int = 0
    replayed_tenants: int = 0
    journal_damage: list[str] = field(default_factory=list)
    journal_append_failures: int = 0
    # Wall seconds of the last cold-start recovery (journal replay +
    # tenant resubmission) — the recovery-time SLO's signal.
    replay_seconds: float | None = None
    compactions: int = 0
    compaction_failures: int = 0
    sheds: int = 0
    brownout_entries: int = 0
    brownout_exits: int = 0
    # prewarm results: {program_label: loaded_from_cache}
    prewarmed: dict[str, bool] = field(default_factory=dict)
    # Captures made by the daemon's packs, by program ("init",
    # "segment"): a cache hit still captures, once a program.
    captures: dict[str, int] = field(default_factory=lambda: {"init": 0, "segment": 0})


def _encode_spec(spec: TenantSpec) -> str:
    buf = io.BytesIO()
    torch.save(spec, buf)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _decode_spec(blob: str, device: torch.device) -> TenantSpec:
    """The spec of a journaled submit, rebuilt on ``device``: every tensor
    storage is mapped there, and so is every ``torch.device`` the pickle
    recorded (an algorithm's ``device`` attribute)."""

    class Unpickler(pickle.Unpickler):
        def find_class(self, module: str, name: str) -> Any:
            if module == "torch" and name == "device":
                return lambda *args: device
            return super().find_class(module, name)

    module = types.SimpleNamespace(Unpickler=Unpickler, load=pickle.load, __name__="pickle")
    data = io.BytesIO(base64.b64decode(blob.encode("ascii")))
    return torch.load(data, map_location=device, pickle_module=module, weights_only=False)


def _bucket_label(key: tuple) -> str:
    # algorithm[popxdim] + the two static-config digest prefixes: stable
    # across processes, short enough for an exec-cache entry label.
    return f"{key[0]}[{key[1]}x{key[2]}]{key[4][:8]}{key[5][:8]}"


def fold_daemon_records(
    records: Sequence[Any], base: dict[str, Any] | None = None
) -> tuple[dict[str, Any], list[str]]:
    """Pure fold of a daemon journal record stream onto an optional
    snapshot base state; returns ``(state, anomalies)``.

    This single function is both replay's fold (:meth:`ServiceDaemon.start`
    seeds from ``journal.snapshot_state`` and folds the suffix) and
    compaction's (:meth:`RequestJournal.compact` folds the whole history
    into the next snapshot), which makes the replay-equivalence invariant
    hold *by construction*: a snapshot-anchored cold start computes
    exactly the state a full replay would.

    ``state`` is canonical-JSON-serializable (uid keys are strings; set
    members are sorted lists): ``live`` maps uid → the newest submit
    record's data verbatim (spec blob, class, idempotency fields — the
    gateway's exactly-once map survives compaction through it), plus
    ``parked`` / ``completed`` uid lists, ``steers`` (folded knob values,
    last-wins), and ``idem`` (the gateway dedup entries for *all* record
    kinds, so a retried steer or park straddling a compaction still
    replays its ack instead of re-acting).  At-least-once semantics are
    the journal's: duplicates collapse, last state wins.  ``anomalies``
    are human-readable fold warnings (orphan steers) for the caller's
    event stream — never part of the state."""
    base = base or {}
    live: dict[str, dict[str, Any]] = {
        str(k): dict(v) for k, v in (base.get("live") or {}).items()
    }
    parked: set[str] = {str(u) for u in (base.get("parked") or [])}
    completed: set[str] = {str(u) for u in (base.get("completed") or [])}
    steers: dict[str, dict[str, int]] = {
        str(k): dict(v) for k, v in (base.get("steers") or {}).items()
    }
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
        uid = data.get("uid")
        if uid is None:
            continue
        uid = str(int(uid))
        if rec.kind == "submit":
            live[uid] = dict(data)
            parked.discard(uid)
            # A re-submit after a journaled completion (readmission with
            # a refreshed budget) re-arms the completion record, exactly
            # like the live submit() path.  It also supersedes any
            # earlier steering — the fresh spec carries the caller's
            # current intent.
            completed.discard(uid)
            steers.pop(uid, None)
        elif rec.kind == "evict":
            parked.add(uid)
        elif rec.kind == "retire":
            live.pop(uid, None)
            parked.discard(uid)
            completed.discard(uid)
            steers.pop(uid, None)
        elif rec.kind == "complete":
            # Stays live: resubmission materializes the final result
            # from the namespace without occupying a lane.
            completed.add(uid)
        elif rec.kind == "steer":
            if uid in live:
                # At-least-once: duplicate steer records collapse (last
                # value per knob wins, same as replaying in sequence).
                steers.setdefault(uid, {}).update(
                    {
                        k: int(data[k])
                        for k in STEER_KNOBS
                        if data.get(k) is not None
                    }
                )
            else:
                # A steer can only follow the submit that admitted its
                # tenant — anything else in the stream is journal damage
                # or a spliced tail; skip it loudly.
                anomalies.append(
                    f"steer record #{rec.seq} targets uid {uid} with no "
                    f"live submit before it; skipped"
                )
    return {
        "live": live,
        "parked": sorted(parked, key=int),
        "completed": sorted(completed, key=int),
        "steers": steers,
        "idem": idem,
    }, anomalies


class ServiceDaemon:
    """Durable, SLO-aware lifecycle around an
    :class:`~evox_tpu_torch.service.OptimizationService` (the JAX
    package's parameters and semantics, plus ``device``).

    Usage::

        daemon = ServiceDaemon("svc_root", lanes_per_pack=64,
                               segment_steps=16, seed=0,
                               prewarm=[example_spec])
        daemon.start()                    # replay journal + pre-warm
        daemon.submit(TenantSpec("alice-1", PSO(...), Ackley(),
                                 n_steps=400))
        daemon.run()                      # drain; Preempted on SIGTERM
        # ... SIGKILL at ANY point above, then, in a fresh process:
        daemon = ServiceDaemon("svc_root", ...)   # same configuration
        daemon.start()                    # replays → same tenants, no
        daemon.run()                      # nvcc, bit-identical states

    :param root: daemon directory — the service root (tenant namespaces
        under ``tenants/``), the journal (``journal.jsonl``), and the
        executable cache (``exec_cache/``) all live under it; sharing it
        across processes/restarts IS the durability contract.
    :param classes: admission classes; default one ``"standard"`` class
        holding the whole ``max_queue``.  Budgets beyond ``max_queue``
        are still bounded by the service queue.
    :param device: where the daemon's tenants run and where a spec
        decoded from the journal is rebuilt (default the card,
        ``"cuda"``); pass ``"cpu"`` for a daemon on the host.
    :param exec_cache: ``True`` (default) builds the persistent cache at
        ``<root>/exec_cache``; an
        :class:`~evox_tpu_torch.utils.ExecutableCache` uses the caller's;
        ``False``/``None`` disables persistence (pre-warm still captures
        in-process).
    :param xla_cache: additionally point the process's bytecode cache at
        ``<root>/xla_cache`` (:func:`~evox_tpu_torch.utils.enable_xla_compilation_cache`),
        shared with the workers of :meth:`fleet_supervisor`.
    :param prewarm: the declared bucket grid — example
        :class:`~evox_tpu_torch.service.TenantSpec` instances (never admitted;
        shapes only) whose buckets :meth:`start` pre-warms so the first
        real tenant of each bucket never captures.
    :param brownout_threshold: queue-pressure fraction
        (``queued / max_queue``) at which the daemon stretches segment
        cadence; ``None`` disables brown-out.
    :param brownout_factor: cadence multiplier under brown-out (both
        cadences are pre-warmed).
    :param store: the :class:`~evox_tpu_torch.utils.CheckpointStore` shared by
        service checkpoints, journal, and executable cache
        (chaos-injectable).
    :param primary: whether this process owns the root (single-writer
        discipline, as in the fleet runner).  Non-primary daemons get a
        read-only store: journal appends raise (submissions belong on the
        primary), checkpoint/exec-cache writes are refused cleanly.
    :param preemption: as the service's — default ``True`` (the daemon
        exists to be supervised); :class:`Preempted` is journaled before
        it propagates.
    :param controller: optional
        :class:`~evox_tpu_torch.control.Controller` closing the loop over the
        daemon: brown-out entry/exit runs on the controller's journaled
        hysteresis instead of the ad-hoc flag check (the daemon's
        ``brownout_threshold`` stays the entry pressure unless the
        controller overrides it), shed thresholds are recomputed from
        the live measured segment cadence when the controller carries an
        ``slo_wait_seconds`` target, and the controller is handed down
        to the :class:`~evox_tpu_torch.service.OptimizationService` for
        per-tenant trend verdicts.  Every decision is appended to THIS
        daemon's request journal (kind ``"decision"``, advisory — a
        failed append warns, the decision still applies) unless the
        controller already carries its own journal; replay reproduces
        the decision sequence bit-for-bit from the journaled evidence
        (``tests/test_control.py``).  Decision records carry no ``uid``,
        so :meth:`start`'s tenant fold skips them by construction.
    :param slos: declarative service-level objectives — a sequence of
        :class:`~evox_tpu_torch.obs.SLO` (or a pre-built
        :class:`~evox_tpu_torch.obs.SLOTracker`).  The daemon feeds them live:
        round wall seconds score the latency objectives, per-running-
        tenant generation throughput the gen/s floors, and every
        admission/shed the availability objectives; burn-rate and
        error-budget gauges (``evox_slo_*``) publish each round.  When a
        ``controller`` is attached the tracker is handed to it (first
        binder wins): burn rates become the journaled evidence behind
        brown-out entry (``Controller(brownout_burn=)``) and exhausted
        budgets halve the class shed thresholds.
    :param endpoint: arm the live introspection endpoint
        (:class:`~evox_tpu_torch.obs.IntrospectionEndpoint`): an ``int`` binds
        that TCP port, ``True`` an OS-assigned one (``daemon.endpoint.url``
        after :meth:`start`).  Serves ``/metrics`` (fleet-aggregated
        when ``<root>/heartbeats`` carries beats, process-local
        otherwise), ``/healthz`` (non-200 on a dead/wedged/slow host
        verdict), ``/statusz`` (tenants, per-class queue depths,
        decision tail, exec-cache hit rates, SLO standings), and
        ``/flightz/<tenant_id>`` (the tenant's flight ring).  Read-only
        and fail-safe: a handler exception is a 500 response, never a
        touched serving path.
    :param endpoint_host: bind address (default loopback).
    :param fleet_dead_after: heartbeat staleness (seconds) after which
        the endpoint's fleet view declares a host dead (``/healthz``
        non-200, its ``/metrics`` series marked ``stale="true"``).
    :param service_kwargs: everything else
        (:class:`~evox_tpu_torch.service.OptimizationService` surface:
        ``health``, ``max_restarts``, ``checkpoint_every``,
        ``monitor_factory``, ``early_stop``, ``obs`` ...).
    """

    JOURNAL_NAME = "journal.jsonl"
    EXEC_CACHE_DIR = "exec_cache"
    XLA_CACHE_DIR = "xla_cache"

    def __init__(
        self,
        root: Union[str, Path],
        *,
        lanes_per_pack: int = 8,
        segment_steps: int = 16,
        max_queue: int = 256,
        seed: int = 0,
        classes: Sequence[TenantClass] | None = None,
        exec_cache: Union[ExecutableCache, bool, None] = True,
        xla_cache: bool = False,
        prewarm: Sequence[TenantSpec] = (),
        brownout_threshold: float | None = 0.75,
        brownout_factor: int = 2,
        store: CheckpointStore | None = None,
        primary: bool | None = None,
        preemption: Union[PreemptionGuard, bool, None] = True,
        on_event: Callable[[str], None] | None = None,
        controller: Any | None = None,
        slos: Any | None = None,
        endpoint: Union[int, bool, None] = None,
        endpoint_host: str = "127.0.0.1",
        fleet_dead_after: float = 5.0,
        compact_records: int | None = None,
        compact_bytes: int | None = None,
        max_replay_seconds: float | None = None,
        device: Union[torch.device, str, None] = None,
        **service_kwargs: Any,
    ):
        if brownout_factor < 1:
            raise ValueError(
                f"brownout_factor must be >= 1, got {brownout_factor}"
            )
        if brownout_threshold is not None and not (
            0.0 < brownout_threshold <= 1.0
        ):
            raise ValueError(
                f"brownout_threshold must be in (0, 1], got "
                f"{brownout_threshold}"
            )
        self.root = Path(root)
        self.device = torch.device("cuda" if device is None else device)
        if primary is None:
            from ..parallel import is_primary

            primary = is_primary()
        self.primary = bool(primary)
        if store is None:
            store = (
                CheckpointStore()
                if self.primary
                else ReadOnlyCheckpointStore("non-primary daemon process")
            )
        self.store = store
        self.segment_steps = int(segment_steps)
        self.brownout_threshold = (
            None if brownout_threshold is None else float(brownout_threshold)
        )
        self.brownout_factor = int(brownout_factor)
        self.on_event = on_event
        class_list = (
            list(classes)
            if classes is not None
            else [TenantClass("standard", int(max_queue))]
        )
        self.classes: dict[str, TenantClass] = {
            c.name: c for c in class_list
        }
        if len(self.classes) != len(class_list):
            raise ValueError("duplicate TenantClass names")
        self.prewarm_specs = list(prewarm)
        for name, value in (
            ("compact_records", compact_records),
            ("compact_bytes", compact_bytes),
            ("max_replay_seconds", max_replay_seconds),
        ):
            if value is not None and value <= 0:
                raise ValueError(f"{name} must be > 0, got {value}")
        self.compact_records = (
            None if compact_records is None else int(compact_records)
        )
        self.compact_bytes = (
            None if compact_bytes is None else int(compact_bytes)
        )
        self.max_replay_seconds = (
            None if max_replay_seconds is None else float(max_replay_seconds)
        )
        if controller is None and (
            self.compact_records is not None
            or self.compact_bytes is not None
            or self.max_replay_seconds is not None
        ):
            # Compaction decisions must be journaled + replayable like
            # every other control-plane action: arming a threshold
            # without a controller attaches a default one (the router's
            # precedent), inert for every unarmed plane.
            from ..control import Controller

            controller = Controller()
        self.controller = controller
        self.service = OptimizationService(
            self.root,
            lanes_per_pack=lanes_per_pack,
            segment_steps=segment_steps,
            max_queue=max_queue,
            seed=seed,
            preemption=preemption,
            store=store,
            on_event=on_event,
            controller=controller,
            **service_kwargs,
        )
        self._registry: MetricsRegistry | None = (
            self.service.obs.registry if self.service.obs is not None else None
        )
        self.journal = RequestJournal(
            self.root / self.JOURNAL_NAME,
            store=store,
            registry=self._registry,
        )
        if slos is None:
            self.slo: SLOTracker | None = None
        elif isinstance(slos, SLOTracker):
            self.slo = slos
        else:
            self.slo = SLOTracker(list(slos), registry=self._registry)
        if (
            controller is not None
            and self.slo is not None
            and getattr(controller, "slo", None) is None
        ):
            # The formalized objectives become the controller's journaled
            # brown-out / shed evidence (first binder wins).
            controller.slo = self.slo
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
        self.fleet_dead_after = float(fleet_dead_after)
        # A PRIVATE fleet registry (not the live process one): this
        # daemon's own series arrive through its own beat; merging them
        # into the process registry would double-count.  Constructed
        # eagerly — endpoint handler threads race a lazy build.
        self._aggregator = FleetAggregator()
        self._fleet_health: Any | None = None
        if controller is not None and controller.journal is None:
            # Decisions ride the daemon's own request journal (advisory
            # appends; the tenant fold skips uid-less records).  A
            # non-primary daemon's read-only store refuses the appends —
            # the controller warns once and keeps deciding in-memory.
            controller.journal = self.journal
        # Controller-driven tenant evictions must be journal-acked like
        # operator evictions (an acked evict parks on restart): route the
        # service's trend-eviction seam through the daemon's durable
        # evict.
        self.service.evict_hook = self.evict
        if exec_cache is True:
            exec_cache = ExecutableCache(
                self.root / self.EXEC_CACHE_DIR,
                store=store,
                on_event=on_event,
                registry=(
                    self.service.obs.registry
                    if self.service.obs is not None
                    else None
                ),
            )
        self.exec_cache: ExecutableCache | None = exec_cache or None
        self.xla_cache_enabled = bool(xla_cache) and (
            enable_xla_compilation_cache(self.root / self.XLA_CACHE_DIR)
        )
        self.stats = DaemonStats()
        self.started = False
        self.brownout = False
        # uids whose terminal "complete" record is already journaled.
        self._journaled_complete: set[int] = set()
        # class of each live tenant, by uid (replayed + submitted).
        self._class_by_uid: dict[int, str] = {}
        self._last_segment_seconds: float | None = None
        # Journaled-but-not-yet-applied steer knobs, by uid: acked by
        # :meth:`steer` (journal append BEFORE the ack, like submits) and
        # materialized onto the tenant record at the next boundary.
        self._pending_steer: dict[int, dict[str, int]] = {}
        # An attached network gateway registers itself here so /statusz
        # grows a "gateway" section (request / error / retry-after
        # counters, per-principal tenant counts).
        self.gateway: Any | None = None
        # An attached ChaosConductor registers itself the same way:
        # /statusz grows a "chaos" section (plan digest, injected-event
        # and violation counts for the live run).
        self.chaos: Any | None = None

    # -- events / metrics ---------------------------------------------------
    def _event(self, msg: str, *, warn: bool = False, **payload: Any) -> None:
        if self.service.obs is not None:
            self.service.obs.event(
                "daemon",
                msg,
                severity="warning" if warn else "info",
                **payload,
            )
        if self.on_event is not None:
            self.on_event(msg)
        elif warn:
            warnings.warn(msg)

    def _gauge(self, name: str, value: float, help: str = "", **labels: Any):
        if self.service.obs is not None:
            self.service.obs.gauge(name, help, **labels).set(value)

    def _inc(self, name: str, help: str = "", **labels: Any) -> None:
        if self.service.obs is not None:
            self.service.obs.counter(name, help, **labels).inc()

    # -- introspection endpoint providers (read-only, fail-safe) -------------
    # Every provider runs on an endpoint handler thread and must never
    # mutate serving state; snapshots are taken as list() copies so a
    # boundary mutating a dict mid-scrape cannot break iteration.
    def _fleet_beats(self) -> dict[int, dict[str, Any]]:
        hb = self.root / "heartbeats"
        if not hb.is_dir():
            return {}
        from ..parallel.multihost import read_heartbeats

        return read_heartbeats(hb)

    def _fleet_report(self, beats: dict[int, dict[str, Any]]) -> Any | None:
        if not beats:
            return None
        from ..parallel.multihost import FleetHealth

        world = max(beats) + 1
        if (
            self._fleet_health is None
            or self._fleet_health.num_processes != world
        ):
            # Every expected host here HAS beaten (the world is derived
            # from observed beats), so the start-grace path is inert.
            self._fleet_health = FleetHealth(
                self.root / "heartbeats",
                world,
                dead_after=self.fleet_dead_after,
            )
        return self._fleet_health.check()

    def _metrics_text(self) -> str:
        beats = self._fleet_beats()
        if beats:
            self._aggregator.update(beats, self._fleet_report(beats))
            return self._aggregator.to_prometheus()
        if self._registry is not None:
            return self._registry.to_prometheus()
        return MetricsRegistry().to_prometheus()  # header-only: obs is off

    def _healthz(self) -> tuple[bool, dict[str, Any]]:
        payload: dict[str, Any] = {
            "started": self.started,
            "brownout": self.brownout,
            "tenants": len(self.service._tenants),
            "queued": len(self.service._queue),
        }
        healthy = True
        beats = self._fleet_beats()
        report = self._fleet_report(beats)
        if report is not None:
            payload.update(report.to_json())
            healthy = report.healthy
        return healthy, payload

    def _statusz(self) -> dict[str, Any]:
        tenants: dict[str, Any] = {}
        counts: dict[str, int] = {}
        for tid, rec in list(self.service._tenants.items()):
            status = rec.status.value
            counts[status] = counts.get(status, 0) + 1
            tenants[tid] = {
                "status": status,
                "uid": rec.uid,
                "lane": rec.lane,
                "generations": rec.generations,
                "n_steps": int(rec.spec.n_steps),
                "class": self._class_by_uid.get(rec.uid, "standard"),
            }
        queue = {
            name: self._class_depth(name) for name in sorted(self.classes)
        }
        out: dict[str, Any] = {
            "schema": OBS_SCHEMA_VERSION,
            "time": time.time(),
            "started": self.started,
            "brownout": self.brownout,
            "segment_steps": self.service.segment_steps,
            "round_seconds": self._last_segment_seconds,
            "queue_depth": queue,
            "queue_budget": {
                name: c.queue_budget for name, c in sorted(self.classes.items())
            },
            "tenants": tenants,
            "tenant_counts": counts,
            "stats": {
                "segments_run": self.service.stats.segments_run,
                "submitted": self.service.stats.submitted,
                "admitted": self.service.stats.admitted,
                "completed": self.service.stats.completed,
                "rejections": len(self.service.stats.rejections),
                "restarts": self.service.stats.restarts,
                "quarantines": self.service.stats.quarantines,
                "sheds": self.stats.sheds,
                "brownout_entries": self.stats.brownout_entries,
                "replayed_tenants": self.stats.replayed_tenants,
                "journal_append_failures": self.stats.journal_append_failures,
                "steers_pending": len(self._pending_steer),
            },
        }
        out["journal"] = self._journal_statusz()
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
        if self.exec_cache is not None:
            from ..ops import _build

            cache = self.exec_cache.stats
            hits = int(getattr(cache, "hits", 0))
            misses = int(getattr(cache, "misses", 0))
            out["exec_cache"] = {
                "hits": hits,
                "misses": misses,
                "hit_rate": (
                    hits / (hits + misses) if (hits + misses) else None
                ),
                "quarantines": int(getattr(cache, "quarantines", 0)),
                # A hit still captures: the captures and the process's
                # kernel builds stand beside the hits.
                "captures": dict(self.stats.captures),
                "kernel_builds": dict(_build.counts),
            }
        if self.controller is not None:
            # The decision-journal tail: newest last, manifests only —
            # a READ of the controller's record, never a consult (a
            # scrape must not mint decisions).
            out["decisions"] = [
                d.to_manifest()
                for d in list(self.controller.decisions)[-20:]
            ]
        if self.slo is not None:
            out["slo"] = self.slo.describe()
        return out

    def _journal_statusz(self) -> dict[str, Any]:
        """The journal/recovery strip: growth, snapshot anchoring, last
        measured recovery time, and the compaction decision tail —
        everything ``evoxtop`` renders and the ``--max-snapshot-age``
        probe bounds."""
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
            "replay_seconds": self.stats.replay_seconds,
            "compactions": self.stats.compactions,
            "compaction_failures": self.stats.compaction_failures,
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

    def _flight_window(self, tenant_id: str) -> list[dict[str, float]] | None:
        record = self.service._tenants.get(tenant_id)
        if record is not None and record.flight is not None:
            return record.flight.rows()
        obs = self.service.obs
        if (
            record is None
            and obs is not None
            and obs.flight is not None
            and tenant_id == "__service__"
        ):
            return obs.flight.rows()
        return None

    def _slo_admission(self, tenant_class: str, accepted: bool) -> None:
        if self.slo is not None:
            self.slo.record(
                SIGNAL_ADMISSION, accepted, tenant_class=tenant_class
            )
            self.slo.publish()

    # -- journal ------------------------------------------------------------
    def _journal(self, kind: str, *, required: bool, **data: Any) -> bool:
        """Append one lifecycle record.  ``required=True`` (the ack path:
        submits) propagates failure as :class:`JournalError`; advisory
        records (completions — reconstructible from namespaces) warn and
        continue."""
        try:
            self.journal.append(kind, **data)
        except JournalError as e:
            self.stats.journal_append_failures += 1
            if required:
                raise
            self._event(
                f"journal append of advisory {kind!r} record failed ({e}); "
                f"state stays reconstructible from checkpoint namespaces",
                warn=True,
            )
            return False
        self._inc(
            "evox_daemon_journal_records_total",
            "Journal records durably appended, by kind.",
            kind=kind,
        )
        return True

    # -- start / replay ------------------------------------------------------
    def start(self) -> int:
        """Replay the journal (repairing any damaged tail), resubmit every
        live tenant, and pre-warm the declared bucket grid plus every
        replayed bucket.  Returns the number of tenants restored.
        Idempotent."""
        if self.started:
            return 0
        self.started = True
        if self.endpoint is not None and not self.endpoint.started:
            self.endpoint.start()
            self._event(
                f"introspection endpoint serving at {self.endpoint.url} "
                f"(/metrics /healthz /statusz /flightz/<tenant_id>)"
            )
        t_replay = time.perf_counter()
        records, damage = self.journal.replay(quarantine=self.primary)
        for note in self.journal.replay_notes:
            # Snapshot-fallback recovery anomalies: the loudness
            # contract — an operator must see every degraded path taken.
            self._inc(
                "evox_daemon_snapshot_fallbacks_total",
                "Degraded recovery paths taken at replay (snapshot "
                "fallback, restored swap, gap warnings).",
            )
            self._event(f"journal recovery: {note}", warn=True)
        if damage is not None:
            self.stats.journal_damage.append(damage.reason)
            self._inc(
                "evox_daemon_journal_tail_quarantines_total",
                "Damaged journal tails quarantined at replay.",
            )
            self._event(
                f"journal replay: damaged tail at byte {damage.offset} "
                f"({damage.reason}); {damage.bytes_quarantined} bytes "
                + (
                    f"quarantined to {damage.quarantine_path.name}"
                    if damage.quarantine_path is not None
                    else "could not be quarantined"
                )
                + ("; journal repaired" if damage.truncated else ""),
                warn=True,
            )
        self.stats.replayed_records = len(records)
        base = self.journal.snapshot_state
        if base is not None:
            self._event(
                f"journal replay anchored at snapshot seq "
                f"{self.journal.snapshot_seq} "
                f"({len(records)} suffix records to fold)"
            )
        # Fold the snapshot base + record suffix into per-uid final
        # lifecycle state (at-least-once: duplicates collapse, last
        # state wins) — the same pure fold compaction snapshots through,
        # so both cold-start paths compute identical state.
        state, anomalies = fold_daemon_records(records, base=base)
        for msg in anomalies:
            self._event(f"journal replay: {msg}", warn=True)
        live: dict[int, dict[str, Any]] = {
            int(u): d for u, d in state["live"].items()
        }
        parked: set[int] = {int(u) for u in state["parked"]}
        steers: dict[int, dict[str, int]] = {
            int(u): dict(k) for u, k in state["steers"].items()
        }
        self._journaled_complete.update(int(u) for u in state["completed"])
        restored = 0
        if live:
            # Replay must never bounce off the queue bound the journal
            # itself admitted through.
            original_bound = self.service.max_queue
            self.service.max_queue = max(original_bound, len(live))
            try:
                for uid in sorted(live):
                    data = live[uid]
                    try:
                        spec = _decode_spec(data["spec"], self.device)
                    except Exception as e:  # noqa: BLE001 - evidence > crash
                        self._event(
                            f"journal replay: tenant uid {uid} "
                            f"({data.get('tenant_id')!r}) has an "
                            f"undecodable spec ({type(e).__name__}: {e}); "
                            f"skipped — its namespace remains on disk",
                            warn=True,
                        )
                        continue
                    # Pin the journaled uid; every other field (workload,
                    # growth ladder, solution transform, budget) replays
                    # exactly as submitted.
                    spec = dataclass_replace(spec, uid=uid)
                    # Acked steers materialize BEFORE resubmission: a
                    # budget raised past a journaled completion must
                    # resume the tenant instead of re-materializing the
                    # stale final result.  (Live semantics are "at the
                    # next boundary"; for a steer acked but unapplied at
                    # the kill, resubmission IS the next boundary.)
                    knobs = steers.get(uid, {})
                    if "n_steps" in knobs:
                        spec = dataclass_replace(
                            spec, n_steps=knobs["n_steps"]
                        )
                    try:
                        record = self.service.submit(spec)
                    except AdmissionError as e:
                        self._event(
                            f"journal replay: resubmission of "
                            f"{spec.tenant_id!r} refused ({e.reason}); "
                            f"skipped",
                            warn=True,
                        )
                        continue
                    self._class_by_uid[uid] = data.get("class", "standard")
                    record.steer.update(
                        {
                            k: v
                            for k, v in knobs.items()
                            if k in ("checkpoint_every", "max_restarts")
                        }
                    )
                    restored += 1
                    if uid in parked:
                        # Operator-evicted: journaled intent is "off the
                        # lane until readmitted" — withdraw from the queue
                        # but keep the record (status EVICTED, resumable).
                        self.service.withdraw(
                            spec.tenant_id, to_status=TenantStatus.EVICTED
                        )
            finally:
                self.service.max_queue = original_bound
        self.stats.replayed_tenants = restored
        # The recovery-time SLO signal: replay + fold + resubmission
        # (pre-warm is excluded — capture cost is the exec cache's
        # budget, not the journal's).
        self.stats.replay_seconds = time.perf_counter() - t_replay
        self._gauge(
            "evox_recovery_replay_seconds",
            self.stats.replay_seconds,
            "Wall seconds of the last cold-start recovery (journal "
            "replay + fold + tenant resubmission).",
        )
        if self.slo is not None:
            self.slo.observe(SIGNAL_RECOVERY, self.stats.replay_seconds)
            self.slo.publish()
        self._journal_gauges()
        if restored:
            self._inc(
                "evox_daemon_replayed_tenants_total",
                "Tenants restored from the journal at start.",
            )
            self._event(
                f"replayed {len(records)} journal records; restored "
                f"{restored} tenants "
                f"({self.stats.replay_seconds:.3f}s recovery)"
            )
        self._count_captures()
        # Pre-warm: the declared grid, then every bucket the replay
        # queued (restored tenants must not pay a capture either).
        for spec in self.prewarm_specs:
            self._prewarm_bucket(spec)
        for tenant_id in list(self.service._queue):
            self._prewarm_bucket(self.service.tenant(tenant_id).spec)
        return restored

    def _prewarm_bucket(self, spec: TenantSpec) -> None:
        """Capture (after a cache load) one bucket's programs for both the
        normal and brown-out cadences."""
        bucket = self.service._bucket_for(spec)
        label = _bucket_label(bucket.key)
        lengths = {self.segment_steps}
        if self._brownout_enter() is not None and self.brownout_factor > 1:
            lengths.add(self.segment_steps * self.brownout_factor)
        if {"init", *lengths} <= set(bucket.pack._from_cache):
            return
        example = self.service._fresh_state(
            bucket, TenantRecord(spec=spec, uid=0)
        )
        t0 = time.perf_counter()
        results = bucket.pack.prewarm(
            example,
            sorted(lengths),
            cache=self.exec_cache,
            label=label,
        )
        self.stats.prewarmed.update(results)
        self._count_captures()
        hits = sum(results.values())
        if hits:
            self._inc(
                "evox_daemon_prewarm_programs_total",
                "Programs pre-warmed, by source.",
                source="cache",
            )
        self._event(
            f"pre-warmed bucket {label}: {hits}/{len(results)} programs "
            f"from cache ({time.perf_counter() - t0:.2f}s)"
        )

    def _count_captures(self) -> None:
        for kind in self.stats.captures:
            self.stats.captures[kind] = sum(
                b.pack.captures[kind] for b in list(self.service._buckets.values())
            )

    # -- admission ----------------------------------------------------------
    def submit(
        self,
        spec: TenantSpec,
        *,
        tenant_class: str = "standard",
        journal_extra: dict[str, Any] | None = None,
    ) -> "TenantRecord":
        """Admit one tenant durably: SLO admission control, then the
        service's queue, then the journal — the record is fsync'd before
        this returns (the ack).  Raises :class:`AdmissionError` with a
        structured reason (and ``retry_after_segments`` /
        measured-cadence ``retry_after_seconds`` hints for overload
        sheds) when refused.

        ``journal_extra`` rides extra fields on the journaled submit
        record (the gateway's idempotency key and principal — replay
        rebuilds its exactly-once dedup map from them); keys must not
        collide with the record's own fields."""
        self.start()
        cls = self.classes.get(tenant_class)
        if cls is None:
            self.service._reject(
                spec,
                "unknown-class",
                f"tenant class {tenant_class!r} is not declared "
                f"(have {sorted(self.classes)})",
            )
        existing = self.service._tenants.get(spec.tenant_id)
        readmission = existing is not None and existing.status in (
            TenantStatus.EVICTED,
            TenantStatus.QUARANTINED,
        )
        if existing is not None and not readmission:
            # A duplicate of a QUEUED/RUNNING/COMPLETED id is a
            # non-retryable collision — it must NOT be masked by a
            # retryable "shed" (a client honoring the retry hint would
            # wait and re-collide forever); let the service's own
            # validation reject it with the truthful reason.
            self.service.submit(spec)
            raise AssertionError("collision must have been rejected")
        if cls.sheddable:
            budget = self._effective_budget(cls)
            if self._class_depth(cls.name) >= budget:
                self._shed(spec, cls, budget)
        record = self.service.submit(spec)
        try:
            self._journal(
                "submit",
                required=True,
                tenant_id=spec.tenant_id,
                uid=record.uid,
                n_steps=int(spec.n_steps),
                **{"class": cls.name},
                spec=_encode_spec(spec),
                **(journal_extra or {}),
            )
        except JournalError as e:
            # Un-admit: an un-journaled tenant must not run (a crash
            # would silently lose it after the caller's ack).  A failed
            # READMISSION parks the pre-existing record instead of
            # dropping it — its journaled history (and namespace) must
            # keep describing a real tenant.
            self.service.withdraw(
                spec.tenant_id,
                to_status=TenantStatus.EVICTED if readmission else None,
            )
            self._slo_admission(cls.name, False)
            self.service._reject(
                spec,
                "journal-failed",
                f"the admission record could not be made durable ({e})",
                retry_after_segments=1,
                retry_after_seconds=retry_after_seconds(
                    1, self._last_segment_seconds
                ),
            )
        self._journaled_complete.discard(record.uid)
        self._class_by_uid[record.uid] = cls.name
        # A (re)submit supersedes earlier steering: the fresh spec carries
        # the caller's current intent (mirrors the replay fold).
        self._pending_steer.pop(record.uid, None)
        record.steer.clear()
        self._slo_admission(cls.name, True)
        self._gauge(
            "evox_daemon_queue_depth",
            self._class_depth(cls.name),
            "Queued tenants per admission class.",
            **{"class": cls.name},
        )
        self._prewarm_bucket(spec)
        return record

    def _class_depth(self, name: str) -> int:
        """Queued tenants of one class (unregistered uids — pre-daemon
        journal rows — count as ``standard``).  Snapshot-safe: also
        called from endpoint handler threads mid-boundary, so the queue
        is copied and a tenant withdrawn between the copy and the lookup
        is simply skipped."""
        count = 0
        for tid in list(self.service._queue):
            record = self.service._tenants.get(tid)
            if record is None:
                continue
            if self._class_by_uid.get(record.uid, "standard") == name:
                count += 1
        return count

    def _retry_after(self, cls: TenantClass) -> int:
        """Segments until a retry plausibly lands: the nearest running
        completion, plus how many whole-pack drains the class's queue
        depth represents (fed by the live scheduler state the
        ``evox_service_*`` gauges export)."""
        base = self.service.retry_hint_segments()
        ahead = self._class_depth(cls.name)
        lanes = max(1, self.service.lanes_per_pack)
        return base + ahead // lanes

    def _effective_budget(self, cls: TenantClass) -> int:
        """The class's live queue budget: the configured bound,
        tightened by the controller's SLO-aware shed threshold when one
        is armed (``slo_wait_seconds`` on the controller, fed by the
        measured segment cadence).  A changed effective budget is one
        journaled ``shed-threshold`` decision."""
        if self.controller is None or (
            self.controller.slo_wait_seconds is None
            and getattr(self.controller, "slo", None) is None
        ):
            return cls.queue_budget
        return self.controller.shed_threshold(
            queue_budget=cls.queue_budget,
            segment_seconds=self._last_segment_seconds,
            lanes=self.service.lanes_per_pack,
            tenant_class=cls.name,
            generation=self.service.stats.segments_run,
        )

    def _shed(
        self, spec: TenantSpec, cls: TenantClass, budget: int | None = None
    ) -> None:
        budget = cls.queue_budget if budget is None else budget
        hint = self._retry_after(cls)
        wall = retry_after_seconds(hint, self._last_segment_seconds)
        self.stats.sheds += 1
        self._slo_admission(cls.name, False)
        self._inc(
            "evox_daemon_sheds_total",
            "Submissions shed at a class budget, by class.",
            **{"class": cls.name},
        )
        seconds = (
            f" (~{wall:.1f}s at the current segment cadence)"
            if wall is not None
            else ""
        )
        tightened = (
            f" (tightened from {cls.queue_budget} by the controller's "
            f"SLO target)"
            if budget != cls.queue_budget
            else ""
        )
        self.service._reject(
            spec,
            "shed",
            f"class {cls.name!r} is at its queue budget "
            f"({budget}{tightened}); retry after ~{hint} segment "
            f"boundaries{seconds}",
            retry_after_segments=hint,
            retry_after_seconds=wall,
        )

    # -- brown-out ----------------------------------------------------------
    def _queue_pressure(self) -> float:
        bound = max(1, self.service.max_queue)
        return len(self.service._queue) / bound

    def _brownout_enter(self) -> float | None:
        """The live brown-out entry pressure: the controller's
        ``brownout_enter`` override when set — an armed controller plane
        must not be silently dead just because the daemon's own
        threshold is ``None`` — else the daemon's configured
        ``brownout_threshold``."""
        if (
            self.controller is not None
            and self.controller.brownout_enter is not None
        ):
            return self.controller.brownout_enter
        return self.brownout_threshold

    def _update_brownout(self) -> None:
        enter = self._brownout_enter()
        if enter is None or self.brownout_factor == 1:
            return
        pressure = self._queue_pressure()
        if self.controller is not None:
            # Controller hysteresis: the transition is a journaled
            # decision (enter/exit thresholds in the evidence), the
            # cadence change below is the act half.  Exception-guarded
            # inside the controller — a failure decides "hold" and the
            # cadence stays where it is.
            action = self.controller.brownout(
                pressure=pressure,
                active=self.brownout,
                enter=self.brownout_threshold,
                generation=self.service.stats.segments_run,
            )
            transition = (action == "enter", action == "exit")
        else:
            transition = (
                not self.brownout and pressure >= enter,
                self.brownout and pressure <= enter / 2,
            )
        if transition[0]:
            self.brownout = True
            self.stats.brownout_entries += 1
            self.service.segment_steps = (
                self.segment_steps * self.brownout_factor
            )
            self._inc(
                "evox_daemon_brownout_entries_total",
                "Times the daemon stretched segment cadence under load.",
            )
            self._event(
                f"brown-out: queue pressure {pressure:.2f} >= {enter}; "
                f"segment cadence stretched "
                f"{self.segment_steps} -> {self.service.segment_steps} "
                f"(pre-warmed — no capture)",
                warn=True,
            )
        elif transition[1]:
            self.brownout = False
            self.stats.brownout_exits += 1
            self.service.segment_steps = self.segment_steps
            self._event(
                f"brown-out over: queue pressure {pressure:.2f}; segment "
                f"cadence restored to {self.segment_steps}"
            )
        self._gauge(
            "evox_daemon_brownout",
            1.0 if self.brownout else 0.0,
            "Whether the daemon is in brown-out (stretched cadence).",
        )

    # -- lifecycle ----------------------------------------------------------
    def step(self) -> bool:
        """One supervised scheduling round: acked steers materialized,
        brown-out check, one service round, then journal the round's
        completions.  :class:`Preempted` is journaled before it
        propagates."""
        self.start()
        self._apply_steers()
        self._update_brownout()
        t0 = time.perf_counter()
        try:
            progressed = self.service.step()
        except Preempted:
            self._journal("preempt", required=False)
            raise
        if progressed:
            self._last_segment_seconds = time.perf_counter() - t0
            self._gauge(
                "evox_daemon_round_seconds",
                self._last_segment_seconds,
                "Wall seconds of the last scheduling round.",
            )
            self._observe_slos(self._last_segment_seconds)
        self._count_captures()
        self._journal_completions()
        self._maybe_compact()
        return progressed

    # -- compaction ---------------------------------------------------------
    def _journal_gauges(self) -> None:
        """Publish the journal-growth gauges the compaction SLO watches."""
        self._gauge(
            "evox_journal_bytes",
            self.journal.size_bytes,
            "Journal file size in bytes.",
        )
        self._gauge(
            "evox_journal_records",
            self.journal.records_since_snapshot,
            "Journal records since the last snapshot anchor (the whole "
            "history when never compacted) — cold-start replay folds "
            "exactly this many.",
        )
        if self.journal.snapshot_at is not None:
            self._gauge(
                "evox_journal_snapshot_age_seconds",
                max(0.0, time.time() - self.journal.snapshot_at),
                "Seconds since the journal's last snapshot was taken.",
            )

    def _compaction_armed(self) -> bool:
        return (
            self.compact_records is not None
            or self.compact_bytes is not None
            or self.max_replay_seconds is not None
        )

    def _maybe_compact(self) -> None:
        """Boundary-time journal compaction: journal-growth evidence →
        the pure journaled ``compact`` decider (quiet-windowed,
        replayable bit-for-bit) → the crash-safe snapshot/swap protocol.
        Never raises — a refused or failed compaction warns and serving
        continues on the (always-correct) uncompacted journal."""
        self._journal_gauges()
        if (
            not self.primary
            or self.controller is None
            or not self._compaction_armed()
        ):
            return
        evidence = {
            "journal_bytes": self.journal.size_bytes,
            "journal_records": self.journal.records_since_snapshot,
            "live_tenants": len(self.service._tenants),
            "replay_seconds": self.stats.replay_seconds,
            "compact_records": self.compact_records,
            "compact_bytes": self.compact_bytes,
            "max_replay_seconds": self.max_replay_seconds,
        }
        action = self.controller.compact(
            evidence=evidence, generation=self.service.stats.segments_run
        )
        if action == "compact":
            self._compact_journal()

    def _compact_journal(self) -> None:
        """One crash-safe compaction through the journal's protocol,
        folding with the same pure fold replay uses."""

        def fold(
            base: dict[str, Any] | None, records: list[Any]
        ) -> dict[str, Any]:
            state, _anomalies = fold_daemon_records(records, base=base)
            return state

        t0 = time.perf_counter()
        try:
            result = self.journal.compact(fold)
        except JournalError as e:
            self.stats.compaction_failures += 1
            self._inc(
                "evox_daemon_compaction_failures_total",
                "Journal compactions that failed (serving continued on "
                "the uncompacted journal).",
            )
            self._event(f"journal compaction failed ({e})", warn=True)
            return
        self.stats.compactions += 1
        self._inc(
            "evox_daemon_compactions_total",
            "Successful journal compactions.",
        )
        self._journal_gauges()
        self._event(
            f"journal compacted at seq {result.seq}: "
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

    def _observe_slos(self, round_seconds: float) -> None:
        """Score one scheduling round against the declared objectives:
        round wall seconds against every class's latency SLO, and the
        realized per-tenant generation rate against each running
        tenant's class throughput floor."""
        if self.slo is None:
            return
        for name in self.classes:
            self.slo.observe(
                SIGNAL_SEGMENT_SECONDS, round_seconds, tenant_class=name
            )
        if round_seconds > 0:
            gens_per_sec = self.service.segment_steps / round_seconds
            running: dict[str, int] = {}
            for rec in list(self.service._tenants.values()):
                if rec.status is TenantStatus.RUNNING:
                    cls = self._class_by_uid.get(rec.uid, "standard")
                    running[cls] = running.get(cls, 0) + 1
            for cls, n in running.items():
                self.slo.observe(
                    SIGNAL_TENANT_GENS,
                    gens_per_sec,
                    tenant_class=cls,
                    n=n,
                )
        self.slo.publish()

    def _journal_completions(self) -> None:
        for record in self.service._tenants.values():
            if (
                record.status is TenantStatus.COMPLETED
                and record.uid not in self._journaled_complete
            ):
                if self._journal(
                    "complete",
                    required=False,
                    tenant_id=record.spec.tenant_id,
                    uid=record.uid,
                    generations=record.generations,
                ):
                    self._journaled_complete.add(record.uid)

    def run(self, max_rounds: int | None = None) -> None:
        """Drain the service under the daemon's lifecycle (preemption
        guard installed for the duration, rounds journaled).  Mirrors
        :meth:`OptimizationService.run` semantics."""
        self.start()
        guard = self.service.preemption
        installed = False
        if guard is not None:
            if self.service._owns_guard:
                guard.reset()
            if not guard.installed:
                guard.install()
                installed = True
        try:
            rounds = 0
            while True:
                if max_rounds is not None and rounds >= max_rounds:
                    return
                progressed = self.step()
                rounds += 1
                if not progressed:
                    return
        finally:
            if installed:
                guard.uninstall()
            self.journal.close()

    def steer(
        self,
        tenant_id: str,
        *,
        n_steps: int | None = None,
        checkpoint_every: int | None = None,
        max_restarts: int | None = None,
        journal_extra: dict[str, Any] | None = None,
    ) -> dict[str, int]:
        """Adjust one live tenant's scheduling knobs **durably**: the
        generation budget (``n_steps`` — raise to extend a promising run,
        lower to wind one down at the next boundary), the checkpoint
        cadence, and the per-tenant restart budget.  The ``steer`` record
        is journaled BEFORE this returns (the ack — same crash-safety
        contract as submits), and the knobs materialize at the **next
        segment boundary**; a daemon killed between the ack and the
        boundary replays the steer at restart, so an acked steer is never
        lost.  Values only — steering never touches lane state, which is
        why a steered, killed, and restarted run stays bit-identical to a
        steered uninterrupted one.

        Knobs are validated before the journal write (a doomed call
        leaves no record): ``n_steps >= 1``, ``checkpoint_every >= 1``,
        ``max_restarts >= 0``, at least one knob set.  Raises
        ``KeyError`` for unknown tenants (a steer can only follow the
        submit that admitted its tenant — the journal replay enforces
        the same ordering) and ``RuntimeError`` for COMPLETED ones.
        Returns the accepted knob dict.  A later (re)submit of the same
        tenant supersedes pending steering."""
        self.start()
        record = self.service.tenant(tenant_id)
        knobs: dict[str, int] = {}
        for name, value, floor in (
            ("n_steps", n_steps, 1),
            ("checkpoint_every", checkpoint_every, 1),
            ("max_restarts", max_restarts, 0),
        ):
            if value is None:
                continue
            value = int(value)
            if value < floor:
                raise ValueError(
                    f"steer {name} must be >= {floor}, got {value}"
                )
            knobs[name] = value
        if not knobs:
            raise ValueError(
                f"steer of {tenant_id!r} adjusts nothing (set at least "
                f"one of {', '.join(STEER_KNOBS)})"
            )
        if record.status is TenantStatus.COMPLETED:
            raise RuntimeError(
                f"tenant {tenant_id!r} is completed; resubmit it (with a "
                f"refreshed budget) instead of steering"
            )
        self._journal(
            "steer",
            required=True,
            tenant_id=tenant_id,
            uid=record.uid,
            **knobs,
            **(journal_extra or {}),
        )
        self._pending_steer.setdefault(record.uid, {}).update(knobs)
        self._event(
            f"steer acked for tenant {tenant_id!r} (uid {record.uid}): "
            + ", ".join(f"{k}={v}" for k, v in sorted(knobs.items()))
            + " — applies at the next segment boundary"
        )
        return knobs

    def _apply_steers(self) -> None:
        """Materialize acked steer knobs onto their tenant records — the
        boundary half of :meth:`steer` (runs at the top of every
        :meth:`step`, before the service round, so admission and verdict
        logic in the round already sees the steered values)."""
        if not self._pending_steer:
            return
        for uid, knobs in list(self._pending_steer.items()):
            record = self.service._tenants_by_uid.get(uid)
            del self._pending_steer[uid]
            if record is None:  # retired between ack and boundary
                continue
            if "n_steps" in knobs:
                record.spec = dataclass_replace(
                    record.spec, n_steps=knobs["n_steps"]
                )
                # A raised budget re-arms a completion record exactly
                # like the readmission path would.
                if knobs["n_steps"] > record.generations:
                    self._journaled_complete.discard(uid)
            record.steer.update(
                {
                    k: v
                    for k, v in knobs.items()
                    if k in ("checkpoint_every", "max_restarts")
                }
            )
            self._inc(
                "evox_daemon_steers_applied_total",
                "Journaled steer records materialized at a boundary.",
            )
            self._event(
                f"steer applied to tenant {record.spec.tenant_id!r}: "
                + ", ".join(f"{k}={v}" for k, v in sorted(knobs.items()))
            )

    def park(self, tenant_id: str) -> str:
        """Withdraw a tenant from service durably, whatever its phase:
        a RUNNING tenant is evicted (checkpoint + lane freed — exactly
        :meth:`evict`), a QUEUED one is withdrawn from the admission
        queue to the same parked EVICTED status; both journal the same
        ``evict`` record BEFORE mutating, so restart replay parks the
        tenant either way.  The gateway's ``DELETE`` maps here.  Returns
        the resulting status string; raises ``KeyError`` for unknown
        tenants and ``RuntimeError`` for tenants already off a lane
        (COMPLETED/EVICTED/QUARANTINED — nothing to withdraw)."""
        self.start()
        record = self.service.tenant(tenant_id)
        if record.status is TenantStatus.RUNNING:
            self.evict(tenant_id)
            return record.status.value
        if record.status is not TenantStatus.QUEUED:
            raise RuntimeError(
                f"tenant {tenant_id!r} is {record.status.value} and holds "
                f"no lane or queue slot; forget it to retire the record"
            )
        self._journal(
            "evict", required=True, tenant_id=tenant_id, uid=record.uid
        )
        self.service.withdraw(tenant_id, to_status=TenantStatus.EVICTED)
        return record.status.value

    def evict(self, tenant_id: str) -> None:
        """Checkpoint + free a tenant's lane, durably.  The record is
        journaled BEFORE the service mutates (``required=True``) — an
        acked eviction must park on restart, never silently resume; a
        crash between the record and the lane surgery merely parks the
        tenant at its last boundary checkpoint (at-least-once)."""
        self.start()
        record = self.service.tenant(tenant_id)
        if record.lane is None:
            # Same precondition service.evict enforces — validated before
            # the journal write so a doomed call leaves no record.
            raise RuntimeError(
                f"tenant {tenant_id!r} is {record.status.value} and holds "
                f"no lane"
            )
        self._journal(
            "evict", required=True, tenant_id=tenant_id, uid=record.uid
        )
        self.service.evict(tenant_id)

    def forget(self, tenant_id: str) -> None:
        """Retire a tenant's record durably AND reclaim its disk: the
        ``retire`` record is journaled BEFORE anything mutates (an acked
        retirement must not resurrect on restart), and only once that
        successor is durable does the service GC the tenant's checkpoint
        namespace and flight dir (the durable-successor rule — a crash
        between the record and the GC leaves orphan files a later forget
        or restart re-reaps, never a journaled tenant without its
        data)."""
        self.start()
        record = self.service._tenants.get(tenant_id)
        if record is None:
            return
        if record.status in (TenantStatus.QUEUED, TenantStatus.RUNNING):
            # Same precondition service.forget enforces — validated before
            # the journal write so a doomed call leaves no record.
            raise RuntimeError(
                f"tenant {tenant_id!r} is {record.status.value}; evict it "
                f"before forgetting"
            )
        self._journal(
            "retire", required=True, tenant_id=tenant_id, uid=record.uid
        )
        self.service.forget(tenant_id, purge=self.primary)
        self._journaled_complete.discard(record.uid)
        self._class_by_uid.pop(record.uid, None)

    def result(self, tenant_id: str):
        return self.service.result(tenant_id)

    def tenant(self, tenant_id: str) -> "TenantRecord":
        return self.service.tenant(tenant_id)

    def close(self) -> None:
        if self.endpoint is not None:
            self.endpoint.stop()
        self.journal.close()

    # -- fleet --------------------------------------------------------------
    def fleet_supervisor(
        self,
        command: Callable[..., Sequence[str]],
        num_processes: int,
        **kwargs: Any,
    ):
        """A :class:`~evox_tpu_torch.resilience.FleetSupervisor` over daemon
        workers sharing this root.  ``command`` maps a ``WorkerSpec`` to
        the argv of one daemon process (the worker constructs a
        ``ServiceDaemon`` over the same root and calls :meth:`run`).

        Host loss becomes tenant migration for free: the relaunched
        worker replays the shared journal, resumes every tenant's
        namespace checkpoints, and loads the shared executable cache —
        the surviving fleet carries every tenant forward with zero lost
        acknowledged work and no kernel build.  With ``xla_cache`` the
        workers' environment names the daemon's bytecode cache
        (``PYTHONPYCACHEPREFIX``)."""
        from ..resilience.fleet import FleetSupervisor

        kwargs.setdefault("heartbeat_dir", self.root / "heartbeats")
        if self.xla_cache_enabled and "env" not in kwargs:
            # The workers compile each imported module once, into the
            # daemon's shared bytecode cache.
            env = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
            env["PYTHONPYCACHEPREFIX"] = str((self.root / self.XLA_CACHE_DIR).resolve())
            kwargs["env"] = env
        return FleetSupervisor(
            command,
            num_processes,
            checkpoint_dir=self.root,
            **kwargs,
        )
