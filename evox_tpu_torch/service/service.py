"""The multi-tenant optimization service: admission, scheduling, isolation
(counterpart of ``evox_tpu/service/service.py``).

:class:`OptimizationService` is the serving layer over
:class:`~evox_tpu_torch.service.TenantPack`: users :meth:`submit`
independent optimization runs (:class:`~evox_tpu_torch.service.TenantSpec`),
the service buckets them by program identity, packs each bucket's tenants
into one vmapped segment (one captured CUDA graph on the card), and
advances every pack segment by segment, each tenant with the run-level
guarantees scoped to it:

* **random-stream isolation** — tenant streams fold the stable uid into
  the service key (identity-keyed, never lane-keyed);
* **telemetry isolation** — each tenant owns an
  :class:`~evox_tpu_torch.workflows.EvalMonitor` fed by the per-lane demux
  of the pack's telemetry (``ingest_sinks(lane=...)``), entry for entry
  what a solo run records;
* **health isolation** — per-lane verdicts from a lane-aware
  :class:`~evox_tpu_torch.resilience.HealthProbe` (windows keyed by uid),
  with a per-tenant restart budget (rollback to the tenant's newest
  checkpoint, keys perturbed by restart index) and lane quarantine once the
  budget is spent;
* **checkpoint isolation** — every tenant has its own namespace directory
  under the service root (``tenants/<tenant_id>/``), written with the
  self-verifying archives through the
  :class:`~evox_tpu_torch.utils.CheckpointStore`; eviction and readmission
  resume bit-identically, and the resume scan reads manifests only (full
  digest verification runs on the archive selected);
* **preemption** — a tripped
  :class:`~evox_tpu_torch.resilience.PreemptionGuard` emergency-checkpoints
  EVERY running tenant's namespace at the boundary and raises
  :class:`~evox_tpu_torch.resilience.Preempted`; a fresh service resumes
  them all.

**Overload is loud.**  The waiting queue is bounded: a submission past
``max_queue`` raises :class:`AdmissionError` with a structured reason.

**Boundaries are the only scheduling points.**  Admission, retirement,
eviction, verdicts, restarts and checkpoints all happen between segments;
generation budgets are quantized up to whole segments, identically for
every tenant, so a tenant's trajectory is a pure function of (spec, uid,
service configuration) — never of its cotenants.

**The HPO workload.**  A ``TenantSpec(workload="hpo")`` tenant's problem is
(or wraps) a :class:`~evox_tpu_torch.hpo.NestedProblem`: its evaluation, one
or two levels of ``torch.func.vmap`` over inner runs, runs inline inside
the pack's lane vmap and its captured graph, and the kernels' batching
rules merge every level into one launch for the whole pack.  The boundary
counts ``evox_hpo_inner_generations_total`` per tenant, and with ``grow=``
and a controller a stagnating inner ladder fires a journaled ``hpo-grow``
decision that regrows the tenant's inner population and re-keys it to the
grown bucket (:meth:`OptimizationService._grow_hpo`).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Union

import torch

from ..core import State
from ..obs.plane import Observability, resolve_obs
from ..resilience.health import HealthProbe
from ..resilience.preemption import Preempted, PreemptionGuard
from ..resilience.restart import perturb_prng_keys
from ..resilience.runner import scan_checkpoints
from ..utils import rng
from ..utils.checkpoint import CheckpointError, CheckpointStore, load_state, read_manifest, save_state
from ..workflows import EvalMonitor, StdWorkflow
from .pack import TenantPack, assign_fault_lane
from .tenant import TenantRecord, TenantSpec, TenantStatus, bucket_key, validate_tenant_id

__all__ = [
    "OptimizationService",
    "AdmissionError",
    "ServiceStats",
    "Rejection",
    "retry_after_seconds",
]


def retry_after_seconds(retry_after_segments: int | None, segment_seconds: float | None) -> float | None:
    """Convert a scheduler retry hint (in segment boundaries — the
    service's scheduling quantum) into wall-clock seconds using the
    **measured** segment cadence.  Returns ``None`` when either half is
    unknown (no hint, or no segment measured yet)."""
    if retry_after_segments is None:
        return None
    if not segment_seconds or segment_seconds <= 0:
        return None
    return float(retry_after_segments) * float(segment_seconds)


class AdmissionError(RuntimeError):
    """A submission was refused.  ``reason`` is the structured cause — the
    bounded queue is full (``"queue-full"``), the tenant id collides with
    a live tenant, or the spec is unusable.

    :ivar reason: machine-readable reject code.
    :ivar retry_after_segments: when set, the scheduler's estimate (in
        segment boundaries) of when capacity should free up; ``None`` for
        rejects a retry cannot fix (id/uid collisions).
    :ivar retry_after_seconds: the same hint in wall-clock seconds
        (:func:`retry_after_seconds`); ``None`` when no cadence has been
        measured."""

    def __init__(
        self,
        message: str,
        *,
        reason: str,
        retry_after_segments: int | None = None,
        retry_after_seconds: float | None = None,
    ):
        super().__init__(message)
        self.reason = reason
        self.retry_after_segments = None if retry_after_segments is None else int(retry_after_segments)
        self.retry_after_seconds = None if retry_after_seconds is None else float(retry_after_seconds)


class Rejection(tuple):
    """One refused submission: a ``(tenant_id, reason)`` pair carrying the
    structured ``retry_after_segments`` / ``retry_after_seconds`` hints as
    attributes, so ``stats.rejections`` records exactly what the raised
    :class:`AdmissionError` told the caller."""

    retry_after_segments: int | None
    retry_after_seconds: float | None

    def __new__(
        cls,
        tenant_id: str,
        reason: str,
        retry_after_segments: int | None = None,
        retry_after_seconds: float | None = None,
    ):
        self = super().__new__(cls, (tenant_id, reason))
        self.retry_after_segments = retry_after_segments
        self.retry_after_seconds = retry_after_seconds
        return self

    def __getnewargs__(self):
        # tuple's default reduce passes the CONTENTS to __new__; pickling
        # and deepcopy need the hints too.
        return (self[0], self[1], self.retry_after_segments, self.retry_after_seconds)


@dataclass
class ServiceStats:
    """Observable record of what the service did."""

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    segments_run: int = 0
    rejections: list[Rejection] = field(default_factory=list)
    quarantines: int = 0
    restarts: int = 0
    evictions: int = 0
    readmissions: int = 0
    checkpoints_written: int = 0
    preemptions: int = 0
    early_stops: int = 0


@dataclass
class _Bucket:
    key: tuple
    workflow: StdWorkflow
    pack: TenantPack
    monitor: EvalMonitor  # template (capture plumbing only; history unused)


class OptimizationService:
    """Packs many independent optimization runs onto one card with
    per-tenant fault bulkheads (the JAX package's parameters and
    semantics).

    Usage::

        svc = OptimizationService("svc_root", lanes_per_pack=64,
                                  segment_steps=16, seed=0)
        svc.submit(TenantSpec("alice-1", PSO(1024, lb, ub), Ackley(),
                              n_steps=400))
        svc.submit(TenantSpec("bob-7", PSO(1024, lb, ub), Ackley(),
                              n_steps=400))      # same bucket, same program
        svc.run()                                 # drain all tenants
        final = svc.result("alice-1")             # full workflow state
        history = svc.tenant("alice-1").monitor.fitness_history

    Tenants run where their algorithm lives (the card unless it was built
    with ``device="cpu"``); a bucket's program is the pack's captured graph
    there, or eager generations on the card when its problem calls the
    host.  Nothing moves a tenant to another device.

    :param root: service directory; tenant checkpoint namespaces live
        under ``<root>/tenants/<tenant_id>/``.
    :param lanes_per_pack: pack width per bucket (the vmapped batch size).
        One pack per bucket; tenants beyond the width wait in the queue.
    :param segment_steps: generations per segment — the scheduling quantum.
    :param max_queue: bound on tenants waiting for a lane; submissions past
        it raise :class:`AdmissionError` (reason ``"queue-full"``).
    :param seed: service random identity; tenant streams are
        ``fold_in(key(seed), uid)``, one base key per key implementation.
    :param health: a :class:`~evox_tpu_torch.resilience.HealthProbe` whose
        config drives both the in-segment per-lane early stop and the
        per-lane boundary verdicts; ``None`` builds a default probe.
    :param max_restarts: per-tenant restart budget on unhealthy verdicts;
        once spent, the lane is quarantined (frozen).
    :param checkpoint_every: segments between a tenant's periodic
        namespace checkpoints (1 = every boundary).
    :param preemption: a :class:`~evox_tpu_torch.resilience.PreemptionGuard`
        (or ``True`` for a service-owned one).
    :param store: the :class:`~evox_tpu_torch.utils.CheckpointStore` all
        checkpoint file operations route through.
    :param early_stop: carry the per-lane unhealthy-state freeze inside
        the segment (default True).
    :param monitor_factory: builds each tenant's monitor AND the bucket
        template monitor; defaults to ``EvalMonitor(ordered=False)``.
    :param on_event: one human-readable line per service event; defaults
        to ``warnings.warn`` for failures and silence otherwise.
    :param obs: the :class:`~evox_tpu_torch.obs.Observability` plane
        (``service``/``tenant`` events, ``evox_service_*`` and
        tenant-labeled ``evox_tenant_*`` metrics); ``None`` builds a
        default plane, ``False`` disables instrumentation.
    :param controller: optional
        :class:`~evox_tpu_torch.control.Controller` consulted for every
        threshold-healthy tenant's flight window (``tenant_action``:
        restart, quarantine or evict); exception-guarded on both sides.
    """

    def __init__(
        self,
        root: Union[str, Path],
        *,
        lanes_per_pack: int = 8,
        segment_steps: int = 16,
        max_queue: int = 256,
        seed: int = 0,
        health: HealthProbe | None = None,
        max_restarts: int = 1,
        checkpoint_every: int = 1,
        preemption: Union[PreemptionGuard, bool, None] = None,
        store: CheckpointStore | None = None,
        early_stop: bool = True,
        monitor_factory: Callable[[], EvalMonitor] | None = None,
        on_event: Callable[[str], None] | None = None,
        obs: Union[Observability, bool, None] = None,
        controller: Any | None = None,
    ):
        if lanes_per_pack < 1:
            raise ValueError(f"lanes_per_pack must be >= 1, got {lanes_per_pack}")
        if segment_steps < 1:
            raise ValueError(f"segment_steps must be >= 1, got {segment_steps}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.root = Path(root)
        self.lanes_per_pack = int(lanes_per_pack)
        self.segment_steps = int(segment_steps)
        self.max_queue = int(max_queue)
        self.seed = int(seed)
        self.health = health if health is not None else HealthProbe()
        self.max_restarts = int(max_restarts)
        self.checkpoint_every = int(checkpoint_every)
        self._owns_guard = preemption is True
        self.preemption: PreemptionGuard | None = (
            PreemptionGuard() if preemption is True else (preemption or None)
        )
        self.store = store if store is not None else CheckpointStore()
        self.early_stop = bool(early_stop)
        self.monitor_factory = monitor_factory or (lambda: EvalMonitor(ordered=False))
        self.on_event = on_event
        self.obs = resolve_obs(obs, run_id=Path(root).name)
        self.controller = controller
        if controller is not None:
            controller.bind(self.obs)
        # Seam for an eviction made durable elsewhere (see _evict_for_trend).
        self.evict_hook: Callable[[str], None] | None = None
        self.stats = ServiceStats()
        self._tenants: dict[str, TenantRecord] = {}
        self._tenants_by_uid: dict[int, TenantRecord] = {}
        self._queue: list[str] = []
        self._buckets: dict[tuple, _Bucket] = {}
        # Post-init load_state templates per (bucket, uid): building one
        # runs the init program, and the restart path resumes repeatedly.
        self._templates: dict[tuple, State] = {}
        self._next_uid = 0
        # Stream roots, one per (key implementation, device) used.
        self._base_keys: dict[tuple, torch.Tensor] = {}

    # -- events -------------------------------------------------------------
    def _event(
        self,
        msg: str,
        *,
        warn: bool = False,
        category: str = "service",
        tenant_id: str | None = None,
        **payload: Any,
    ) -> None:
        """One service event: onto the obs bus (severity intact), then
        through the string callback / warning."""
        if self.obs is not None:
            self.obs.event(category, msg, severity="warning" if warn else "info", tenant_id=tenant_id, **payload)
        if self.on_event is not None:
            self.on_event(msg)
        elif warn:
            warnings.warn(msg)

    def _note(self, record: TenantRecord, msg: str, *, warn: bool = False) -> None:
        record.events.append(msg)
        self._event(
            f"tenant {record.spec.tenant_id}: {msg}",
            warn=warn,
            category="tenant",
            tenant_id=record.spec.tenant_id,
            uid=record.uid,
        )

    def _inc(self, name: str, help: str = "", n: float = 1, **labels: Any) -> None:
        if self.obs is not None:
            self.obs.counter(name, help, **labels).inc(n)

    # -- admission control --------------------------------------------------
    def submit(self, spec: TenantSpec) -> TenantRecord:
        """Admit one tenant to the bounded queue (or refuse loudly).

        Re-submitting an EVICTED or QUARANTINED tenant's id re-queues it for
        readmission — it resumes from its checkpoint namespace
        bit-identically.  A COMPLETED id must be retired with
        :meth:`forget` first; a QUEUED/RUNNING id is a collision.
        """
        self.stats.submitted += 1
        self._inc("evox_service_submitted_total", "Tenant submissions received.")
        existing = self._tenants.get(spec.tenant_id)
        if existing is not None and existing.status in (TenantStatus.QUEUED, TenantStatus.RUNNING):
            return self._reject(
                spec, "id-collision", f"tenant id {spec.tenant_id!r} is already {existing.status.value}"
            )
        if existing is not None and existing.status is TenantStatus.COMPLETED:
            return self._reject(
                spec,
                "id-collision",
                f"tenant id {spec.tenant_id!r} already completed; call "
                f"forget() to retire the record before reusing the id",
            )
        if len(self._queue) >= self.max_queue:
            hint = self.retry_hint_segments()
            return self._reject(
                spec,
                "queue-full",
                f"admission queue is at its bound ({self.max_queue}); retry after ~{hint} segment boundaries",
                retry_after_segments=hint,
            )
        if existing is not None:
            if spec.uid is not None and spec.uid != existing.uid:
                return self._reject(
                    spec,
                    "uid-mismatch",
                    f"tenant id {spec.tenant_id!r} is readmission of uid "
                    f"{existing.uid}, but the spec pins uid {spec.uid}; "
                    f"omit uid= (or pass the original) to resume, or "
                    f"forget() the record to start a new identity",
                )
            # Readmission keeps the uid and the monitor; only the spec's
            # budget may be refreshed.  A quarantined tenant still holds its
            # frozen lane: release it, so the readmission resumes from the
            # namespace like any eviction.
            if existing.lane is not None:
                self._buckets[existing.bucket].pack.release(existing.lane)
                existing.lane = None
            if existing.grows and existing.spec.workload == "hpo":
                # Applied growths outlive parking: the record's problem is
                # the GROWN nest, while a resubmitted spec carries the
                # original one (the grown instance is the service's own).
                # Keeping it lets readmission resume the grown-shape
                # checkpoints instead of skipping them at template
                # validation.
                spec = dataclasses.replace(spec, problem=existing.spec.problem)
            existing.spec = spec
            existing.status = TenantStatus.QUEUED
            record = existing
            self.stats.readmissions += 1
            self._inc("evox_service_readmissions_total", "Evicted/quarantined tenants re-queued.")
            self._note(record, "re-queued for readmission")
        else:
            uid = spec.uid if spec.uid is not None else self._next_uid
            if uid in self._tenants_by_uid:
                return self._reject(spec, "uid-collision", f"uid {uid} is already assigned to another tenant")
            self._next_uid = max(self._next_uid, uid + 1)
            record = TenantRecord(spec=spec, uid=uid, monitor=self.monitor_factory())
            if self.obs is not None and self.obs.flight is not None:
                # One flight recorder per tenant, dumping on this tenant's
                # warning events into its own namespace.
                record.flight = self.obs.flight.for_tenant(spec.tenant_id)
                self.obs.bus.add_sink(record.flight)
            self._tenants[spec.tenant_id] = record
            self._tenants_by_uid[uid] = record
            self._note(record, f"queued (uid {uid})")
        self._queue.append(spec.tenant_id)
        return record

    def _reject(
        self,
        spec: TenantSpec,
        reason: str,
        detail: str,
        *,
        retry_after_segments: int | None = None,
        retry_after_seconds: float | None = None,
    ):
        self.stats.rejections.append(Rejection(spec.tenant_id, reason, retry_after_segments, retry_after_seconds))
        self._inc("evox_service_rejections_total", "Submissions refused, by structured reason.", reason=reason)
        self._event(
            f"rejected tenant {spec.tenant_id!r} ({reason}): {detail}",
            warn=True,
            tenant_id=spec.tenant_id,
            reason=reason,
        )
        raise AdmissionError(
            f"submission of tenant {spec.tenant_id!r} refused ({reason}): {detail}",
            reason=reason,
            retry_after_segments=retry_after_segments,
            retry_after_seconds=retry_after_seconds,
        )

    def retry_hint_segments(self) -> int:
        """Scheduler estimate of how many segment boundaries until a lane
        frees: the nearest running tenant's remaining whole segments (1
        when nothing is running)."""
        remaining = [
            -(-max(0, r.spec.n_steps - r.generations) // self.segment_steps)
            for r in self._tenants.values()
            if r.status is TenantStatus.RUNNING
        ]
        return max(1, min(remaining)) if remaining else 1

    # -- tenant accessors ---------------------------------------------------
    def tenant(self, tenant_id: str) -> TenantRecord:
        """The runtime record of one tenant (KeyError for unknown ids)."""
        return self._tenants[tenant_id]

    def result(self, tenant_id: str) -> State:
        """A tenant's full workflow state: the final state for COMPLETED
        tenants (a copy kept on the tenant's device), the live lane state
        for RUNNING/QUARANTINED ones."""
        record = self._tenants[tenant_id]
        if record.result is not None:
            return record.result
        if record.lane is None:
            raise RuntimeError(
                f"tenant {tenant_id!r} is {record.status.value} and holds "
                f"no lane; resume it (submit again) or read its checkpoints"
            )
        return self._buckets[record.bucket].pack.lane_state(record.lane)

    def forget(self, tenant_id: str, *, purge: bool = False) -> None:
        """Retire a COMPLETED/EVICTED/QUARANTINED tenant's record (a
        quarantined tenant's frozen lane is released).  With ``purge=True``
        the tenant's checkpoint namespace and flight dir are removed
        through the store (advisory)."""
        record = self._tenants.get(tenant_id)
        if record is None:
            return
        if record.status in (TenantStatus.QUEUED, TenantStatus.RUNNING):
            raise RuntimeError(f"tenant {tenant_id!r} is {record.status.value}; evict it before forgetting")
        if record.lane is not None:
            self._buckets[record.bucket].pack.release(record.lane)
            record.lane = None
        self._drop_record(record)
        if purge:
            self._purge_tenant_dirs(tenant_id, record)

    def _drop_record(self, record: TenantRecord) -> None:
        tenant_id = record.spec.tenant_id
        self._templates.pop((record.bucket, record.uid), None)
        self._tenants_by_uid.pop(record.uid, None)
        del self._tenants[tenant_id]
        if record.flight is not None and self.obs is not None:
            self.obs.bus.remove_sink(record.flight)
        if self.obs is not None:
            # Tenant churn must not grow the registry without bound.
            self.obs.registry.remove_labeled("tenant_id", tenant_id)

    def _purge_tenant_dirs(self, tenant_id: str, record: TenantRecord) -> None:
        """Reclaim a retired tenant's disk, bottom-up through the store;
        a failed unlink leaves orphans, never an error."""
        targets = [self.namespace(tenant_id)]
        if record.flight is not None:
            targets.append(record.flight.dir)
        elif self.obs is not None and self.obs.flight is not None:
            targets.append(self.obs.flight.dir / tenant_id)
        for root in targets:
            if not root.is_dir():
                continue
            for dirpath, dirnames, filenames in os.walk(root, topdown=False):
                for name in filenames:
                    try:
                        self.store.unlink(Path(dirpath) / name)
                    except OSError:
                        pass
                for name in dirnames:
                    try:
                        os.rmdir(Path(dirpath) / name)
                    except OSError:
                        pass
            try:
                os.rmdir(root)
            except OSError:
                pass

    def withdraw(self, tenant_id: str, *, to_status: TenantStatus | None = None) -> None:
        """Remove a QUEUED tenant from the admission queue before it ever
        occupies a lane: the record is dropped (``to_status=None``) or kept
        parked (``to_status=TenantStatus.EVICTED``, resumable later)."""
        record = self._tenants.get(tenant_id)
        if record is None or record.status is not TenantStatus.QUEUED:
            raise RuntimeError(
                f"tenant {tenant_id!r} is not QUEUED"
                + (f" (status {record.status.value})" if record is not None else " (unknown id)")
            )
        self._queue = [t for t in self._queue if t != tenant_id]
        if to_status is not None:
            record.status = to_status
            self._note(record, f"withdrawn from queue ({to_status.value})")
            return
        self._drop_record(record)
        self._note(record, "withdrawn from queue (record dropped)")

    # -- checkpoint namespaces ----------------------------------------------
    def namespace(self, tenant_id: str) -> Path:
        """The tenant's private checkpoint directory (the id re-validated
        as a safe path component)."""
        validate_tenant_id(tenant_id)
        return self.root / "tenants" / tenant_id

    def _ckpt_path(self, record: TenantRecord, generation: int) -> Path:
        return self.namespace(record.spec.tenant_id) / f"ckpt_{generation:08d}.npz"

    def _checkpoint_tenant(
        self, record: TenantRecord, state: State, *, emergency: bool = False, reason: str | None = None
    ) -> None:
        ns = self.namespace(record.spec.tenant_id)
        ns.mkdir(parents=True, exist_ok=True)
        from ..precision import precision_tag, resolve_key_impl

        metadata: dict[str, Any] = {
            "tenant_id": record.spec.tenant_id,
            "uid": record.uid,
            "tenant_status": record.status.value,
            "tenant_restarts": record.restarts,
            "lane_health_window": list(self.health.lane_window(record.uid)),
            # Numerics identity: readmission refuses a cross-policy /
            # cross-impl resume before touching a leaf.
            "precision": precision_tag(record.spec.precision),
            "key_impl": resolve_key_impl(record.spec.key_impl),
        }
        if emergency:
            metadata.update(preempted=True, preemption_reason=reason or "preempted")
        path = self._ckpt_path(record, record.generations)
        try:
            save_state(
                path, state, generation=record.generations, metadata=metadata, store=self.store, durable=emergency
            )
        except (OSError, RuntimeError, ValueError) as e:
            self._note(
                record,
                f"checkpoint write of {path.name} failed "
                f"({type(e).__name__}: {e}); previous checkpoint remains "
                f"the resume point",
                warn=True,
            )
            return
        record.segments_since_checkpoint = 0
        self.stats.checkpoints_written += 1
        self._inc("evox_service_checkpoints_written_total", "Tenant-namespace checkpoints published.")

    # -- tenant state construction -------------------------------------------
    def _tenant_key(self, uid: int, key_impl: str | None, device: torch.device) -> torch.Tensor:
        # Identity-keyed stream: stable across lanes, packs and
        # readmissions; one base key per key implementation from the SAME
        # seed, so a tenant's stream is a function of (seed, impl, uid).
        from ..precision import make_key, resolve_key_impl

        impl = resolve_key_impl(key_impl)
        base = self._base_keys.get((impl, str(device)))
        if base is None:
            base = self._base_keys[(impl, str(device))] = make_key(self.seed, impl, device)
        return rng.fold_in(base, int(uid))

    def _fresh_state(self, bucket: _Bucket, record: TenantRecord) -> State:
        """A tenant's pre-init state: ``StdWorkflow.setup`` from the
        tenant's identity-folded key, with the uid as the monitor's
        instance id and stamped into every ``fault_lane`` leaf."""
        wf = bucket.workflow
        device = getattr(wf.algorithm, "device", None) or torch.device("cpu")
        key = self._tenant_key(record.uid, record.spec.key_impl, device)
        return assign_fault_lane(wf.setup(key, instance_id=record.uid), record.uid)

    def _resume_state(self, bucket: _Bucket, record: TenantRecord) -> tuple[State, int] | None:
        """Newest usable checkpoint of the tenant's namespace, or None.

        The scan reads manifests only; the selected archive is then FULLY
        digest-verified at load.  Corrupt candidates are quarantined
        ``*.corrupt`` exactly like the runner's scan."""
        ns = self.namespace(record.spec.tenant_id)
        if not ns.is_dir():
            return None
        # One template a (bucket, tenant): allow_missing restores keep the
        # TEMPLATE's values for leaves an older checkpoint lacks, which
        # must be this tenant's.
        tkey = (bucket.key, record.uid)
        template = self._templates.get(tkey)
        if template is None:
            template, _, _ = bucket.pack.init_tenant(self._fresh_state(bucket, record))
            self._templates[tkey] = template
        candidates, rejected = scan_checkpoints(ns, verify="manifest", quarantine=True, store=self.store)
        for path, why, quarantined in rejected:
            self._note(
                record,
                f"resume scan skipped {path.name}: {why}" + (" (quarantined)" if quarantined else ""),
                warn=True,
            )
        for gen, path in reversed(candidates):
            try:
                manifest = read_manifest(path)
                state = load_state(
                    path,
                    template,
                    allow_missing=True,
                    verify=True,
                    precision=record.spec.precision,
                    key_impl=record.spec.key_impl,
                )
            except FileNotFoundError:
                continue
            except (CheckpointError, ValueError) as e:
                self._note(record, f"resume skipped {path.name}: {e}", warn=True)
                continue
            self.health.restore_lane(record.uid, manifest.get("lane_health_window", []))
            # max(): a rollback restart reloads a checkpoint written BEFORE
            # the restart fired.
            record.restarts = max(record.restarts, int(manifest.get("tenant_restarts", 0)))
            self._note(record, f"resumed from {path.name} (generation {gen})")
            return state, gen
        return None

    # -- buckets ------------------------------------------------------------
    def _bucket_for(self, spec: TenantSpec) -> _Bucket:
        bkey = bucket_key(spec)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            monitor = self.monitor_factory()
            workflow = StdWorkflow(
                spec.algorithm,
                spec.problem,
                monitor=monitor,
                solution_transform=spec.solution_transform,
                precision=spec.precision,
                key_impl=spec.key_impl,
            )
            pack = TenantPack(
                workflow,
                self.lanes_per_pack,
                health=self.health,
                early_stop=self.early_stop,
                flight=(self.obs is not None and self.obs.flight is not None),
            )
            bucket = _Bucket(key=bkey, workflow=workflow, pack=pack, monitor=monitor)
            self._buckets[bkey] = bucket
            self._event(f"new bucket {bkey[0]} pop={bkey[1]} dim={bkey[2]} ({self.lanes_per_pack} lanes)")
        return bucket

    # -- scheduling ---------------------------------------------------------
    def _admit_pending(self) -> None:
        """Fill free lanes from the queue (boundary-only admission)."""
        still_waiting: list[str] = []
        for tenant_id in self._queue:
            record = self._tenants[tenant_id]
            bucket = self._bucket_for(record.spec)
            if not bucket.pack.free_lanes():
                still_waiting.append(tenant_id)
                continue
            resumed = self._resume_state(bucket, record)
            if resumed is not None:
                state, generations = resumed
                # The resume point can sit BEHIND history the monitor
                # already recorded: prune the tail past it.
                if record.monitor is not None and hasattr(record.monitor, "truncate_history"):
                    record.monitor.truncate_history(generations)
                if generations >= record.spec.n_steps:
                    # Budget already met at the resume point: the resumed
                    # state is the result, no lane is burned.
                    record.bucket = bucket.key
                    record.generations = generations
                    record.status = TenantStatus.COMPLETED
                    record.result = state
                    self.stats.admitted += 1
                    self.stats.completed += 1
                    self._inc(
                        "evox_service_admitted_total",
                        "Tenants admitted to a lane (or completed at admission).",
                    )
                    self._inc("evox_tenant_completed_total", "Tenant runs completed.", tenant_id=tenant_id)
                    self._note(
                        record,
                        f"resumed at generation {generations}, already at "
                        f"or past the n_steps={record.spec.n_steps} "
                        f"budget — completed without occupying a lane",
                    )
                    continue
            else:
                state, init_meta, init_sinks = bucket.pack.init_tenant(self._fresh_state(bucket, record))
                generations = 1
                self.health.reset_lane(record.uid)
                if init_sinks and record.monitor is not None:
                    # The init generation's history belongs to THIS
                    # tenant's monitor, like a solo run's first record.
                    record.monitor.ingest_sinks(init_meta, init_sinks, 1)
            record.bucket = bucket.key
            record.generations = generations
            record.lane = bucket.pack.admit(state, record.uid)
            record.status = TenantStatus.RUNNING
            record.segments_since_checkpoint = 0
            self.stats.admitted += 1
            self._inc("evox_service_admitted_total", "Tenants admitted to a lane (or completed at admission).")
            self._note(record, f"admitted to lane {record.lane} at generation {generations}")
            if resumed is None:
                # The post-init state is the tenant's first resume point.
                self._checkpoint_tenant(record, state)
        self._queue = still_waiting

    def evict(self, tenant_id: str) -> None:
        """Checkpoint a RUNNING/QUARANTINED tenant's lane to its namespace
        and free the lane (call between :meth:`step` calls).  Readmission
        (:meth:`submit` with the same id) resumes bit-identically."""
        record = self._tenants[tenant_id]
        if record.lane is None:
            raise RuntimeError(f"tenant {tenant_id!r} is {record.status.value} and holds no lane")
        bucket = self._buckets[record.bucket]
        self._checkpoint_tenant(record, bucket.pack.lane_state(record.lane))
        bucket.pack.release(record.lane)
        record.lane = None
        record.status = TenantStatus.EVICTED
        self.stats.evictions += 1
        self._inc("evox_service_evictions_total", "Tenants evicted to their checkpoint namespace.")
        self._note(record, "evicted (checkpointed; lane freed)")

    def _handle_preemption(self) -> None:
        reason = self.preemption.reason or "preempted"
        for record in self._tenants.values():
            if record.lane is None:
                continue
            bucket = self._buckets[record.bucket]
            state = bucket.pack.lane_state(record.lane)
            mon = bucket.workflow.monitor
            if "monitor" in state:
                state = state.replace(monitor=mon.record_preemption(state["monitor"]))
                bucket.pack.write_lane(record.lane, state)
            self._checkpoint_tenant(record, state, emergency=True, reason=reason)
            # EVICTED shape (lane freed, resume point on disk): resubmitting
            # works on this instance exactly like on a fresh one.
            bucket.pack.release(record.lane)
            record.lane = None
            record.status = TenantStatus.EVICTED
            self._note(record, f"preempted ({reason}); lane freed")
        self.stats.preemptions += 1
        self._inc("evox_service_preemptions_total", "Service-wide graceful preemption stops.")
        self._event(
            f"preempted ({reason}); emergency checkpoints published for every running tenant",
            warn=True,
            category="preemption",
            reason=reason,
        )
        raise Preempted(
            f"service preempted ({reason}); every running tenant's "
            f"namespace holds an emergency checkpoint — resubmit the same "
            f"tenants to resume bit-identically",
            reason=reason,
        )

    def step(self) -> bool:
        """One scheduling round: boundary work (preemption check,
        admissions), then one segment per pack with active lanes, then
        per-lane boundary work (telemetry demux, verdicts,
        restarts/quarantine, retirement, checkpoints).  Returns whether any
        lane actually stepped."""
        if self.preemption is not None and self.preemption.triggered:
            self._handle_preemption()
        self._admit_pending()
        stepped_any = False
        # A snapshot: boundary work can create buckets (the hpo-grow re-key
        # admits the grown tenant into a new one), which step next round.
        for bucket in list(self._buckets.values()):
            if not bucket.pack.active_lanes():
                continue
            telemetry = bucket.pack.run_segment(self.segment_steps)
            self.stats.segments_run += 1
            self._inc("evox_service_segments_total", "Packed fused segments dispatched.")
            stepped_any = True
            self._boundary(bucket, telemetry)
        # Late admissions: lanes freed by this round's retirements.
        if self._queue:
            self._admit_pending()
        return stepped_any

    def run(self, max_rounds: int | None = None) -> None:
        """Drain the service: step until no lane can make progress (all
        tenants COMPLETED, QUARANTINED, or EVICTED and the queue cannot be
        placed).  ``max_rounds`` bounds the loop.  Installs the preemption
        guard (when configured) for the duration; a service-owned guard is
        reset first."""
        installed_guard = False
        if self.preemption is not None:
            if self._owns_guard:
                self.preemption.reset()
            if not self.preemption.installed:
                self.preemption.install()
                installed_guard = True
        try:
            rounds = 0
            while True:
                if max_rounds is not None and rounds >= max_rounds:
                    return
                progressed = self.step()
                rounds += 1
                if not progressed:
                    # Nothing stepped: either nothing is left, or the queue
                    # waits on lanes that no longer free themselves.
                    return
        finally:
            if installed_guard:
                self.preemption.uninstall()

    # -- boundary work ------------------------------------------------------
    def _boundary(self, bucket: _Bucket, telemetry: Any) -> None:
        executed = telemetry["executed"].tolist()
        stopped = telemetry["stopped"].tolist()
        meta_pairs = StdWorkflow.sink_meta_pairs(telemetry)
        sinks = telemetry["sinks"] if "sinks" in telemetry else ()
        frozen = bucket.pack.frozen_mask
        was_active = {lane for lane, _ in bucket.pack.occupied_lanes() if executed[lane] > 0 or not frozen[lane]}
        for lane, uid in bucket.pack.occupied_lanes():
            if lane not in was_active:
                continue
            record = self._tenants_by_uid[uid]
            record.generations += int(executed[lane])
            record.segments_since_checkpoint += 1
            if executed[lane]:
                self._inc(
                    "evox_tenant_generations_total",
                    "Generations completed, per tenant.",
                    n=int(executed[lane]),
                    tenant_id=record.spec.tenant_id,
                )
            if sinks and record.monitor is not None:
                record.monitor.ingest_sinks(meta_pairs, sinks, telemetry["executed"], lane=lane)
            if record.spec.workload == "hpo" and executed[lane]:
                from ..hpo.nested import find_nested

                nested = find_nested(record.spec.problem)
                if nested is not None:
                    # One outer generation of an HPO tenant executes a whole
                    # inner ladder: candidates x repeats x iterations.
                    self._inc(
                        "evox_hpo_inner_generations_total",
                        "Inner generations executed by packed HPO tenants (candidates x repeats x iterations "
                        "per outer generation).",
                        n=int(executed[lane]) * nested.inner_generations_per_eval(),
                        tenant_id=record.spec.tenant_id,
                    )
            if record.flight is not None and "flight" in telemetry and executed[lane]:
                # Before the verdicts: a restart/quarantine dump must hold
                # this segment's rows.
                record.flight.record_rows(
                    telemetry["flight"],
                    int(executed[lane]),
                    start_generation=record.generations - int(executed[lane]),
                    lane=lane,
                )
            if stopped[lane] and int(executed[lane]) < self.segment_steps:
                self.stats.early_stops += 1
                self._inc(
                    "evox_tenant_early_stops_total",
                    "In-scan lane freezes, per tenant.",
                    tenant_id=record.spec.tenant_id,
                )
                self._note(
                    record,
                    f"in-scan early stop at generation {record.generations}: lane froze mid-segment",
                    warn=True,
                )
        # Verdicts on the post-segment states (one scan, one read for the
        # whole pack); only lanes that stepped are probed.
        reports = bucket.pack.check_lanes(self.health, lanes=was_active)
        for lane, report in reports.items():
            record = self._tenants_by_uid[bucket.pack.occupants[lane]]
            report.generation = record.generations
            if record.generations >= record.spec.n_steps:
                self._complete(bucket, record)
                continue
            if (
                report.healthy
                and record.spec.workload == "hpo"
                and record.spec.grow is not None
                and self.controller is not None
            ):
                # The elastic inner-population ladder: a fired growth is
                # this boundary's verdict for the tenant; otherwise the
                # trend and checkpoint handling below go on.
                if self._maybe_grow_hpo(bucket, record):
                    continue
            if report.healthy and self.controller is not None and self.controller.trend_enabled:
                # Trend overlay on a threshold-healthy lane; an unhealthy
                # threshold verdict below always wins unchanged.
                action, trend = self._controller_tenant(record)
                if action == "evict":
                    if self._evict_for_trend(record, trend):
                        continue
                if action in ("restart", "quarantine"):
                    self._unhealthy(
                        bucket, record, report.with_trend([f"controller trend verdict: {trend.action}"])
                    )
                    continue
            if report.healthy:
                if record.segments_since_checkpoint >= self._tenant_checkpoint_every(record):
                    self._checkpoint_tenant(record, bucket.pack.lane_state(lane))
                continue
            self._unhealthy(bucket, record, report)

    # -- elastic HPO growth ---------------------------------------------------
    def _maybe_grow_hpo(self, bucket: _Bucket, record: TenantRecord) -> bool:
        """Consult the controller's ``hpo-grow`` plane for one healthy HPO
        tenant and apply a fired growth (:meth:`_grow_hpo`).  Returns
        whether the tenant was regrown.  Never raises: a failed consult
        leaves the tenant running ungrown, with a warning."""
        from ..hpo.elastic import grow_evidence
        from ..hpo.nested import candidate_series, find_nested

        nested = find_nested(record.spec.problem)
        if nested is None:
            return False
        # Growths share the restart budget: a ladder at its budget
        # quarantines like any other degenerating tenant instead of growing
        # without bound.
        if record.restarts + record.grows >= self._tenant_max_restarts(record):
            return False
        try:
            state = bucket.pack.lane_state(record.lane)
            series = candidate_series(state["problem"] if "problem" in state else None)
            if not series:
                return False
            evidence = grow_evidence(record.spec.grow, series, nested.inner_pop)
            if evidence is None:
                return False
            decision = self.controller.hpo_grow(
                evidence=evidence, generation=record.generations, tenant_id=record.spec.tenant_id
            )
        except Exception as e:  # noqa: BLE001 - never crash the boundary
            self._note(record, f"hpo-grow consult failed ({type(e).__name__}: {e}); tenant continues ungrown",
                       warn=True)
            return False
        if decision is None or decision.action in ("", "hold"):
            return False
        return self._grow_hpo(bucket, record, decision, state)

    def _grow_hpo(self, bucket: _Bucket, record: TenantRecord, decision: Any, state: State) -> bool:
        """Apply one journaled ``hpo-grow`` decision: regrow the tenant's
        nest to the decision's inner population, re-key its bucket (a
        changed inner population is another program, whose pack captures
        its own init and segment programs once) and move the tenant's
        state there: the outer state kept, the inner instances rebuilt at
        the grown size from the tenant's key and ``salt + grows``."""
        from ..hpo.nested import find_nested

        nested = find_nested(record.spec.problem)
        if record.spec.problem is not nested:
            # Re-keying would have to rebuild the wrapper chain around the
            # grown nest; refuse rather than guess at wrapper state.
            self._note(
                record,
                "hpo-grow decision not applied: the spec's problem wraps the NestedProblem (growth needs the "
                "nested problem as the spec problem itself)",
                warn=True,
            )
            return False
        new_pop = int(decision.action)
        old_pop = nested.inner_pop
        grown = nested.with_inner_pop(new_pop, record.spec.grow.inner_factory)
        record.grows += 1
        new_state = state.replace(problem=grown.regrow_state(state["problem"], record.spec.grow.salt + record.grows))
        # Lane surgery: out of the old bucket's pack ...
        bucket.pack.release(record.lane)
        record.lane = None
        self._templates.pop((record.bucket, record.uid), None)
        record.spec = dataclasses.replace(record.spec, problem=grown)
        # ... into the grown bucket's (created on first use).
        new_bucket = self._bucket_for(record.spec)
        record.bucket = new_bucket.key
        self.health.reset_lane(record.uid)
        self._inc(
            "evox_hpo_grows_total",
            "Elastic inner-population growths applied to HPO tenants.",
            tenant_id=record.spec.tenant_id,
        )
        if new_bucket.pack.free_lanes():
            record.lane = new_bucket.pack.admit(new_state, record.uid)
            # The grown state is the tenant's first resume point at the new
            # shape (older archives fail template validation on a resume).
            self._checkpoint_tenant(record, new_state)
            self._note(
                record,
                f"hpo-grow #{record.grows}: inner population {old_pop} -> {new_pop} (decision #{decision.seq}; "
                f"bucket re-keyed, lane {record.lane})",
                warn=True,
            )
        else:
            self._checkpoint_tenant(record, new_state)
            record.status = TenantStatus.EVICTED
            self._note(
                record,
                f"hpo-grow #{record.grows}: inner population {old_pop} -> {new_pop}, but the grown bucket has no "
                f"free lane — parked on the grown checkpoint (resubmit to resume)",
                warn=True,
            )
        return True

    # -- per-tenant steering overrides ---------------------------------------
    def _tenant_max_restarts(self, record: TenantRecord) -> int:
        return int(record.steer.get("max_restarts", self.max_restarts))

    def _tenant_checkpoint_every(self, record: TenantRecord) -> int:
        return int(record.steer.get("checkpoint_every", self.checkpoint_every))

    def _evict_for_trend(self, record: TenantRecord, trend: Any) -> bool:
        """Act on a controller ``evict`` decision through
        :attr:`evict_hook` when one is installed; a failed eviction leaves
        the tenant RUNNING with a warning.  Returns whether it went
        through."""
        evict = self.evict_hook if self.evict_hook is not None else self.evict
        try:
            evict(record.spec.tenant_id)
        except Exception as e:  # noqa: BLE001 - never crash the boundary
            self._note(
                record,
                f"controller eviction (trend verdict {trend.action}) "
                f"could not be applied ({type(e).__name__}: {e}); tenant "
                f"stays running on threshold verdicts",
                warn=True,
            )
            return False
        self._note(record, f"controller evicted (trend verdict {trend.action}); resubmit to resume", warn=True)
        return True

    def _controller_tenant(self, record: TenantRecord) -> tuple[str | None, Any]:
        """Consult the controller for one threshold-healthy tenant:
        ``(action, trend_decision)``, or ``(None, None)`` when no trend
        verdict fired.  Never raises."""
        rows = None
        if record.flight is not None:
            try:
                rows = record.flight.rows()
            except Exception:  # noqa: BLE001 - detached/broken recorder
                rows = None
        try:
            trend = self.controller.trend_verdict(
                rows, generation=record.generations, tenant_id=record.spec.tenant_id
            )
            if trend is None:
                return None, None
            decision = self.controller.tenant_action(
                trend,
                restarts_used=record.restarts,
                max_restarts=self._tenant_max_restarts(record),
                generation=record.generations,
                tenant_id=record.spec.tenant_id,
            )
            return (decision.action if decision is not None else None), trend
        except Exception as e:  # noqa: BLE001 - advisory plane only
            self._event(
                f"controller consult for tenant {record.spec.tenant_id!r} failed "
                f"({type(e).__name__}: {e}); threshold verdicts only",
                warn=True,
                category="control",
                tenant_id=record.spec.tenant_id,
            )
            return None, None

    def _complete(self, bucket: _Bucket, record: TenantRecord) -> None:
        state = bucket.pack.lane_state(record.lane)
        record.status = TenantStatus.COMPLETED
        self._checkpoint_tenant(record, state)
        record.result = state
        bucket.pack.release(record.lane)
        record.lane = None
        self.stats.completed += 1
        self._inc("evox_tenant_completed_total", "Tenant runs completed.", tenant_id=record.spec.tenant_id)
        self._note(record, f"completed at generation {record.generations} (lane freed)")

    def _unhealthy(self, bucket: _Bucket, record: TenantRecord, report: Any) -> None:
        reasons = "; ".join(report.reasons)
        if record.restarts < self._tenant_max_restarts(record):
            resumed = self._resume_state(bucket, record)
            if resumed is not None:
                state, generations = resumed
                record.restarts += 1
                # Replay from the known-good state with every key folded by
                # the restart index: a fresh, deterministic trajectory.
                state = perturb_prng_keys(state, record.restarts)
                mon = bucket.workflow.monitor
                if "monitor" in state:
                    state = state.replace(monitor=mon.record_restart(state["monitor"]))
                bucket.pack.write_lane(record.lane, state)
                record.generations = generations
                # The rollback replays generations the monitor recorded.
                if record.monitor is not None and hasattr(record.monitor, "truncate_history"):
                    record.monitor.truncate_history(generations)
                self.health.reset_lane(record.uid)
                self.stats.restarts += 1
                self._inc(
                    "evox_tenant_restarts_total",
                    "Rollback restarts burned, per tenant.",
                    tenant_id=record.spec.tenant_id,
                )
                self._note(
                    record,
                    f"restart #{record.restarts} (rollback to generation {generations}): {reasons}",
                    warn=True,
                )
                return
        bucket.pack.set_frozen(record.lane, True)
        record.status = TenantStatus.QUARANTINED
        self.stats.quarantines += 1
        self._inc(
            "evox_tenant_quarantines_total",
            "Lane freezes after a spent restart budget, per tenant.",
            tenant_id=record.spec.tenant_id,
        )
        self._checkpoint_tenant(record, bucket.pack.lane_state(record.lane))
        self._note(
            record,
            f"quarantined at generation {record.generations} (lane "
            f"frozen; restart budget "
            f"{record.restarts}/{self._tenant_max_restarts(record)} "
            f"spent): {reasons}",
            warn=True,
        )
