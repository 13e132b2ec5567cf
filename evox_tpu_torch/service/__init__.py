"""The multi-tenant service (counterpart of ``evox_tpu/service``), in part.

Ported:

* the service core: :class:`OptimizationService` (bounded admission with
  structured rejections, program buckets, per-tenant streams, monitors,
  health windows and checkpoint namespaces, eviction and readmission,
  restarts and quarantine, preemption), :class:`TenantPack` (a bucket's
  tenants stacked over lanes, each segment one captured CUDA graph of
  vmapped lane-freeze generations), the tenant model (:class:`TenantSpec`,
  :class:`TenantRecord`, :class:`TenantStatus`, :func:`bucket_key`,
  :func:`static_signature`, :func:`validate_tenant_id`),
  :func:`assign_fault_lane`, :class:`AdmissionError`, :class:`Rejection`,
  :class:`ServiceStats` and :func:`retry_after_seconds`;
* the crash-safe request journal (:mod:`.journal`), whose files are the
  JAX package's, byte for byte in their format;
* the durable serving daemon (:mod:`.daemon`): :class:`ServiceDaemon`
  (journal replay and resubmission, pre-warm through the persistent
  program cache, per-class admission budgets with structured sheds,
  brown-out, steer/park/evict/forget, journal compaction, SLOs, the
  introspection endpoint, :meth:`~ServiceDaemon.fleet_supervisor`),
  :class:`TenantClass`, :class:`DaemonStats`, :data:`STEER_KNOBS`.

* the HPO workload: ``TenantSpec(workload="hpo", grow=...)`` packs
  :class:`~evox_tpu_torch.hpo.NestedProblem` tenants (the nest inline in
  the pack's captured graph), counts ``evox_hpo_*`` per tenant, and grows
  a stagnating ladder by a journaled ``hpo-grow`` decision that re-keys
  the tenant to the grown bucket.

Not ported yet: the gateway and its client with ``encode_spec`` (item
13.8b), and the tenant router and its members (item 13.8c); importing one
of their names raises :class:`ImportError`.
"""

from .daemon import STEER_KNOBS, DaemonStats, ServiceDaemon, TenantClass
from .journal import (
    CompactionResult,
    JournalDamage,
    JournalError,
    JournalRecord,
    JournalSnapshot,
    RequestJournal,
)
from .pack import TenantPack, assign_fault_lane
from .service import AdmissionError, OptimizationService, Rejection, ServiceStats, retry_after_seconds
from .tenant import TenantRecord, TenantSpec, TenantStatus, bucket_key, static_signature, validate_tenant_id

__all__ = [
    "AdmissionError",
    "CompactionResult",
    "DaemonStats",
    "JournalDamage",
    "JournalError",
    "JournalRecord",
    "JournalSnapshot",
    "OptimizationService",
    "Rejection",
    "RequestJournal",
    "STEER_KNOBS",
    "ServiceDaemon",
    "ServiceStats",
    "TenantClass",
    "TenantPack",
    "TenantRecord",
    "TenantSpec",
    "TenantStatus",
    "assign_fault_lane",
    "bucket_key",
    "retry_after_seconds",
    "static_signature",
    "validate_tenant_id",
]

# Not ported yet, with the ROADMAP Queue 1 item that ports each.
_GATEWAY = "item 13.8b (the gateway and its client)"
_ROUTER = "item 13.8c (the tenant router and its members)"
_NOT_PORTED = {
    "Gateway": _GATEWAY,
    "GatewayClient": _GATEWAY,
    "GatewayError": _GATEWAY,
    "HttpTransport": _GATEWAY,
    "encode_spec": _GATEWAY,
    "MEMBER_API_PREFIX": _ROUTER,
    "ServiceMember": _ROUTER,
    "TenantRouter": _ROUTER,
}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(f"evox_tpu_torch.service.{name} is not ported yet: ROADMAP Queue 1, {_NOT_PORTED[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
