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
  JAX package's, byte for byte in their format.

Not ported yet: the service's HPO workload (``TenantSpec(workload="hpo")``
raises :class:`NotImplementedError`, ROADMAP Queue 1, item 13.10), and the
daemon, the gateway and its client, the tenant router and its members
(ROADMAP Queue 1, item 13.8); importing one of their names raises
:class:`ImportError`.
"""

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
    "JournalDamage",
    "JournalError",
    "JournalRecord",
    "JournalSnapshot",
    "OptimizationService",
    "Rejection",
    "RequestJournal",
    "ServiceStats",
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

_NOT_PORTED = (
    "DaemonStats",
    "Gateway",
    "GatewayClient",
    "GatewayError",
    "HttpTransport",
    "MEMBER_API_PREFIX",
    "STEER_KNOBS",
    "ServiceDaemon",
    "ServiceMember",
    "TenantClass",
    "TenantRouter",
    "encode_spec",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.service.{name} is not ported yet: the service's daemon, gateway, client and "
            f"router come with ROADMAP Queue 1, item 13.8 (the service core and the request journal are ported)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
