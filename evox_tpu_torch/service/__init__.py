"""The multi-tenant service (counterpart of ``evox_tpu/service``), in part.

Ported: the crash-safe request journal (:mod:`.journal`:
:class:`RequestJournal`, :class:`JournalRecord`, :class:`JournalDamage`,
:class:`JournalError`, :class:`JournalSnapshot`,
:class:`CompactionResult`), the durable log the control plane journals its
decisions to (``Controller(journal=RequestJournal(...))``).  Its files are
the JAX package's, byte for byte in their format: a journal written by
either package replays in the other.

Not ported yet: the service itself — the packed service, the daemon, the
gateway and its client, the tenant router and its members (ROADMAP Queue 1,
item 13.8); importing one of their names raises :class:`ImportError`.
"""

from .journal import (
    CompactionResult,
    JournalDamage,
    JournalError,
    JournalRecord,
    JournalSnapshot,
    RequestJournal,
)

__all__ = [
    "CompactionResult",
    "JournalDamage",
    "JournalError",
    "JournalRecord",
    "JournalSnapshot",
    "RequestJournal",
]

_NOT_PORTED = (
    "AdmissionError",
    "DaemonStats",
    "Gateway",
    "GatewayClient",
    "GatewayError",
    "HttpTransport",
    "MEMBER_API_PREFIX",
    "STEER_KNOBS",
    "OptimizationService",
    "Rejection",
    "ServiceDaemon",
    "ServiceMember",
    "ServiceStats",
    "TenantClass",
    "TenantPack",
    "TenantRecord",
    "TenantRouter",
    "TenantSpec",
    "TenantStatus",
    "assign_fault_lane",
    "bucket_key",
    "encode_spec",
    "retry_after_seconds",
    "static_signature",
    "validate_tenant_id",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.service.{name} is not ported yet: the service, its daemon, gateway and router "
            f"come with ROADMAP Queue 1, item 13.8 (only the request journal is ported)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
