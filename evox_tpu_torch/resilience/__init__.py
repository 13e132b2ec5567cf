"""Run resilience (counterpart of ``evox_tpu/resilience``).

Ported:

* :class:`ResilientRunner` (``runner.py``) — fused segments (one replay of
  a captured CUDA graph each on the card), periodic atomic checkpoints
  through the pinned-buffer async writer, auto-resume from the newest
  valid checkpoint with quarantine of damaged ones, retry with exponential
  backoff, a watchdog that waits on CUDA events, health probes and restart
  policies, cooperative preemption;
* :class:`HealthProbe` / :class:`HealthReport` and the state scan
  (:func:`~.health.scan_state`) that fused segments use;
* the restart policies (:class:`RollbackToCheckpoint`,
  :class:`ReinitLargerPopulation`, :class:`PerturbAroundBest`) with their
  lineage records;
* :class:`PreemptionGuard` / :class:`Preempted`;
* fault injection: :class:`FaultyProblem` (device faults inside a
  captured segment, host faults on an eager one) and :class:`FaultyStore`,
  with :func:`validate_schedule`;
* the elastic topology of :mod:`.elastic` (:class:`MeshTopology`,
  :func:`check_topology`, :func:`remesh_state`, ...).

Not ported yet: the fleet supervisor, the wire-side injector, the
invariant registry and the chaos harness (ROADMAP Queue 1); importing one
of their names raises :class:`ImportError`.
"""

from .elastic import (
    MeshTopology,
    check_topology,
    current_topology,
    remesh_state,
    topology_differs,
    workflow_mesh,
    workflow_topology,
)
from .faults import (
    FaultyProblem,
    FaultyStore,
    InjectedBackendError,
    InjectedFatalError,
    InjectedStorageError,
)
from .health import HealthProbe, HealthReport, scan_state
from .preemption import Preempted, PreemptionGuard
from .restart import (
    PerturbAroundBest,
    ReinitLargerPopulation,
    RestartContext,
    RestartEvent,
    RestartPolicy,
    RollbackToCheckpoint,
    incumbent_best,
    perturb_prng_keys,
)
from .runner import (
    CheckpointSkip,
    ResilienceError,
    ResilientRunner,
    RetryPolicy,
    RunStats,
    SegmentTiming,
    WatchdogTimeout,
    default_retryable,
    latest_checkpoint,
    scan_checkpoints,
)
from .schedule import validate_schedule

__all__ = [
    "MeshTopology",
    "check_topology",
    "current_topology",
    "remesh_state",
    "topology_differs",
    "workflow_mesh",
    "workflow_topology",
    "scan_state",
    "ResilientRunner",
    "RetryPolicy",
    "RunStats",
    "SegmentTiming",
    "CheckpointSkip",
    "ResilienceError",
    "WatchdogTimeout",
    "default_retryable",
    "latest_checkpoint",
    "scan_checkpoints",
    "PreemptionGuard",
    "Preempted",
    "HealthProbe",
    "HealthReport",
    "RestartPolicy",
    "RestartEvent",
    "RestartContext",
    "RollbackToCheckpoint",
    "ReinitLargerPopulation",
    "PerturbAroundBest",
    "incumbent_best",
    "perturb_prng_keys",
    "FaultyProblem",
    "FaultyStore",
    "InjectedBackendError",
    "InjectedFatalError",
    "InjectedStorageError",
    "validate_schedule",
]

_FLEET = ("FleetSupervisor", "FleetError", "FleetStats", "WorkerSpec", "EX_PREEMPTED", "free_coordinator_port")
_CHAOS = (
    "FaultyTransport",
    "TransportError",
    "AuditContext",
    "InvariantViolation",
    "INVARIANTS",
    "audit_invariants",
    "ChaosPlan",
    "ChaosConductor",
    "ChaosReport",
    "build_audit_context",
)
_NOT_PORTED = _FLEET + _CHAOS


def __getattr__(name: str):
    if name in _FLEET:
        raise ImportError(
            f"evox_tpu_torch.resilience.{name} is not ported yet: the fleet supervisor needs multi-host "
            f"fleets (ROADMAP Queue 1, item 13.7)"
        )
    if name in _CHAOS:
        raise ImportError(
            f"evox_tpu_torch.resilience.{name} is not ported yet: the wire-side injector and the invariant "
            f"registry (ROADMAP Queue 1, item 13.3: transport.py, invariants.py) and the chaos harness "
            f"(item 13.8: chaos.py)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
