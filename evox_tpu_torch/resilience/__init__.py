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
  :func:`check_topology`, :func:`remesh_state`, ...);
* the fleet supervisor of :mod:`.fleet` (:class:`FleetSupervisor`): it
  launches worker processes with the ``EVOX_TPU_FLEET_*`` bootstrap
  contract, watches their exit codes and heartbeats, stops and relaunches
  the survivors on a smaller world, which resume from the shared
  checkpoints bit for bit;
* the wire-side injector of :mod:`.transport` (:class:`FaultyTransport`,
  :class:`TransportError`): dropped, torn, duplicated and delayed
  requests and replies between the gateway client and its socket
  (ROADMAP item 13.8b, with the gateway).

* the invariant registry of :mod:`.invariants` (:data:`INVARIANTS`,
  :func:`audit_invariants` over an :class:`AuditContext`, each broken
  promise an :class:`InvariantViolation`) and the chaos conductor of
  :mod:`.chaos` (:class:`ChaosPlan`, :class:`ChaosConductor`,
  :class:`ChaosReport`, :func:`build_audit_context`): one seeded timeline
  of member and router kills, wire, disk and lane faults and partition
  windows over a routed fleet, audited between rounds (ROADMAP item
  13.8d).

The kill matrices and bit-identity comparators are ported in
:mod:`.testing`, imported explicitly as in the JAX package.
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
from .fleet import EX_PREEMPTED, FleetError, FleetStats, FleetSupervisor, WorkerSpec, free_coordinator_port
from .health import HealthProbe, HealthReport, scan_state
from .invariants import INVARIANTS, AuditContext, InvariantViolation, audit_invariants
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
from .transport import FaultyTransport, TransportError

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
    "FaultyTransport",
    "TransportError",
    "FleetSupervisor",
    "FleetError",
    "FleetStats",
    "WorkerSpec",
    "EX_PREEMPTED",
    "free_coordinator_port",
    "AuditContext",
    "InvariantViolation",
    "INVARIANTS",
    "audit_invariants",
    "ChaosPlan",
    "ChaosConductor",
    "ChaosReport",
    "build_audit_context",
]

# The conductor drives the routed serving fleet, so ``chaos.py`` imports
# ``evox_tpu_torch.service``, whose modules import this package's: it comes
# last, once every name they take from here is bound.
from .chaos import ChaosConductor, ChaosPlan, ChaosReport, build_audit_context  # noqa: E402

