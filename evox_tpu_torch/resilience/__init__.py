"""Run resilience (counterpart of ``evox_tpu/resilience``).

Ported: the state scan that the fused segments and
``StdWorkflow.health_metrics`` use (:func:`~.health.scan_state`, with the
per-shard metrics), and the elastic topology of :mod:`.elastic`
(:class:`MeshTopology`, :func:`check_topology`, :func:`remesh_state`, ...),
which ``utils.save_state``/``load_state`` record and gate with.

Not ported yet: the resilient runner and its retry, watchdog and
preemption machinery, the health probe and restart policies, fault
injection, the fleet supervisor and the chaos harness (ROADMAP Queue 1);
importing one of their names raises :class:`ImportError`.
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
from .health import scan_state

__all__ = [
    "MeshTopology",
    "check_topology",
    "current_topology",
    "remesh_state",
    "topology_differs",
    "workflow_mesh",
    "workflow_topology",
    "scan_state",
]

_NOT_PORTED = (
    "ResilientRunner", "RetryPolicy", "RunStats", "SegmentTiming", "CheckpointSkip", "ResilienceError",
    "WatchdogTimeout", "default_retryable", "latest_checkpoint", "scan_checkpoints", "PreemptionGuard",
    "Preempted", "HealthProbe", "HealthReport", "RestartPolicy", "RestartEvent", "RestartContext",
    "RollbackToCheckpoint", "ReinitLargerPopulation", "PerturbAroundBest", "incumbent_best",
    "perturb_prng_keys", "FaultyProblem", "FaultyStore", "FaultyTransport", "TransportError",
    "InjectedBackendError", "InjectedFatalError", "InjectedStorageError", "FleetSupervisor", "FleetError",
    "FleetStats", "WorkerSpec", "EX_PREEMPTED", "free_coordinator_port", "validate_schedule", "AuditContext",
    "InvariantViolation", "INVARIANTS", "audit_invariants", "ChaosPlan", "ChaosConductor", "ChaosReport",
    "build_audit_context",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.resilience.{name} is not ported yet: the runner, restart, fault-injection, fleet and "
            f"chaos layers come after the checkpoint plane (ROADMAP Queue 1)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
