"""Population-parallel evaluation (counterpart of ``evox_tpu/parallel``).

The reference EvoX's contract on ``torch.distributed``: every rank steps
the same replicated algorithm state, evaluation is split by rows over a
:class:`PopMesh` of ranks, and one all-gather returns the fitness
(:class:`ShardedProblem`; ``StdWorkflow(enable_distributed=True)`` wraps
its problem in one).

The multi-host fleet layer (:mod:`.multihost`): :func:`bootstrap_fleet`
joins a worker to its fleet from the ``EVOX_TPU_FLEET_*`` environment a
:class:`~evox_tpu_torch.resilience.FleetSupervisor` publishes;
:class:`HostHeartbeat` beats and :class:`FleetHealth` verdicts are the
supervisor's view of its hosts; :func:`is_primary` and
:func:`fleet_barrier` are what the resilient runner needs of a fleet
(:func:`gather_replicated`, the JAX package's boundary gather, is the
identity here: a rank's tensors are its own).
"""

from .mesh import (
    ALL_GATHER,
    PopMesh,
    all_gather_rows,
    init_multi_host,
    make_pop_mesh,
    pad_population,
    padded_size,
    population_mask,
    replicate,
    shard_population,
    shard_row_ids,
    unpad_fitness,
)
from .multihost import (
    FLEET_ENV_ATTEMPT,
    FLEET_ENV_COORDINATOR,
    FLEET_ENV_HEARTBEAT_DIR,
    FLEET_ENV_NUM_PROCESSES,
    FLEET_ENV_PROCESS_ID,
    FleetHealth,
    FleetReport,
    FleetTopology,
    HostHeartbeat,
    HostVerdict,
    bootstrap_fleet,
    fleet_barrier,
    gather_replicated,
    is_primary,
    read_heartbeats,
)
from .sharded_problem import ShardedProblem, find_sharded, iter_problem_chain

__all__ = [
    "ALL_GATHER",
    "FLEET_ENV_ATTEMPT",
    "FLEET_ENV_COORDINATOR",
    "FLEET_ENV_HEARTBEAT_DIR",
    "FLEET_ENV_NUM_PROCESSES",
    "FLEET_ENV_PROCESS_ID",
    "FleetHealth",
    "FleetReport",
    "FleetTopology",
    "HostHeartbeat",
    "HostVerdict",
    "PopMesh",
    "ShardedProblem",
    "all_gather_rows",
    "bootstrap_fleet",
    "find_sharded",
    "fleet_barrier",
    "gather_replicated",
    "init_multi_host",
    "is_primary",
    "iter_problem_chain",
    "make_pop_mesh",
    "pad_population",
    "padded_size",
    "population_mask",
    "read_heartbeats",
    "replicate",
    "shard_population",
    "shard_row_ids",
    "unpad_fitness",
]
