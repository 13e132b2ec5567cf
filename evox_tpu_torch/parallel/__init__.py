"""Population-parallel evaluation (counterpart of ``evox_tpu/parallel``).

The reference EvoX's contract on ``torch.distributed``: every rank steps
the same replicated algorithm state, evaluation is split by rows over a
:class:`PopMesh` of ranks, and one all-gather returns the fitness
(:class:`ShardedProblem`; ``StdWorkflow(enable_distributed=True)`` wraps
its problem in one).

Not ported yet: the multi-host fleet layer of ``parallel/multihost.py``
(``bootstrap_fleet``, heartbeats, ``FleetHealth`` and the rest, ROADMAP
Queue 1); importing one of its names raises :class:`ImportError`.
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
from .sharded_problem import ShardedProblem, find_sharded, iter_problem_chain

__all__ = [
    "ALL_GATHER",
    "PopMesh",
    "ShardedProblem",
    "all_gather_rows",
    "find_sharded",
    "init_multi_host",
    "iter_problem_chain",
    "make_pop_mesh",
    "pad_population",
    "padded_size",
    "population_mask",
    "replicate",
    "shard_population",
    "shard_row_ids",
    "unpad_fitness",
]

_NOT_PORTED = (
    "FleetHealth",
    "FleetReport",
    "FleetTopology",
    "HostHeartbeat",
    "HostVerdict",
    "bootstrap_fleet",
    "fleet_barrier",
    "gather_replicated",
    "is_primary",
    "read_heartbeats",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.parallel.{name} is not ported yet: it belongs to the multi-host fleet layer "
            f"(parallel/multihost.py, ROADMAP Queue 1), which needs the resilience runner"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
