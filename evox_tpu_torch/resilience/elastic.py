"""Elastic topology: checkpoints that resume on another mesh (counterpart of
``evox_tpu/resilience/elastic.py``).

* :class:`MeshTopology` — a serializable record of the world a checkpoint
  was written under (mesh axis names and sizes, device kind, platform
  ``"gpu"`` or ``"cpu"``, device and process counts).  Every manifest of
  :func:`~evox_tpu_torch.utils.save_state` carries the process's own
  (meshless) record.
* :func:`check_topology` — the gate: a recorded mesh that differs from the
  current one raises a :class:`~evox_tpu_torch.utils.CheckpointError`
  naming both worlds when re-meshing is off, and checks divisibility when
  it is on.
* :func:`remesh_state` — places a restored state for a mesh: under the
  replicated contract every rank holds the whole state, so each leaf goes
  whole to this rank's device.

**Why a resume across meshes is bit for bit.**  Every checkpointed value
is global (whole populations, replicated algorithm state: the fitness is
gathered before anything is written), and
:class:`~evox_tpu_torch.parallel.ShardedProblem` folds each individual's
global slot, not its shard, into a keyed problem's stream: no value of the
trajectory depends on which rank computed it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch
import torch.distributed as dist

from ..utils import graph
from ..utils.checkpoint import CheckpointError

__all__ = [
    "MeshTopology",
    "current_topology",
    "workflow_topology",
    "workflow_mesh",
    "check_topology",
    "topology_differs",
    "remesh_state",
]

TOPOLOGY_KEY = "topology"


def _num_processes() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


@dataclass(frozen=True)
class MeshTopology:
    """The world a run executes (or was checkpointed) under.
    ``axis_names``/``axis_sizes`` are empty for a meshless run: the other
    fields then record where the checkpoint was written, which
    :func:`check_topology` treats as information, not a constraint."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device_kind: str
    platform: str
    num_devices: int
    num_processes: int

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_mesh(cls, mesh: Any) -> "MeshTopology":
        """The record of a :class:`~evox_tpu_torch.parallel.PopMesh` (or any
        object with its ``axis_names``, ``shape``, ``device_kind``,
        ``platform`` and ``size``)."""
        return cls(
            axis_names=tuple(str(n) for n in mesh.axis_names),
            axis_sizes=tuple(int(mesh.shape[n]) for n in mesh.axis_names),
            device_kind=str(getattr(mesh, "device_kind", "unknown")),
            platform=str(getattr(mesh, "platform", "unknown")),
            num_devices=int(getattr(mesh, "size", 1)),
            num_processes=_num_processes(),
        )

    @classmethod
    def from_manifest(cls, entry: Mapping[str, Any]) -> "MeshTopology":
        return cls(
            axis_names=tuple(entry.get("axis_names", ())),
            axis_sizes=tuple(int(s) for s in entry.get("axis_sizes", ())),
            device_kind=str(entry.get("device_kind", "unknown")),
            platform=str(entry.get("platform", "unknown")),
            num_devices=int(entry.get("num_devices", 0)),
            num_processes=int(entry.get("num_processes", 1)),
        )

    # -- queries -------------------------------------------------------------
    @property
    def meshed(self) -> bool:
        """Whether this world binds state to a mesh."""
        return bool(self.axis_names)

    @property
    def mesh_size(self) -> int:
        """Shards over all mesh axes (1 for a meshless world)."""
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def describe(self) -> str:
        if self.meshed:
            axes = ", ".join(f"{n}={s}" for n, s in zip(self.axis_names, self.axis_sizes))
            return f"{self.num_devices}-device {self.platform} mesh ({axes}; {self.num_processes} process(es))"
        return f"meshless {self.platform} world ({self.num_devices} device(s), {self.num_processes} process(es))"

    # -- manifest round trip -------------------------------------------------
    def to_manifest(self) -> dict[str, Any]:
        return {
            "axis_names": list(self.axis_names),
            "axis_sizes": list(self.axis_sizes),
            "device_kind": self.device_kind,
            "platform": self.platform,
            "num_devices": self.num_devices,
            "num_processes": self.num_processes,
        }


def current_topology() -> MeshTopology:
    """The meshless record of this process's world (what every
    :func:`~evox_tpu_torch.utils.save_state` manifest carries): the first
    card's name and ``"gpu"`` where CUDA is available, else ``"cpu"``."""
    if torch.cuda.is_available():
        kind, platform, count = torch.cuda.get_device_name(0), "gpu", torch.cuda.device_count()
    else:
        kind, platform, count = "cpu", "cpu", 1
    return MeshTopology(
        axis_names=(),
        axis_sizes=(),
        device_kind=kind,
        platform=platform,
        num_devices=int(count),
        num_processes=_num_processes(),
    )


def workflow_mesh(workflow: Any) -> tuple[Any, str] | None:
    """The ``(mesh, population_axis)`` a workflow evaluates over, if any:
    ``StdWorkflow``'s own ``mesh``/``pop_axis``, else the mesh of a
    ``ShardedProblem`` in its problem's wrapper chain."""
    from ..parallel import PopMesh, find_sharded

    mesh = getattr(workflow, "mesh", None)
    if isinstance(mesh, PopMesh):
        axis = getattr(workflow, "pop_axis", None) or mesh.axis_names[0]
        return mesh, str(axis)
    sharded = find_sharded(getattr(workflow, "problem", None))
    if sharded is not None:
        return sharded.mesh, str(sharded.axis_name)
    return None


def workflow_topology(workflow: Any) -> MeshTopology:
    """The topology a workflow's run binds to: its mesh when it evaluates
    distributed, else the meshless record of the process."""
    meshed = workflow_mesh(workflow)
    if meshed is not None:
        return MeshTopology.from_mesh(meshed[0])
    return current_topology()


def topology_differs(recorded: MeshTopology | None, current: MeshTopology | None) -> bool:
    """Do these two worlds bind state to different meshes?  Meshless on
    either side is never a difference (checkpointed state is global)."""
    return (
        recorded is not None
        and current is not None
        and recorded.meshed
        and current.meshed
        and (recorded.axis_names != current.axis_names or recorded.axis_sizes != current.axis_sizes)
    )


def check_topology(
    recorded: Mapping[str, Any] | MeshTopology | None,
    current: MeshTopology | None,
    *,
    remesh: bool = True,
    pop_size: int | None = None,
    pop_axis: str | None = None,
    context: str = "checkpoint",
) -> MeshTopology | None:
    """Gate a resume across a topology change.

    :param recorded: the manifest's ``topology`` entry (dict or
        :class:`MeshTopology`); ``None`` for an archive without one (no
        gate).
    :param current: the topology the resuming run executes under.
    :param remesh: whether a resume on another mesh is allowed; ``False``
        makes a mesh mismatch a :class:`CheckpointError` naming both worlds.
    :param pop_size: when known, the population size that must divide the
        current mesh's population axis.
    :param pop_axis: the population axis of a multi-axis mesh (default:
        the first axis).
    :param context: what the error messages name.
    :returns: the recorded topology, parsed, or ``None``.
    """
    if recorded is None:
        return None
    if not isinstance(recorded, MeshTopology):
        recorded = MeshTopology.from_manifest(recorded)
    mismatch = topology_differs(recorded, current)
    if mismatch and not remesh:
        raise CheckpointError(
            f"{context} was written on a {recorded.describe()} but this run "
            f"executes on a {current.describe()}, and re-meshing is "
            f"disabled — resume on the original topology, or enable "
            f"re-meshing (load_state(..., remesh=True)) to repartition the state"
        )
    if mismatch and pop_size is not None:
        # Only the population axis governs divisibility.
        if pop_axis is not None and pop_axis in current.axis_names:
            n_shards = current.axis_sizes[current.axis_names.index(pop_axis)]
        else:
            n_shards = current.axis_sizes[0]
        if pop_size % n_shards != 0:
            raise CheckpointError(
                f"{context} re-mesh from a {recorded.describe()} onto a "
                f"{current.describe()} is impossible for population size "
                f"{pop_size}: it does not divide the {n_shards}-way "
                f"population axis — resume on a mesh whose population axis "
                f"divides {pop_size}, or enable population padding "
                f"(ShardedProblem(pad=True))"
            )
    return recorded


def remesh_state(state: Any, mesh: Any, axis_name: str | None = None, pop_size: int | None = None) -> Any:
    """Place a (restored) state for ``mesh``: every tensor leaf, whole, on
    this rank's device (``mesh.device``).  Under the replicated contract
    every rank holds the global state and a sharded evaluation takes its
    row block at each evaluation, so nothing is split here.  A rank
    outside the mesh gets ``state`` back.  ``axis_name`` and ``pop_size``
    are accepted for the JAX signature; the divisibility gate is
    :func:`check_topology`'s."""
    del axis_name, pop_size
    if getattr(mesh, "shard_index", 0) is None:
        return state
    device = mesh.device
    leaves, spec = graph.flatten(state)
    return graph.unflatten(spec, [t.to(device) for t in leaves])
