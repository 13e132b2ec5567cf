"""Process-group helpers for population-parallel evaluation (counterpart of
``evox_tpu/parallel/mesh.py``).

The reference EvoX's distributed mode is ``torchrun`` plus
``init_process_group`` and one NCCL ``all_gather`` of the fitness: every
rank steps the same replicated algorithm state, evaluation is split by
rows, and the gathered fitness is the same on every rank.  The port keeps
that contract on ``torch.distributed``:

* :func:`init_multi_host` — one call per process (``init_process_group``;
  NCCL on the card, gloo when the caller asks for the CPU or when the
  ranks of one host outnumber its cards);
* :func:`make_pop_mesh` — a 1-D :class:`PopMesh` over the first ``n``
  ranks of the world, with the population axis as its only axis; with no
  process group it sets up a one-rank group itself, so a distributed
  workflow runs on one card;
* :func:`shard_population` / :func:`replicate` — this rank's row block of
  a population, and a state broadcast from the mesh's first rank;
* :func:`pad_population` / :func:`population_mask` /
  :func:`shard_row_ids` / :func:`unpad_fitness` / :func:`padded_size` —
  the divisibility shims and the row -> shard map, plain tensor functions
  with the JAX package's values.

The fitness all-gather is :func:`all_gather_rows`; it calls
:data:`ALL_GATHER` (``torch.distributed.all_gather_single`` where the
installed torch has it, else ``all_gather_into_tensor``, the same
collective under its older name).
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils import graph

__all__ = [
    "ALL_GATHER",
    "PopMesh",
    "all_gather_rows",
    "init_multi_host",
    "make_pop_mesh",
    "shard_population",
    "replicate",
    "padded_size",
    "pad_population",
    "population_mask",
    "shard_row_ids",
    "unpad_fitness",
]

# The fitness all-gather: ``all_gather_single`` where torch has it (newer
# releases deprecate the older name in its favour), else
# ``all_gather_into_tensor``; both take ``(output, input, group=)``.
ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


# The default group :func:`init_multi_host` made and the device it
# returned: a gloo group's ranks compute there (their card when they share
# one), and :func:`make_pop_mesh` puts its mesh there.
_joined: tuple[Any, torch.device] | None = None


def init_multi_host(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device | None = None,
    timeout: float | None = None,
) -> torch.device:
    """Join this process to the run's process group (the port's
    ``init_process_group``; call once per process before building a mesh).

    :param coordinator_address: ``host:port`` of rank 0's TCP store, or an
        ``init_method`` URL (``file:///path`` for a file store every rank
        can reach); without it the address, world size and rank come from
        the environment ``torchrun`` sets (``MASTER_ADDR``,
        ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
    :param num_processes, process_id: the world size and this process's
        rank (the environment's when omitted).
    :param device: where this process computes: the CUDA card (default) or
        ``"cpu"``.  On the card the rank's device is
        ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from the environment, else the
        rank modulo the visible cards); it is made current before the group
        exists.  The group is NCCL when every rank of the host
        (``LOCAL_WORLD_SIZE``, else the world) has a card of its own, and
        the NCCL communicator is created now (``device_id=``), not at the
        first collective: a collective captured in a CUDA graph cannot
        create one.  Ranks that share a card join a gloo group (NCCL
        refuses two ranks of one communicator on one device) and still
        compute on their card: :func:`make_pop_mesh` puts their mesh there.
        On the CPU the group is gloo.
    :param timeout: seconds the rendezvous and every later collective may
        wait for a peer (torch's default when omitted: minutes).
    :returns: this rank's device.
    """
    dev = resolve_device(device)
    rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    world = int(num_processes if num_processes is not None else os.environ.get("WORLD_SIZE", 1))
    kwargs: dict[str, Any] = {"backend": _backend_for(dev), "rank": rank, "world_size": world}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
    elif "://" in coordinator_address:
        kwargs["init_method"] = coordinator_address
    else:
        kwargs["init_method"] = f"tcp://{coordinator_address}"
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    if dev.type == "cuda":
        cards = max(torch.cuda.device_count(), 1)
        local = int(os.environ.get("LOCAL_RANK", rank % cards))
        dev = torch.device("cuda", local if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) > cards:
            kwargs["backend"] = "gloo"
        else:
            kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)
    global _joined
    _joined = (dist.group.WORLD, dev)
    return dev


def _init_one_rank(dev: torch.device) -> None:
    """A one-rank process group over a file store in a fresh temporary
    directory (no network address, so nothing can collide)."""
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(prefix="evox_tpu_torch_pg_"), "store"), 1)
    kwargs: dict[str, Any] = {"backend": _backend_for(dev), "store": store, "rank": 0, "world_size": 1}
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(**kwargs)


class PopMesh:
    """A 1-D mesh of ranks over the population axis: ranks
    ``0 .. n - 1`` of the world, one device each.

    It exposes what the JAX package's code reads of a ``Mesh``:
    ``shape[axis_name]`` and ``axis_names``; and what the collectives need:
    ``group`` (the process group of its ranks), ``ranks`` (their global
    ranks), ``shard_index`` (this rank's index on the axis, ``None`` for a
    rank outside the mesh) and ``device`` (where this rank's tensors
    live: its card under NCCL; under gloo, the device
    :func:`init_multi_host` returned, else the CPU).  PyTorch's
    ``DeviceMesh`` is not used: it is built over the whole world, and a
    mesh over the first ``n`` ranks needs a group of its own, which
    :func:`torch.distributed.new_group` makes directly."""

    def __init__(self, group: Any, ranks: tuple[int, ...], axis_name: str, device: torch.device):
        self.group = group
        self.ranks = tuple(ranks)
        self.axis_name = str(axis_name)
        self.axis_names = (self.axis_name,)
        self.shape = {self.axis_name: len(self.ranks)}
        self.device = device
        rank = dist.get_rank()
        self.shard_index = self.ranks.index(rank) if rank in self.ranks else None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def platform(self) -> str:
        return "gpu" if self.device.type == "cuda" else "cpu"

    @property
    def device_kind(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def __repr__(self) -> str:
        return f"PopMesh({self.axis_name}={self.size}, ranks={list(self.ranks)}, device={self.device})"


def _group_device() -> torch.device:
    """This rank's compute device under the initialised default group: the
    current card for NCCL; for a gloo group that :func:`init_multi_host`
    made, the device it returned; for any other gloo group, the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    if _joined is not None and _joined[0] is dist.group.WORLD:
        return _joined[1]
    return torch.device("cpu")


def make_pop_mesh(
    n_devices: int | None = None,
    axis_name: str = "pop",
    *,
    device: str | torch.device | None = None,
) -> PopMesh:
    """A 1-D :class:`PopMesh` over the first ``n_devices`` ranks of the
    world (default: all), with the population axis as its only axis.

    With no process group, a one-rank group is set up here (a file store in
    a temporary directory; NCCL on the card, gloo on the CPU), so
    ``StdWorkflow(..., enable_distributed=True)`` runs on one device, the
    collective included.  ``device`` chooses that group's backend
    (default: the card).  With a group already set up, the group decides
    the device: NCCL's current card; for a gloo group of
    :func:`init_multi_host`, the device it returned (the card of ranks
    that share one); for any other gloo group, the CPU.  A mesh of fewer
    ranks than the world is a new process group: every rank of the world
    must call this function with the same ``n_devices`` (the ranks outside
    get a mesh with ``shard_index=None``)."""
    if not dist.is_initialized():
        _init_one_rank(resolve_device(device))
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks needs 1 <= n <= the world size {world}")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(ranks=list(ranks))
    return PopMesh(group, ranks, axis_name, _group_device())


def _map_tensors(fn, tree: Any) -> Any:
    leaves, spec = graph.flatten(tree)
    return graph.unflatten(spec, [fn(t) for t in leaves])


def _leading(tree: Any) -> int:
    leaves, _ = graph.flatten(tree)
    if not leaves:
        raise ValueError("a population needs at least one tensor")
    return leaves[0].shape[0]


def shard_population(pop: Any, mesh: PopMesh, axis_name: str = "pop") -> Any:
    """This rank's contiguous row block of a population (a tensor or a nest
    of tensors with a leading population axis), as :func:`shard_row_ids`
    assigns rows to shards.

    JAX returns a global array whose rows live on the mesh's devices; a
    rank here holds only its own block (views of ``pop``'s rows, empty for
    a rank outside the mesh)."""
    n_shards = mesh.shape[axis_name]
    size = _leading(pop)
    block = padded_size(size, n_shards) // n_shards
    index = mesh.shard_index
    lo = size if index is None else min(index * block, size)
    hi = min(lo + block, size)
    return _map_tensors(lambda t: t[lo:hi], pop)


def replicate(state: Any, mesh: PopMesh) -> Any:
    """Every tensor of ``state`` as the mesh's first rank holds it (a
    broadcast over the mesh's group; new tensors, ``state`` unchanged) —
    the replicated-state contract: every rank steps the same algorithm
    state.  A rank outside the mesh gets ``state`` back."""
    if mesh.shard_index is None:
        return state

    def bcast(t: torch.Tensor) -> torch.Tensor:
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=mesh.ranks[0], group=mesh.group)
        return out

    return _map_tensors(bcast, state)


def padded_size(pop_size: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` that fits ``pop_size`` rows."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return -(-pop_size // n_shards) * n_shards


def pad_population(pop: Any, n_shards: int) -> tuple[Any, torch.Tensor]:
    """Pad a population's leading axis (a tensor or a nest of tensors) up to
    a multiple of ``n_shards``, repeating the last real row (valid domain
    values, so any problem evaluates them), and return ``(padded, mask)``
    with ``mask`` a bool ``(padded_size,)`` tensor, ``True`` for real rows.
    A size that divides comes back unchanged with an all-``True`` mask."""
    leaves, _ = graph.flatten(pop)
    if not leaves:
        raise ValueError("pad_population needs a non-empty population pytree")
    pop_size = leaves[0].shape[0]
    target = padded_size(pop_size, n_shards)
    mask = torch.arange(target, device=leaves[0].device) < pop_size
    if target == pop_size:
        return pop, mask
    n_pad = target - pop_size

    def pad_leaf(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != pop_size:
            raise ValueError(
                f"population leaves disagree on the leading axis: expected "
                f"{pop_size}, found {x.shape[0]} (shape {tuple(x.shape)})"
            )
        return torch.cat([x, x[-1:].expand((n_pad,) + tuple(x.shape[1:]))], dim=0)

    return _map_tensors(pad_leaf, pop), mask


def shard_row_ids(n_rows: int, n_shards: int, device: str | torch.device | None = "cpu") -> torch.Tensor:
    """The shard owning each population row (int64 ``(n_rows,)``):
    contiguous blocks of ``ceil(n_rows / n_shards)`` rows, so a ragged tail
    (``pad_population``) maps as the sharded evaluation distributes it.
    The one definition of the row -> shard map: shard-granular quarantine
    and the per-shard health metrics read it."""
    return torch.arange(n_rows, device=device) // (padded_size(n_rows, n_shards) // n_shards)


def population_mask(pop_size: int, n_shards: int, device: str | torch.device | None = "cpu") -> torch.Tensor:
    """The mask :func:`pad_population` would attach for ``(pop_size,
    n_shards)``, without building the padded population."""
    return torch.arange(padded_size(pop_size, n_shards), device=device) < pop_size


def unpad_fitness(fit: torch.Tensor, pop_size: int) -> torch.Tensor:
    """Drop the padded tail rows of a fitness tensor (``(n,)`` or
    ``(n, m)``)."""
    return fit[:pop_size]


def all_gather_rows(local: torch.Tensor, mesh: PopMesh) -> torch.Tensor:
    """The mesh's row blocks, in shard order, concatenated along the
    leading axis: one :data:`ALL_GATHER` over the mesh's group into a fresh
    tensor on ``local``'s device.  Every rank of the mesh must call it
    with a block of the same shape.  On the card under NCCL the collective
    runs on the current stream's order, so it is captured with the
    generation into a CUDA graph; the communicator must exist before the
    capture (a warm-up call, or :func:`init_multi_host`'s ``device_id``).
    Gloo takes blocks on the card too (it copies them through the host
    itself); it cannot be captured."""
    local = local.contiguous()
    out = torch.empty((mesh.size * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
    ALL_GATHER(out, local, group=mesh.group)
    return out
