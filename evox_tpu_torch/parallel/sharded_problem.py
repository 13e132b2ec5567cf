"""Sharded-evaluation Problem wrapper (counterpart of
``evox_tpu/parallel/sharded_problem.py``).

:class:`ShardedProblem` wraps any problem so its ``evaluate`` runs on this
rank's block of the population and one all-gather over the mesh's process
group returns the whole fitness, the same on every rank.  ``StdWorkflow``'s
``enable_distributed=True`` wraps its problem in one; custom workflows and
the HPO wrapper can compose it directly.

**Topology invariance.**  A keyed problem (one whose state carries a
top-level ``key``) evaluates each individual under the key
``rng.fold_in(key, global_slot)``, its row in the whole population, not
the index of the shard that evaluates it.  The evaluation is then a pure
function of ``(key, slot, individual)``: any mesh size, one rank included,
gives every individual the same stream, so a checkpoint written on one
mesh resumes on another with the same trajectory
(:mod:`evox_tpu_torch.resilience.elastic`).  The inner ``evaluate`` then
sees one-row populations (under ``torch.func.vmap``); a keyed problem whose
fitness depends on the whole batch opts out with
``per_individual_keys=False`` and gets whole-shard batches under
``fold_in(key, shard_index)``, whose streams depend on the mesh size.

**HPO instances over a mesh.**  Over a nested problem
(:class:`~evox_tpu_torch.hpo.NestedProblem` or
:class:`~evox_tpu_torch.problems.hpo_wrapper.HPOProblemWrapper`) the split
is the candidates axis, the natural unit of HPO parallelism: each rank takes
its contiguous block of the hyper-parameters and of the state's
``instances`` and ``uids``, runs the block through the nest's vmap, and one
all-gather returns the ``(num_candidates,)`` fitness on every rank.  The
state that comes back is the whole nest's on every rank: the instances as
the nest leaves them, the uids, and the latest evaluation's telemetry,
gathered row block by row block.  A candidate's inner streams were fixed
at setup (``fold_in(key, uid)`` or the wrapper's split schedule), so no
split changes a candidate's run: any mesh, one rank included, gives the
unsharded nest's fitness bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import Problem, State
from ..utils import graph, rng
from .mesh import PopMesh, all_gather_rows, pad_population, unpad_fitness

__all__ = ["ShardedProblem", "find_sharded", "iter_problem_chain"]

# The word folded into a keyed state's key after every sharded evaluation.
_ADVANCE = 0x5EED


def iter_problem_chain(problem):
    """Yield ``problem`` and every problem it wraps (wrappers keep their
    inner problem under ``.problem``), cycle-safe: the one walk every layer
    uses to see through wrapper composition (workflow shard discovery, the
    elastic topology, the HPO nest's lookup)."""
    seen: set[int] = set()
    p = problem
    while p is not None and id(p) not in seen:
        seen.add(id(p))
        yield p
        p = getattr(p, "problem", None)


def find_sharded(problem) -> "ShardedProblem | None":
    """The :class:`ShardedProblem` a problem evaluates through (itself or
    anywhere down its wrapper chain); ``None`` when evaluation is
    unsharded."""
    for p in iter_problem_chain(problem):
        if isinstance(p, ShardedProblem):
            return p
    return None


class ShardedProblem(Problem):
    """Wraps a Problem so evaluation is population-sharded over a mesh."""

    def __init__(
        self,
        problem: Problem,
        mesh: PopMesh,
        axis_name: str = "pop",
        pad: bool = False,
        per_individual_keys: bool = True,
    ):
        """
        :param problem: the inner problem.
        :param mesh: a :class:`~evox_tpu_torch.parallel.PopMesh` with
            ``axis_name`` as its axis; every rank of the mesh must evaluate
            the same population (the replicated-state contract).
        :param axis_name: the mesh axis the population's leading axis is
            split over; the population size must divide its size unless
            ``pad`` is set.
        :param pad: pad a population that does not divide (repeating the
            last row) and drop the padding from the fitness, instead of
            raising the divisibility ``ValueError``.
        :param per_individual_keys: how a keyed inner problem is
            decorrelated (see the module docstring): ``True`` evaluates each
            individual under ``fold_in(key, global_slot)``, topology
            invariant, with one-row populations; ``False`` evaluates whole
            shards under ``fold_in(key, shard_index)``.
        """
        self.problem = problem
        self.mesh = mesh
        self.axis_name = axis_name
        self.pad = bool(pad)
        self.per_individual_keys = bool(per_individual_keys)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold an evaluation: the inner problem's
        must be capturable, and the all-gather must be NCCL's (a gloo
        collective runs on the host)."""
        group = getattr(self.mesh, "group", None)
        nccl = group is None or dist.get_backend(group) == "nccl"
        return nccl and bool(getattr(self.problem, "capturable", True))

    def setup(self, key: torch.Tensor) -> State:
        return self.problem.setup(key)

    def _block(self, rows):
        """This rank's contiguous block of ``rows`` (a tensor or a nest of
        tensors with a leading population axis), padded first when
        ``pad`` is set and the size does not divide: ``(block, lo, size)``,
        ``lo`` the block's first row in the whole population and ``size``
        the unpadded size."""
        mesh, axis = self.mesh, self.axis_name
        n_shards = mesh.shape[axis]
        leaves, _ = graph.flatten(rows)
        pop_size = leaves[0].shape[0]
        if pop_size % n_shards != 0:
            if not self.pad:
                raise ValueError(
                    f"population size {pop_size} must divide over the "
                    f"{n_shards}-way '{axis}' mesh axis "
                    f"(mesh shape: {dict(mesh.shape)}); pad the "
                    f"population or choose a pop_size that is a multiple of "
                    f"{n_shards}"
                )
            rows, _ = pad_population(rows, n_shards)
        index = mesh.shard_index
        if index is None:
            raise ValueError(f"this rank is outside the {n_shards}-way '{axis}' mesh: it evaluates nothing")
        padded, spec = graph.flatten(rows)
        local_n = padded[0].shape[0] // n_shards
        lo = index * local_n
        return graph.unflatten(spec, [t[lo:lo + local_n] for t in padded]), lo, pop_size

    def _gather(self, block: torch.Tensor, size: int) -> torch.Tensor:
        """The mesh's row blocks of ``block``'s kind, whole and unpadded
        (a bool block travels as bytes)."""
        if block.dtype == torch.bool:
            return self._gather(block.view(torch.uint8), size).view(torch.bool)
        return unpad_fitness(all_gather_rows(block, self.mesh), size)

    def evaluate(self, state: State, pop) -> tuple[torch.Tensor, State]:
        if torch._C._functorch.peek_interpreter_stack() is not None:
            raise NotImplementedError(
                "ShardedProblem.evaluate under torch.func.vmap is refused: the all-gather takes unbatched "
                "tensors.  To split HPO instances over a mesh, shard the nest itself: "
                "ShardedProblem(NestedProblem(...) or HPOProblemWrapper(...), mesh) splits its candidates"
            )
        from ..hpo.nested import NestedProblem

        if isinstance(self.problem, NestedProblem):
            return self._evaluate_nest(state, pop)
        block, lo, pop_size = self._block(pop)
        leaves, spec = graph.flatten(block)
        local_n = leaves[0].shape[0]
        index = self.mesh.shard_index
        keyed = "key" in state
        if keyed and self.per_individual_keys:
            slots = torch.arange(lo, lo + local_n, dtype=torch.int64, device=state.key.device)

            def eval_one(slot, row):
                one = graph.unflatten(spec, [t[None] for t in graph.flatten(row)[0]])
                fit, _ = self.problem.evaluate(state.replace(key=rng.fold_in(state.key, slot)), one)
                return fit[0]

            fit = torch.func.vmap(eval_one)(slots, block)
        elif keyed:
            shard = torch.full((), index, dtype=torch.int64, device=state.key.device)
            fit, _ = self.problem.evaluate(state.replace(key=rng.fold_in(state.key, shard)), block)
        else:
            fit, _ = self.problem.evaluate(state, block)
        fit = self._gather(fit, pop_size)
        if keyed:
            word = torch.full((), _ADVANCE, dtype=torch.int64, device=state.key.device)
            state = state.replace(key=rng.fold_in(state.key, word))
        return fit, state

    def _evaluate_nest(self, state: State, hyper_parameters) -> tuple[torch.Tensor, State]:
        """A nested problem's evaluation split over its candidates (see the
        module docstring): this rank's rows of the hyper-parameters, the
        instances, the uids and the telemetry go through the nest, and the
        fitness and the new telemetry are gathered whole."""
        telemetry = "telemetry" in state
        rows = (dict(hyper_parameters), state.instances, state.uids, state.telemetry if telemetry else None)
        (hp, instances, uids, tel), _, size = self._block(rows)
        sub = state.replace(instances=instances, uids=uids, **({"telemetry": tel} if telemetry else {}))
        fit, sub = self.problem.evaluate(sub, hp)
        fit = self._gather(fit, size)
        if telemetry:
            leaves, spec = graph.flatten(sub.telemetry)
            state = state.replace(telemetry=graph.unflatten(spec, [self._gather(t, size) for t in leaves]))
        return fit, state
