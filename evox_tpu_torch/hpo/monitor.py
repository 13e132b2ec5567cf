"""HPO inner-run monitors (counterpart of ``evox_tpu/hpo/monitor.py``): how
an inner workflow reports its score.

The meta-optimization contract: the inner workflow's monitor exposes the
run's final score through ``tell_fitness(state)``; that scalar (or
per-objective vector) is the outer problem's fitness for the
hyper-parameter set the run evaluated.

``num_repeats`` semantics are the JAX package's: with repeats, the
*algorithm* of each repeat lane adapts on its own raw fitness, while the
*monitor* aggregates the fitness across repeats **inside every generation**
(the mean by default) before updating its best.  JAX reduces over the named
vmap axis :data:`HPO_REPEAT_AXIS` with ``lax.all_gather``.
``torch.func.vmap`` has no named axes and no collectives, so here the
reduction is an operator with a batching rule
(:func:`~evox_tpu_torch.utils.vmap_ops.register_vmap_op`):

* :class:`~evox_tpu_torch.hpo.NestedProblem` binds the repeat axis by
  recording the functorch level of its repeat vmap in a context variable
  (the counterpart of ``axis_name=HPO_REPEAT_AXIS``);
* the operator's rule, at that level, reduces the fitness over the level's
  batch dimension with ordinary tensor operations and broadcasts the result
  back to every lane.  An outer level (the candidates) batches those
  operations like any others, so nothing is reduced across candidates; a
  level inside the repeat vmap passes the call on outward;
* with no repeat axis bound (the monitor standalone, or under
  ``aggregation="final"``) the monitor gets the raw per-lane fitness, as
  JAX's ``NameError`` branch gives.
"""

from __future__ import annotations

import contextvars
from typing import Callable

import torch
from torch._C._functorch import maybe_current_level

from ..core import Monitor, State
from ..utils.vmap_ops import register_vmap_op

__all__ = ["HPOMonitor", "HPOFitnessMonitor", "HPO_REPEAT_AXIS"]

#: Name of the repeats axis inside :meth:`NestedProblem.evaluate
#: <evox_tpu_torch.hpo.NestedProblem.evaluate>` (the JAX package's vmap
#: axis name); HPO monitors reduce over it.
HPO_REPEAT_AXIS = "hpo_repeat"

#: Repeat wiring ``(num_repeats, fit_aggregation)`` installed by
#: :meth:`NestedProblem.evaluate` for the duration of its run.  A
#: ``ContextVar`` (not attribute mutation on the shared monitor object), so
#: concurrent runs in different contexts cannot observe each other's wiring
#: and nested wrappers (HPO of HPO) save and restore it by token.
_REPEAT_WIRING: contextvars.ContextVar[tuple[int, Callable] | None] = contextvars.ContextVar(
    "hpo_repeat_wiring", default=None
)

#: The functorch level of the vmap that carries :data:`HPO_REPEAT_AXIS`, set
#: inside the repeat vmap of :meth:`NestedProblem.evaluate` (``None``: the
#: axis is not bound).
_REPEAT_LEVEL: contextvars.ContextVar[int | None] = contextvars.ContextVar("hpo_repeat_level", default=None)


def _reduce_axis(fn: Callable, arr: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply a repeats reduction.  The preferred contract is ``fn(arr,
    axis=...)`` (like ``torch.mean``); a 1-D reducer ``fn(vec) -> scalar``
    is accepted too and applied to every 1-D slice along ``axis``."""
    try:
        return fn(arr, axis=axis)
    except TypeError:
        moved = arr.movedim(axis, -1)
        rows = moved.reshape(-1, moved.shape[-1])
        return torch.stack([fn(row) for row in rows.unbind(0)]).reshape(moved.shape[:-1])


def _all_gather_rule(info, in_dims, fitness, level):
    """At the repeat level: every lane gets the reduction over the level's
    batch dimension.  At a level inside the repeat vmap: the call goes on to
    the next level out, batch dimension unchanged."""
    dim = in_dims[0]
    if maybe_current_level() != level:
        return _all_gather_reduce(fitness, level), dim
    _, fit_aggregation = _REPEAT_WIRING.get()
    stacked = fitness.movedim(dim, 0)
    reduced = _reduce_axis(fit_aggregation, stacked, 0)
    return reduced.unsqueeze(0).expand(stacked.shape).contiguous(), 0


@register_vmap_op(vmap_fn=_all_gather_rule, name="hpo_all_gather_reduce")
def _all_gather_reduce(fitness: torch.Tensor, level: int) -> torch.Tensor:
    # Reached only where no vmap level batches the fitness: nothing to
    # gather (an operator may not return its input, hence the copy).
    del level
    return fitness.clone()


class HPOMonitor(Monitor):
    """Base monitor for HPO inner workflows: exposes the inner run's final
    score through ``tell_fitness``.

    Subclasses aggregate each generation's fitness across repeats by calling
    :meth:`aggregate_repeats` in ``pre_tell``, never by reading
    ``self.num_repeats``: inside a :class:`~evox_tpu_torch.hpo.NestedProblem`
    evaluation the wrapper's context-local wiring (repeat count and
    reduction) takes precedence over the constructor values, and only
    ``aggregate_repeats`` sees it.

    :param num_repeats: repeat count used when the monitor runs standalone
        (outside a wrapper's evaluation).
    :param fit_aggregation: reduction over the repeats axis, called as
        ``fit_aggregation(stacked, axis=0)`` (default ``torch.mean``).
    """

    def __init__(self, num_repeats: int = 1, fit_aggregation: Callable = torch.mean):
        self.num_repeats = num_repeats
        self.fit_aggregation = fit_aggregation

    def aggregate_repeats(self, fitness: torch.Tensor) -> torch.Tensor:
        """Cross-repeat aggregation of this generation's fitness.  Inside the
        wrapper's repeat vmap every lane receives the same aggregated tensor
        (the operator's batching rule, see the module docstring); with no
        repeat axis bound, the raw per-lane fitness.

        Repeat wiring installed by a surrounding
        :meth:`NestedProblem.evaluate` (the context-local ``_REPEAT_WIRING``)
        takes precedence over the constructor attributes, so one monitor
        instance can serve several wrappers."""
        wiring = _REPEAT_WIRING.get()
        num_repeats = wiring[0] if wiring is not None else self.num_repeats
        if num_repeats <= 1:
            return fitness
        level = _REPEAT_LEVEL.get()
        if level is None:
            # The repeat axis is bound only inside NestedProblem's
            # per-generation repeat vmap; standalone or under "final" the
            # monitor sees the raw per-lane fitness.
            return fitness
        return _all_gather_reduce(fitness, level)

    def tell_fitness(self, state: State) -> torch.Tensor:
        """The scalar (or per-objective) fitness this inner run reports to
        the outer algorithm.  Abstract: subclasses define what "fitness of a
        run" means (e.g. best so far)."""
        raise NotImplementedError("`tell_fitness` function is not implemented. It must be overwritten.")


class HPOFitnessMonitor(HPOMonitor):
    """Tracks the best fitness value the inner workflow has seen."""

    def __init__(
        self,
        multi_obj_metric: Callable | None = None,
        num_repeats: int = 1,
        fit_aggregation: Callable = torch.mean,
    ):
        """
        :param multi_obj_metric: scalarizing metric for multi-objective inner
            problems, e.g. ``lambda f: igd(f, problem.pf())``; unused for
            single-objective ones.
        """
        if multi_obj_metric is not None and not callable(multi_obj_metric):
            raise ValueError(f"Expect `multi_obj_metric` to be `None` or callable, got {multi_obj_metric}")
        super().__init__(num_repeats, fit_aggregation)
        self.multi_obj_metric = multi_obj_metric

    def setup(self, key: torch.Tensor) -> State:
        # On the key's device: the workflow's keys live on its algorithm's.
        device = key.device if isinstance(key, torch.Tensor) else None
        return State(best_fitness=torch.full((), float("inf"), device=device))

    def pre_tell(self, state: State, fitness: torch.Tensor) -> State:
        fitness = self.aggregate_repeats(fitness)
        if fitness.ndim == 1:
            value = torch.amin(fitness)
        else:
            value = self.multi_obj_metric(fitness)
        return state.replace(best_fitness=torch.minimum(value, state.best_fitness))

    def tell_fitness(self, state: State) -> torch.Tensor:
        """Best fitness seen over the inner run (the wrapped workflow's
        objective value for these hyper-parameters)."""
        return state.best_fitness
