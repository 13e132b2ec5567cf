"""Abstract component interfaces (counterpart of
``evox_tpu/core/components.py``): Algorithm / Problem / Workflow / Monitor.

Every method threads an immutable :class:`~evox_tpu_torch.core.state.State`.
The random stream lives inside the state (``state.key``, see
:mod:`evox_tpu_torch.utils.rng`), so ``step(state) -> state`` is
self-contained.

``Algorithm.step(state, evaluate) -> state`` receives the evaluation
callback explicitly.  It must call it **once per step** unless the
algorithm declares more through a ``max_evaluations_per_step`` class
attribute; ``StdWorkflow`` raises on zero calls or calls beyond the limit.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .state import State

__all__ = ["Algorithm", "Problem", "Workflow", "Monitor", "EvalFn"]

# evaluate(population) -> fitness; provided to Algorithm.step by the workflow.
EvalFn = Callable[[torch.Tensor], torch.Tensor]


class _Component:
    """Shared base: components are plain Python objects holding static
    configuration only; all evolving values live in the State returned by
    ``setup``."""

    def setup(self, key: torch.Tensor) -> State:
        """Build this component's initial state. Default: stateless."""
        del key
        return State()

    # Components are hashable by identity.
    def __hash__(self) -> int:
        return id(self)

    def __eq__(self, other: Any) -> bool:
        return self is other


class Algorithm(_Component):
    """An optimization algorithm.

    Subclasses implement ``setup(key) -> State`` and ``step(state,
    evaluate) -> State``; ``init_step`` and ``final_step`` default to
    ``step``, and ``record_step`` returns auxiliary values for the monitor.
    """

    def step(self, state: State, evaluate: EvalFn) -> State:
        """One ask-eval-tell generation: propose a population, call
        ``evaluate`` on it once, and fold the fitness back into the state."""
        raise NotImplementedError

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        """First-generation variant (e.g. evaluate-only); defaults to
        ``step``."""
        return self.step(state, evaluate)

    def final_step(self, state: State, evaluate: EvalFn) -> State:
        """Last-generation variant; defaults to ``step``."""
        return self.step(state, evaluate)

    def record_step(self, state: State) -> dict[str, Any]:
        """Auxiliary values handed to ``Monitor.record_auxiliary`` each step:
        the current population and fitness, when the state carries them
        under the conventional names."""
        return {k: state[k] for k in ("pop", "fit") if k in state}


class Problem(_Component):
    """An optimization problem.

    ``evaluate(state, pop) -> (fitness, state)``: fitness is ``(pop_size,)``
    for single-objective or ``(pop_size, n_obj)`` for multi-objective
    problems.  Stateless problems return ``state`` unchanged.
    """

    #: Whether ``evaluate`` can run inside a captured CUDA graph (a fused
    #: segment on the card).  A problem that must call the host on every
    #: evaluation says False, and ``StdWorkflow.run``/``run_segment`` on
    #: the card refuse it before running anything.
    capturable: bool = True

    def evaluate(
        self, state: State, pop: torch.Tensor
    ) -> tuple[torch.Tensor, State]:
        """Fitness of every candidate in ``pop`` plus the updated problem
        state."""
        raise NotImplementedError


class Workflow(_Component):
    """A steppable composition of components."""

    def init_step(self, state: State) -> State:
        """First optimization step; defaults to ``step``."""
        return self.step(state)

    def step(self, state: State) -> State:
        """Advance the whole composition by one generation."""
        raise NotImplementedError

    def final_step(self, state: State) -> State:
        """Last optimization step; defaults to ``step``."""
        return self.step(state)


class Monitor(_Component):
    """Hook pipeline around evaluation.  All hooks are ``(state, value) ->
    state``; the no-op base makes a bare ``Monitor()`` a zero-cost default.

    **Fused-segment capture contract.**  A monitor that keeps history on the
    host side of the state (``EvalMonitor``'s lists) would, inside a fused
    multi-generation segment (``StdWorkflow.run_segment`` / ``run``, a
    captured CUDA graph on the card), record tensors that the next replay
    overwrites.  While a segment runs, the workflow therefore sets
    ``_capture`` to a list; such a monitor appends ``(history_type, slot,
    data, generation, instance_id)`` tuples to it instead of recording, and
    receives the batched payloads back at the segment boundary through its
    ``ingest_sinks`` hook.  Monitors that keep everything in state (this
    base, counters-only monitors) need no change: the list stays empty.
    """

    # None outside a fused segment; a list while one runs (see above).
    _capture: list | None = None

    def set_config(self, **config: Any) -> "Monitor":
        """Out-of-band configuration from the workflow (the optimization
        direction, the device); returns self."""
        return self

    def post_ask(self, state: State, population: torch.Tensor) -> State:
        """Hook: after the algorithm proposes a population."""
        del population
        return state

    def pre_eval(self, state: State, population: torch.Tensor) -> State:
        """Hook: after the solution transform, before evaluation."""
        del population
        return state

    def post_eval(self, state: State, fitness: torch.Tensor) -> State:
        """Hook: on the raw fitness, before direction/fitness transforms."""
        del fitness
        return state

    def pre_tell(self, state: State, fitness: torch.Tensor) -> State:
        """Hook: on the transformed fitness the algorithm will be told."""
        del fitness
        return state

    def record_auxiliary(self, state: State, aux: dict[str, Any]) -> State:
        """Hook: per-step auxiliary values from ``Algorithm.record_step``
        (only called when a subclass overrides this method)."""
        del aux
        return state

    def record_nonfinite(self, state: State, mask: torch.Tensor) -> State:
        """Hook: per-individual boolean mask of quarantined non-finite
        fitness rows, fired by ``StdWorkflow`` before the penalty
        substitution."""
        del mask
        return state

    def record_shard_quarantine(
        self, state: State, shard_mask: torch.Tensor
    ) -> State:
        """Hook: per-shard boolean mask of shards whose entire row block was
        quarantined (``StdWorkflow(quarantine_granularity="shard")``)."""
        del shard_mask
        return state

    def record_restart(self, state: State) -> State:
        """Hook: an automatic restart fired on the run this state belongs
        to."""
        return state

    def record_preemption(self, state: State) -> State:
        """Hook: the run this state belongs to is being preempted."""
        return state
