"""Opposition-based Differential Evolution (counterpart of
``evox_tpu/algorithms/so/de_variants/ode.py``): a DE generation, then the
mirrored population ``lb + ub - pop`` is evaluated and each individual
keeps the better of itself and its opposite.  Two evaluations a
generation."""

from __future__ import annotations

from ....core import EvalFn, State
from .de import DE, improve

__all__ = ["ODE"]


class ODE(DE):
    """Opposition-based DE (Rahnamayan et al., 2008)."""

    # Two evaluations a generation (the DE trials and the opposites), for
    # the workflow's evaluation-count guard.
    max_evaluations_per_step = 2

    def step(self, state: State, evaluate: EvalFn) -> State:
        state = super().step(state, evaluate)
        opposition = self.lb + self.ub - state.pop
        return improve(state, opposition, evaluate(opposition))
