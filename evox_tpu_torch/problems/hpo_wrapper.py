"""Hyper-parameter optimization wrapper (counterpart of
``evox_tpu/problems/hpo_wrapper.py``): the back-compat shim over
:mod:`evox_tpu_torch.hpo`.

* :class:`HPOMonitor` / :class:`HPOFitnessMonitor` /
  :data:`HPO_REPEAT_AXIS` are re-exported from :mod:`evox_tpu_torch.hpo`;
* :class:`HPOProblemWrapper` subclasses
  :class:`~evox_tpu_torch.hpo.NestedProblem` with the wrapper's defaults:
  ``prng="split"`` (one ``split_keys`` schedule over every instance) and
  ``telemetry=False`` (the lean problem state).  ``num_instances`` is the
  original name of ``num_candidates``.
"""

from __future__ import annotations

from typing import Callable, Literal

import torch

from ..core import Workflow
from ..hpo.monitor import HPO_REPEAT_AXIS, HPOFitnessMonitor, HPOMonitor  # noqa: F401 - re-exported
from ..hpo.nested import NestedProblem

__all__ = ["HPOMonitor", "HPOFitnessMonitor", "HPOProblemWrapper", "HPO_REPEAT_AXIS"]


class HPOProblemWrapper(NestedProblem):
    """Turns an entire workflow into a Problem: the outer population is a
    batch of hyper-parameter sets; fitness is each instance's inner-run
    score.

    Usage::

        monitor = HPOFitnessMonitor()
        inner = StdWorkflow(algo, prob, monitor=monitor)
        hpo_prob = HPOProblemWrapper(iterations=30, num_instances=7, workflow=inner)
        state = hpo_prob.setup(key)
        params = hpo_prob.get_init_params(state)
        # e.g. params == {"algorithm.hp": (7, 2) tensor}; alter and evaluate:
        fit, state = hpo_prob.evaluate(state, params)

    Works as the problem of an outer ``StdWorkflow`` with a
    ``solution_transform`` mapping solution vectors to the params dict.
    """

    def __init__(
        self,
        iterations: int,
        num_instances: int,
        workflow: Workflow,
        num_repeats: int = 1,
        fit_aggregation: Callable = torch.mean,
        aggregation: Literal["per_generation", "final"] = "per_generation",
    ):
        """
        :param iterations: total inner generations per evaluation (including
            the init and final steps).
        :param num_instances: parallel inner-workflow instances = outer
            population size.
        :param workflow: the inner workflow; its monitor must be an
            :class:`HPOMonitor`.
        :param num_repeats: independent repeats per instance (distinct key
            streams); hyper-parameters are shared across repeats.
        :param fit_aggregation: reduction over the repeats axis, called as
            ``fit_aggregation(stacked, axis=0)``; default ``torch.mean``.
        :param aggregation: ``"per_generation"`` or ``"final"`` (see
            :class:`~evox_tpu_torch.hpo.NestedProblem`).
        """
        super().__init__(
            workflow,
            iterations,
            num_instances,
            num_repeats=num_repeats,
            fit_aggregation=fit_aggregation,
            aggregation=aggregation,
            prng="split",
            telemetry=False,
        )

    @property
    def num_instances(self) -> int:
        """The original name of ``num_candidates``."""
        return self.num_candidates

    def with_inner_workflow(self, workflow: Workflow) -> "HPOProblemWrapper":
        # The shim's constructor signature differs from NestedProblem's;
        # regrowing through the shim keeps the shim type.
        return type(self)(
            self.iterations,
            self.num_candidates,
            workflow,
            num_repeats=self.num_repeats,
            fit_aggregation=self.fit_aggregation,
            aggregation=self.aggregation,
        )
