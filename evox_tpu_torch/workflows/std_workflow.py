"""Standard ask-eval-tell workflow (counterpart of
``evox_tpu/workflows/std_workflow.py``, the single-device subset).

``step(state) -> state`` runs one generation eagerly; :meth:`StdWorkflow.run`
is a Python loop over it.  The evaluation proxy is an explicit ``evaluate``
closure handed to ``Algorithm.step``; monitor and problem sub-states are
carried through it.

Not ported yet, and refused with :class:`NotImplementedError` rather than
ignored: distributed evaluation (``enable_distributed``, ``mesh``),
shard-granular quarantine, the precision plane (``precision``) and key
implementations (``key_impl``).  Also deferred: ``health_metrics``,
``run_segment`` and the fused segment program.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import Algorithm, Monitor, Problem, State, Workflow
from ..utils import rng

__all__ = ["StdWorkflow"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"StdWorkflow({what}) is not yet ported")


class StdWorkflow(Workflow):
    """Composes one Algorithm + one Problem + optional Monitor + optional
    solution/fitness transforms into a single steppable object.

    Usage::

        wf = StdWorkflow(PSO(100, lb, ub), Ackley(), monitor=EvalMonitor())
        state = wf.init(0)
        state = wf.init_step(state)
        for _ in range(100):
            state = wf.step(state)
    """

    def __init__(
        self,
        algorithm: Algorithm,
        problem: Problem,
        monitor: Monitor | None = None,
        opt_direction: str = "min",
        solution_transform: Callable | None = None,
        fitness_transform: Callable | None = None,
        enable_distributed: bool = False,
        mesh: Any | None = None,
        pop_axis: str = "pop",
        quarantine_nonfinite: bool = True,
        nonfinite_penalty: float = 1e30,
        quarantine_granularity: str = "individual",
        precision: Any | None = None,
        key_impl: str | None = None,
    ):
        """
        :param opt_direction: ``"min"`` or ``"max"``; for ``"max"`` fitness is
            negated before the fitness transform and the monitor's
            ``pre_tell``.
        :param quarantine_nonfinite: replace NaN/±Inf fitness values with a
            worst-case penalty, so ``argmin``/ranking and the monitor's
            top-k never propagate NaN; quarantined individuals are reported
            to ``Monitor.record_nonfinite``.
        :param nonfinite_penalty: magnitude of the penalty (sign follows
            ``opt_direction``; clamped to the fitness dtype's finite range).
        :param enable_distributed, mesh, precision, key_impl: not yet
            ported; any value but the default raises
            :class:`NotImplementedError`.  ``pop_axis`` only names the mesh
            axis and is ignored.
        :param quarantine_granularity: ``"individual"``; ``"shard"`` is not
            yet ported.
        """
        if opt_direction not in ("min", "max"):
            raise ValueError(
                f"Expect optimization direction to be `min` or `max`, got "
                f"{opt_direction!r}"
            )
        if quarantine_granularity not in ("individual", "shard"):
            raise ValueError(
                f"quarantine_granularity must be 'individual' or 'shard', "
                f"got {quarantine_granularity!r}"
            )
        if enable_distributed:
            raise _not_ported("enable_distributed=True")
        if mesh is not None:
            raise _not_ported("mesh=...")
        if quarantine_granularity == "shard":
            raise _not_ported("quarantine_granularity='shard'")
        if precision is not None:
            raise _not_ported("precision=...")
        if key_impl is not None:
            raise _not_ported("key_impl=...")
        del pop_axis
        self.opt_direction = 1 if opt_direction == "min" else -1
        self.algorithm = algorithm
        self.problem = problem
        self.monitor = monitor if monitor is not None else Monitor()
        if monitor is not None:
            monitor.set_config(
                opt_direction=self.opt_direction,
                device=getattr(algorithm, "device", None),
            )
        self.solution_transform = solution_transform
        self.fitness_transform = fitness_transform
        self.quarantine_nonfinite = quarantine_nonfinite
        self.nonfinite_penalty = float(nonfinite_penalty)

    # -- state -------------------------------------------------------------
    def setup(self, key: int | torch.Tensor) -> State:
        """Build the initial workflow state from an int seed or a key
        (:func:`evox_tpu_torch.utils.rng.key`)."""
        if not isinstance(key, torch.Tensor):
            key = rng.key(key)
        algo_key, prob_key, mon_key = rng.split_keys(key, 3)
        return State(
            algorithm=self.algorithm.setup(algo_key),
            problem=self.problem.setup(prob_key),
            monitor=self.monitor.setup(mon_key),
        )

    init = setup  # convenience alias

    # -- evaluation pipeline ----------------------------------------------
    def _make_evaluate(self, carrier: dict) -> Callable:
        def evaluate(pop):
            # The evaluation-count contract (``core/components.py``): an
            # unexpected extra call would corrupt the monitor/problem state
            # threading through the carrier, so fail loudly instead.
            carrier["n_evaluate_calls"] += 1
            limit = getattr(self.algorithm, "max_evaluations_per_step", 1)
            if carrier["n_evaluate_calls"] > limit:
                raise RuntimeError(
                    f"{type(self.algorithm).__name__} called the workflow's "
                    f"`evaluate` closure more than its declared limit of "
                    f"{limit} call(s) per step. Evaluate once, then select "
                    f"from the *fitness*. If the algorithm legitimately "
                    f"evaluates several populations per step, declare "
                    f"`max_evaluations_per_step` on the algorithm class."
                )
            mon = self.monitor.post_ask(carrier["monitor"], pop)
            if self.solution_transform is not None:
                pop = self.solution_transform(pop)
            mon = self.monitor.pre_eval(mon, pop)
            fit, carrier["problem"] = self.problem.evaluate(carrier["problem"], pop)
            fit, mon = self._quarantine(fit, mon)
            mon = self.monitor.post_eval(mon, fit)
            if self.opt_direction == -1:
                fit = -fit
            if self.fitness_transform is not None:
                fit = self.fitness_transform(fit)
            carrier["monitor"] = self.monitor.pre_tell(mon, fit)
            return fit

        return evaluate

    def _quarantine(
        self, fit: torch.Tensor, mon: State
    ) -> tuple[torch.Tensor, State]:
        """Replace non-finite fitness with a worst-case penalty (sign chosen
        so the quarantined individual loses under the configured direction)
        and report the per-individual mask to the monitor.  A no-op when
        disabled.  Integer/bool fitness cannot hold NaN/±Inf, but the
        monitor still receives its all-clear mask."""
        if not self.quarantine_nonfinite:
            return fit, mon
        if not fit.is_floating_point():
            mask = torch.zeros((fit.shape[0],), dtype=torch.bool, device=fit.device)
            return fit, self.monitor.record_nonfinite(mon, mask)
        # Clamp the penalty into the dtype's finite range: 1e30 would itself
        # round to inf in float16 fitness, defeating the quarantine.
        penalty = min(self.nonfinite_penalty, float(torch.finfo(fit.dtype).max))
        bad = ~torch.isfinite(fit)
        row_bad = bad if fit.ndim == 1 else bad.any(dim=-1)
        mon = self.monitor.record_nonfinite(mon, row_bad)
        # Demote the whole individual, not just its non-finite components.
        row_mask = row_bad if fit.ndim == 1 else row_bad[:, None]
        worst = torch.full((), self.opt_direction * penalty, dtype=fit.dtype, device=fit.device)
        return torch.where(row_mask, worst, fit), mon

    # -- stepping ----------------------------------------------------------
    def _step(self, state: State, which: str) -> State:
        carrier = {
            "problem": state.problem,
            "monitor": state.monitor,
            "n_evaluate_calls": 0,
        }
        evaluate = self._make_evaluate(carrier)
        algo_state = getattr(self.algorithm, which)(state.algorithm, evaluate)
        if carrier["n_evaluate_calls"] == 0:
            raise RuntimeError(
                f"{type(self.algorithm).__name__}.{which} never called the "
                "workflow's `evaluate` closure: every step must evaluate the "
                "population exactly once (the fitness drives the monitor and "
                "problem state threading)."
            )
        mon_state = carrier["monitor"]
        # Feed auxiliary algorithm records to the monitor only when the
        # monitor actually overrides the hook.
        if type(self.monitor).record_auxiliary is not Monitor.record_auxiliary:
            aux = self.algorithm.record_step(algo_state)
            if aux:
                mon_state = self.monitor.record_auxiliary(mon_state, aux)
        return state.replace(
            algorithm=algo_state, problem=carrier["problem"], monitor=mon_state
        )

    def init_step(self, state: State) -> State:
        """First optimization step (algorithm's ``init_step`` if overridden)."""
        return self._step(state, "init_step")

    def step(self, state: State) -> State:
        """One ask-eval-tell generation."""
        return self._step(state, "step")

    def final_step(self, state: State) -> State:
        """Last optimization step (algorithm's ``final_step`` if overridden)."""
        return self._step(state, "final_step")

    def run(self, state: State, n_steps: int, init: bool = True) -> State:
        """Run ``n_steps`` generations: ``init_step`` (when ``init``) and then
        ``step``, in a Python loop.  Nothing waits for the card between
        generations."""
        if init:
            state = self.init_step(state)
            n_steps -= 1
        for _ in range(n_steps):
            state = self.step(state)
        return state
