"""Elastic inner populations: the controller-driven IPOP growth ladder
(counterpart of ``evox_tpu/hpo/elastic.py``).

"Massively parallel CMA-ES with increasing population" as a *meta*-behavior:
when a candidate's **inner** run stagnates — detected from the
per-candidate best-fitness series the nested evaluation batches out as
telemetry — the control plane fires a journaled
``Decision(kind="hpo-grow")`` and the next segment boundary regrows the
nested problem's inner population (``pop * growth_factor``, capped),
rebuilding every candidate's instances at the larger size from the
identity-keyed streams.  Growth is **whole-ladder**: all candidates share
one vmapped batch (one captured evaluation on the card), so the regrow
axis is the nested problem's inner population; the stagnating candidate
that *triggered* it is recorded in the decision's evidence
(``candidate_uid``), and every candidate keeps its uid-keyed stream
through the regrow.  The hyper-parameters under optimization live in the
OUTER state, which a growth never touches.

:class:`HPOGrowPolicy` rides the :class:`~evox_tpu_torch.hpo.HPORunner`'s
restart machinery: fired growths are
:class:`~evox_tpu_torch.resilience.RestartEvent` lineage (policy
``"hpo-grow"``), persisted in every checkpoint manifest, and replayed by
resume via :meth:`HPOGrowPolicy.rebuild_template` — a run killed after a
growth resumes bit-identically at the grown shape.  (The JAX package's
second consumer, the packed service, is not ported yet.)

Decisions are replayable bit-for-bit: the action is the pure
:func:`~evox_tpu_torch.control.controller.decide_hpo_grow` over the
journaled evidence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from ..resilience.restart import RestartContext, RestartPolicy, perturb_prng_keys
from .nested import NestedProblem, find_nested

__all__ = [
    "GrowthLadder",
    "HPOGrowPolicy",
    "grow_evidence",
    "validate_ladder_window",
]


def validate_ladder_window(ladder: "GrowthLadder", nested: Any) -> None:
    """A ladder whose stagnation window exceeds what one evaluation's
    telemetry can ever span would silently never fire — fail loudly at
    construction instead.  The series holds ``iterations - 2`` points and
    the windowed slope needs ``span >= window``, so firing requires
    ``iterations >= stagnation_window + 3``."""
    window = int(getattr(ladder, "stagnation_window", 0))
    iterations = int(getattr(nested, "iterations", 0))
    if iterations < window + 3:
        raise ValueError(
            f"GrowthLadder(stagnation_window={window}) can never fire "
            f"against NestedProblem(iterations={iterations}): one "
            f"evaluation's telemetry series holds iterations-2 = "
            f"{iterations - 2} points and the windowed slope needs "
            f"span >= window (iterations >= stagnation_window + 3); "
            f"shrink the window or raise iterations"
        )


@dataclass
class GrowthLadder:
    """Configuration of the elastic inner-population ladder.

    :param inner_factory: ``pop_size -> Algorithm`` constructor of the
        regrown inner algorithm (same hyperparameters, new population
        size).  Resume and journal replay need the same factory configured.
    :param growth_factor: multiplicative population growth per firing
        (IPOP default 2.0; must be > 1).
    :param max_inner_pop: hard cap on the regrown inner population
        (``None`` = uncapped).
    :param stagnation_window: inner generations of best-fitness span a
        candidate's series must cover before the stagnation detector may
        fire (must be >= 1).
    :param stagnation_tol: minimum projected best-fitness improvement
        (minimizing frame) across the window that counts as progress.
    :param salt: fold salt for the deterministic instance rebuild (offset
        by the growth index).
    """

    inner_factory: Callable[[int], Any]
    growth_factor: float = 2.0
    max_inner_pop: int | None = None
    stagnation_window: int = 8
    stagnation_tol: float = 0.0
    salt: int = 0x6B0B

    def __post_init__(self) -> None:
        if self.growth_factor <= 1.0:
            raise ValueError(
                f"growth_factor must be > 1.0 (the population must grow), "
                f"got {self.growth_factor}"
            )
        if self.max_inner_pop is not None and self.max_inner_pop < 1:
            raise ValueError(
                f"max_inner_pop must be >= 1, got {self.max_inner_pop}"
            )
        if self.stagnation_window < 1:
            raise ValueError(
                f"stagnation_window must be >= 1, got "
                f"{self.stagnation_window}"
            )

    def next_pop(self, current: int) -> int:
        """The pop a firing grows ``current`` to (>= current + 1 unless
        capped; a capped ladder returns ``current`` — nothing to grow)."""
        new_pop = max(int(round(current * self.growth_factor)), current + 1)
        if self.max_inner_pop is not None:
            new_pop = min(new_pop, self.max_inner_pop)
        return max(new_pop, current)

    def evidence(
        self,
        *,
        candidate_uid: int,
        best_slope: float | None,
        span: float,
        inner_pop: int,
    ) -> dict[str, Any]:
        """The journaled evidence dict behind one grow consult — measured
        signals plus the thresholds in force, so
        :func:`~evox_tpu_torch.control.controller.decide_hpo_grow` replays
        the action from the record alone."""
        return {
            "candidate_uid": int(candidate_uid),
            "best_slope": None if best_slope is None else float(best_slope),
            "span": float(span),
            "stagnation_window": float(self.stagnation_window),
            "stagnation_tol": float(self.stagnation_tol),
            "inner_pop": int(inner_pop),
            "growth_factor": float(self.growth_factor),
            "max_inner_pop": (
                None if self.max_inner_pop is None else int(self.max_inner_pop)
            ),
        }


def grow_evidence(
    ladder: GrowthLadder,
    series_by_uid: dict[int, Any],
    inner_pop: int,
) -> dict[str, Any] | None:
    """Build the grow-consult evidence from per-candidate inner
    best-fitness series (host values: the nested telemetry,
    repeat-averaged): the *most stagnant* candidate — the one whose
    windowed slope projects the least improvement — is the trigger
    candidate.  Returns ``None`` when no candidate has a usable (>= 2
    finite points) windowed series."""
    from ..obs.flight import window_slope

    worst_uid: int | None = None
    worst_slope: float | None = None
    span = 0.0
    window = int(ladder.stagnation_window)
    for uid, series in series_by_uid.items():
        values = [float(v) for v in series]
        tail = values[-(window + 1):]
        rows = [
            {"generation": float(g), "best_fitness": v}
            for g, v in enumerate(tail)
        ]
        slope = window_slope(rows, "best_fitness")
        if slope is None:
            continue
        # Minimizing frame: the largest slope is the least improvement —
        # the most stagnant candidate triggers.
        if worst_slope is None or slope > worst_slope:
            worst_uid, worst_slope = int(uid), float(slope)
            span = float(len(tail) - 1)
    if worst_uid is None:
        return None
    return ladder.evidence(
        candidate_uid=worst_uid,
        best_slope=worst_slope,
        span=span,
        inner_pop=inner_pop,
    )


class HPOGrowPolicy(RestartPolicy):
    """The growth ladder as a
    :class:`~evox_tpu_torch.resilience.RestartPolicy`: fired growths are
    manifest lineage, resume replays them via :meth:`rebuild_template`, and
    the ``max_restarts`` budget bounds the ladder.

    The outer search state (algorithm + monitor) is preserved untouched;
    only the nested problem sub-state is rebuilt at the grown shape
    (``needs_init=False`` — the next segment simply evaluates the grown
    ladder).  When the triggering
    :class:`~evox_tpu_torch.control.Decision` rode in (``ctx.decision``),
    its action IS the target population (the journaled, replayable value);
    threshold-probe firings (an unhealthy inner state, IPOP's original
    trigger) compute it from the ladder.

    On the card the replaced nest's captured evaluation is dropped with the
    outer workflow's captured segments (``_rebind_workflow``), so neither
    outlives the growth: the grown ladder is captured anew on its first
    evaluation."""

    name = "hpo-grow"

    def __init__(self, ladder: GrowthLadder):
        self.ladder = ladder

    def _graft(self, workflow: Any, grown: NestedProblem) -> None:
        from ..parallel import iter_problem_chain

        nested = find_nested(getattr(workflow, "problem", None))
        if nested is not None:
            nested.reset_graphs()
        if workflow.problem is nested:
            workflow.problem = grown
            return
        for p in iter_problem_chain(workflow.problem):
            if getattr(p, "problem", None) is nested:
                p.problem = grown
                return
        raise ValueError(
            "could not graft the regrown NestedProblem into the workflow's "
            "problem chain"
        )

    def apply(self, ctx: RestartContext):
        nested = find_nested(getattr(ctx.workflow, "problem", None))
        if nested is None:
            raise ValueError(
                f"{self.name} needs a workflow whose problem chain contains "
                f"a NestedProblem"
            )
        current = nested.inner_pop
        if ctx.decision is not None and str(ctx.decision.action).isdigit():
            new_pop = int(ctx.decision.action)
        else:
            new_pop = self.ladder.next_pop(current)
        if new_pop <= current:
            # Cap reached: nothing to grow — perturb the inner streams in
            # place so the retry at least explores fresh trajectories.
            state = perturb_prng_keys(
                ctx.state, self.ladder.salt + ctx.restart_index
            )
            return state, ctx.generation, False, {
                "inner_pop": current,
                "grown": False,
            }
        grown = nested.with_inner_pop(new_pop, self.ladder.inner_factory)
        self._graft(ctx.workflow, grown)
        ctx.runner._rebind_workflow()
        prob = grown.regrow_state(
            ctx.state["problem"], self.ladder.salt + ctx.restart_index
        )
        state = ctx.state.replace(problem=prob)
        return state, ctx.generation, False, {
            "inner_pop": new_pop,
            "grown": True,
        }

    def rebuild_template(self, workflow, template, lineage, runner=None):
        events = [
            e
            for e in lineage
            if e.policy == self.name and e.detail.get("grown")
        ]
        if not events or runner is None:
            return template
        nested = find_nested(getattr(workflow, "problem", None))
        if nested is None:
            return template
        from ..precision import make_key
        from ..utils import graph

        grown = nested.with_inner_pop(
            int(events[-1].detail["inner_pop"]), self.ladder.inner_factory
        )
        self._graft(workflow, grown)
        runner._rebind_workflow()
        # Only structure (shapes, dtypes, the keys' stream family) matters
        # for a template; the key's value is irrelevant.
        leaves, _ = graph.flatten(template)
        device = leaves[0].device if leaves else None
        key = make_key(0, runner._observed_key_impl(template), device)
        return template.replace(problem=grown.setup(key))
