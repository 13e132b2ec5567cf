"""Automatic restart policies for unhealthy evolutionary runs (counterpart
of ``evox_tpu/resilience/restart.py``).

When a :class:`~evox_tpu_torch.resilience.HealthProbe` flags a degenerate
search (non-finite state, diversity collapse, step-size blow-up,
stagnation), the supervising
:class:`~evox_tpu_torch.resilience.ResilientRunner` applies one of these
policies instead of burning the remaining budget on a dead run:

* :class:`RollbackToCheckpoint` — reload an earlier checkpoint and
  **perturb every key** (fold the restart index into each key leaf) so
  the retry explores a different trajectory from a known-good state.
* :class:`ReinitLargerPopulation` — IPOP-style: build a fresh algorithm
  with the population grown by ``growth_factor``, set it up from a
  perturbed key, and keep the incumbent best (injected as an elite into
  the new population / distribution mean).  Monitor best-so-far metrics
  carry over; the problem sub-state is kept.
* :class:`PerturbAroundBest` — keep shapes, re-seed the population as a
  Gaussian cloud around the incumbent best (scaled to the search-space
  width) and reset stale fitness to worst.

**Determinism contract** (the JAX package's): a policy's output is a pure
function of ``(checkpointed state, restart index, lineage)`` — no wall
clock, no fresh entropy.  The runner records every fired restart as a
:class:`RestartEvent` in ``RunStats`` and in each checkpoint's manifest,
so a killed-and-resumed run replays the same decisions bit-identically.

Keys are the port's (:mod:`evox_tpu_torch.utils.rng`: int64 ``[seed,
counter]`` leaves named ``key``); folding keeps a key's stream family
(``precision.key_impl``).  The port's streams are not JAX's, so a
perturbed run draws other numbers than the JAX package's; the policies'
arithmetic on the state is the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Iterator, Mapping

import torch

from ..core import State
from ..utils import rng
from ..utils.checkpoint import load_state
from .health import _is_prng, _subtree

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (runner imports us)
    from .health import HealthReport
    from .runner import ResilientRunner

__all__ = [
    "RestartPolicy",
    "RestartEvent",
    "RestartContext",
    "RollbackToCheckpoint",
    "ReinitLargerPopulation",
    "PerturbAroundBest",
    "perturb_prng_keys",
    "incumbent_best",
]


# -- shared helpers ----------------------------------------------------------


def _map_with_path(tree: Any, fn: Callable[[str, Any], Any], prefix: tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``fn(path, leaf)`` (paths as
    :func:`~evox_tpu_torch.resilience.health.scan_state` names them)."""
    if isinstance(tree, State):
        return tree.replace(**{k: _map_with_path(v, fn, prefix + (str(k),)) for k, v in tree.items()})
    if isinstance(tree, Mapping):
        return {k: _map_with_path(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        items = [_map_with_path(v, fn, prefix + (str(i),)) for i, v in enumerate(tree)]
        return tuple(items) if isinstance(tree, tuple) else items
    if tree is None:
        return tree
    return fn("/".join(prefix), tree)


def _keys_with_path(tree: Any, prefix: tuple = ()) -> Iterator[torch.Tensor]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _keys_with_path(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _keys_with_path(v, prefix + (str(i),))
    elif _is_prng(tree, "/".join(prefix)):
        yield tree


def _fold(key: torch.Tensor, salt: int) -> torch.Tensor:
    """``rng.fold_in`` of ``salt`` into a key (2,) or each key of a stack
    (..., 2), made on the key's device."""
    data = torch.full(key.shape[:-1], int(salt), dtype=torch.int64, device=key.device)
    tag = key[..., 1] & rng._TAG_MASK
    return torch.stack((rng.child_seeds(key, data), tag), dim=-1)


def perturb_prng_keys(tree: Any, salt: int) -> Any:
    """Fold ``salt`` into every key leaf of ``tree``.

    Deterministic and collision-free per salt: two restarts with different
    indices produce disjoint downstream streams, and a replayed restart with
    the same index reproduces its stream exactly."""
    return _map_with_path(tree, lambda name, leaf: _fold(leaf, salt) if _is_prng(leaf, name) else leaf)


def _first_prng_key(tree: Any) -> torch.Tensor | None:
    """First key leaf in tree order."""
    return next(_keys_with_path(tree), None)


def incumbent_best(state: Any) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The best-so-far ``(solution, fitness)`` recoverable from a workflow
    state, in the minimizing fitness frame.

    Prefers the monitor's running top-k (monotone best-so-far, survives
    generations where the population regressed); falls back to the best
    **finite** entry of the algorithm's current ``fit``/``pop`` pair.
    Returns ``(None, None)`` when no finite incumbent exists (e.g.
    multi-objective states, or a fully-diverged population) — a policy
    must never re-seed around a NaN "best".  Reads a few values on the
    host (boundary code)."""
    mon = _subtree(state, "monitor")
    if mon is not None:
        sols = _subtree(mon, "topk_solutions")
        fits = _subtree(mon, "topk_fitness")
        if (
            isinstance(sols, torch.Tensor)
            and isinstance(fits, torch.Tensor)
            and sols.ndim == 2
            and fits.ndim == 1
            and fits.numel() > 0
            and bool(torch.isfinite(fits[0]) & torch.isfinite(sols[0]).all())
        ):
            return sols[0], fits[0]
    algo = _subtree(state, "algorithm")
    algo = algo if algo is not None else state
    pop = _subtree(algo, "pop")
    fit = _subtree(algo, "fit")
    if (
        isinstance(pop, torch.Tensor)
        and isinstance(fit, torch.Tensor)
        and pop.ndim == 2
        and fit.ndim == 1
        and fit.shape[0] == pop.shape[0]
        and fit.is_floating_point()
    ):
        # Rank non-finite fitness (and rows of non-finite solutions) last.
        usable = torch.isfinite(fit) & torch.isfinite(pop).all(dim=1)
        masked = torch.where(usable, fit, torch.full_like(fit, float("inf")))
        i = int(torch.argmin(masked))
        if bool(usable[i]):
            return pop[i], fit[i]
    return None, None


def _set_row0(x: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """``x`` with row 0 replaced by ``row`` (a new tensor)."""
    out = x.clone()
    out[0] = row.to(x.dtype)
    return out


# -- events ------------------------------------------------------------------


@dataclass
class RestartEvent:
    """One fired restart, as recorded in ``RunStats.restarts`` and in every
    subsequent checkpoint manifest (JSON round-trip via
    :meth:`to_manifest`/:meth:`from_manifest`)."""

    generation: int
    policy: str
    restart_index: int
    reasons: list[str] = field(default_factory=list)
    detail: dict[str, Any] = field(default_factory=dict)

    def to_manifest(self) -> dict[str, Any]:
        """JSON-serializable form for the checkpoint manifest."""
        return {
            "generation": self.generation,
            "policy": self.policy,
            "restart_index": self.restart_index,
            "reasons": list(self.reasons),
            "detail": dict(self.detail),
        }

    @classmethod
    def from_manifest(cls, data: Mapping[str, Any]) -> "RestartEvent":
        """Inverse of :meth:`to_manifest`."""
        return cls(
            generation=int(data["generation"]),
            policy=str(data["policy"]),
            restart_index=int(data["restart_index"]),
            reasons=list(data.get("reasons", [])),
            detail=dict(data.get("detail", {})),
        )


@dataclass
class RestartContext:
    """Everything a policy may consult when applying a restart."""

    runner: "ResilientRunner"
    workflow: Any
    state: State
    generation: int
    report: "HealthReport"
    restart_index: int
    lineage: tuple[RestartEvent, ...] = ()
    # The control-plane decision that fired this restart (a trend verdict,
    # an hpo-grow), ``None`` for a threshold-probe verdict.
    decision: Any | None = None


# -- the policy interface ----------------------------------------------------


class RestartPolicy:
    """A deterministic recovery action for an unhealthy run.

    ``apply`` returns ``(state, generation, needs_init, detail)``:

    * ``state`` — the restarted workflow state the run continues from;
    * ``generation`` — the generation count the run resumes at (equal to
      ``ctx.generation`` unless the policy rolled time back);
    * ``needs_init`` — True when ``state`` is a pre-``init_step`` state
      (fresh setup) the runner must drive through one init segment before
      chunking resumes;
    * ``detail`` — JSON-serializable facts for the :class:`RestartEvent`.

    ``rebuild_template`` lets resume reconstruct the checkpoint-validation
    template after restarts that changed state *shapes* (population
    regrows); shape-preserving policies inherit the identity."""

    name: str = "restart"

    def apply(self, ctx: RestartContext) -> tuple[State, int, bool, dict[str, Any]]:
        raise NotImplementedError

    def rebuild_template(
        self,
        workflow: Any,
        template: State,
        lineage: list[RestartEvent],
        runner: "ResilientRunner | None" = None,
    ) -> State:
        """Template a checkpoint written *after* ``lineage`` validates
        against.  Default: shapes unchanged, the caller's template."""
        del workflow, lineage, runner
        return template


class RollbackToCheckpoint(RestartPolicy):
    """Reload an earlier checkpoint and perturb every key.

    The retry re-runs the rolled-back generations with perturbed keys, so it
    explores a *different* trajectory from a known-good state.  When no
    earlier checkpoint survives (pruning, restart at the first boundary),
    the current state is perturbed in place (time does not roll back).

    :param back: how many checkpoint boundaries to roll back (1 = the
        boundary before the unhealthy one).  Clamped to the oldest
        retained checkpoint — size ``ResilientRunner(keep_checkpoints=...)``
        accordingly.
    :param salt: base value folded (offset by the restart index) into the
        keys; change it to decorrelate two otherwise identical retries.
    """

    name = "rollback"

    def __init__(self, back: int = 1, salt: int = 0x5EED):
        if back < 1:
            raise ValueError(f"back must be >= 1, got {back}")
        self.back = int(back)
        self.salt = int(salt)

    def apply(self, ctx: RestartContext):
        from ..utils.checkpoint import CheckpointError
        from .runner import _numbered_checkpoints

        candidates = [(gen, path) for gen, path in _numbered_checkpoints(ctx.runner.checkpoint_dir) if gen < ctx.generation]
        state, gen, detail = None, ctx.generation, {"rolled_back_to": None}
        # Walk from the back-th candidate toward older ones: one unusable
        # file (torn, or a pre-upgrade schema) must degrade the rollback,
        # not abort the run.
        start = max(len(candidates) - self.back, 0) if candidates else -1
        for i in range(start, -1, -1):
            cand_gen, path = candidates[i]
            try:
                # Digest-verify like the runner's own resume scan: a
                # bit-flipped rollback target must be skipped, not silently
                # restored into the "known-good" restart state.
                state = load_state(path, ctx.state, allow_missing=True, verify=bool(getattr(ctx.runner, "verify_resume", True)))
            except (CheckpointError, ValueError) as e:
                ctx.runner._event(f"rollback skipping unusable checkpoint {path.name}: {e}", warn=True)
                continue
            gen, detail = cand_gen, {"rolled_back_to": cand_gen}
            break
        if state is None:
            state = ctx.state
        state = perturb_prng_keys(state, self.salt + ctx.restart_index)
        return state, gen, False, detail


class ReinitLargerPopulation(RestartPolicy):
    """IPOP-style restart: fresh setup with a grown population, elite kept.

    Requires a workflow exposing a mutable ``.algorithm`` attribute and an
    ``init(key)`` state builder (``StdWorkflow`` does).  Across successive
    restarts the population compounds: ``pop * growth_factor ** k``, capped
    at ``max_pop_size``.

    What carries over from the unhealthy state: the **incumbent best**
    (written into row 0 of the new population, or the new distribution
    ``mean``), the monitor's best-so-far metrics (top-k, ``generation``,
    the quarantine, restart and preemption counters, ``instance_id``) and
    the **problem sub-state**.  Everything else is rebuilt by
    ``algorithm.setup`` from a restart-index-perturbed key.  The regrown
    state has new shapes: the runner's next segment captures a new graph,
    and the workflow's earlier captures are dropped with their memory.

    :param algorithm_factory: ``pop_size -> Algorithm`` builder for the
        regrown algorithm (same hyperparameters, new population size).
    :param growth_factor: multiplicative population growth per restart.
    :param max_pop_size: hard cap on the regrown population.
    :param preserve_elite: inject the incumbent best (on by default).
    :param salt: base key fold value, offset by the restart index.
    """

    name = "reinit_larger_population"

    def __init__(
        self,
        algorithm_factory: Callable[[int], Any],
        growth_factor: float = 2.0,
        max_pop_size: int | None = None,
        preserve_elite: bool = True,
        salt: int = 0x1B0B,
    ):
        if growth_factor <= 1.0:
            raise ValueError(f"growth_factor must be > 1.0 (the population must grow), got {growth_factor}")
        if max_pop_size is not None and max_pop_size < 1:
            raise ValueError(f"max_pop_size must be >= 1, got {max_pop_size}")
        self.algorithm_factory = algorithm_factory
        self.growth_factor = float(growth_factor)
        self.max_pop_size = max_pop_size
        self.preserve_elite = preserve_elite
        self.salt = int(salt)

    # carried monitor keys: scalar/metric state that must survive a regrow.
    _CARRY_MONITOR = (
        "topk_solutions",
        "topk_fitness",
        "generation",
        "instance_id",
        "num_nonfinite",
        "num_shard_quarantines",
        "num_restarts",
        "num_preemptions",
    )

    def _new_pop_size(self, current: int) -> int:
        new_pop = max(int(round(current * self.growth_factor)), current + 1)
        if self.max_pop_size is not None:
            new_pop = min(new_pop, self.max_pop_size)
        return new_pop

    def _rebuild(self, workflow: Any, runner: "ResilientRunner", pop_size: int):
        if not hasattr(workflow, "algorithm"):
            raise ValueError(
                f"{self.name} needs a workflow with a mutable `.algorithm` "
                f"attribute (e.g. StdWorkflow); got {type(workflow).__name__}"
            )
        workflow.algorithm = self.algorithm_factory(pop_size)
        runner._rebind_workflow()

    def apply(self, ctx: RestartContext):
        algo = getattr(ctx.workflow, "algorithm", None)
        current = getattr(algo, "pop_size", None)
        if current is None:
            raise ValueError(
                f"{self.name} needs a workflow whose `.algorithm` exposes "
                f"`pop_size`; got {type(algo).__name__}"
            )
        new_pop = self._new_pop_size(int(current))
        best, _ = incumbent_best(ctx.state)

        key = _first_prng_key(ctx.state)
        if key is None:
            key = rng.key(self.salt, getattr(algo, "device", None))
        key = _fold(key, self.salt + ctx.restart_index)

        self._rebuild(ctx.workflow, ctx.runner, new_pop)
        fresh = getattr(ctx.workflow, "init", ctx.workflow.setup)(key)

        algo_state = _subtree(fresh, "algorithm")
        if algo_state is None:
            raise ValueError(
                f"{self.name} expects workflow.init() to return a state with "
                f"an 'algorithm' sub-state; got keys {list(fresh)}"
            )
        if self.preserve_elite and best is not None:
            pop = _subtree(algo_state, "pop")
            mean = _subtree(algo_state, "mean")
            if isinstance(pop, torch.Tensor) and pop.ndim == 2 and pop.shape[1] == best.shape[0]:
                updates = {"pop": _set_row0(pop, best)}
                # Personal-best buffers sampled in setup() still point at
                # the pre-injection random row 0; keep them coherent.
                lbl = _subtree(algo_state, "local_best_location")
                if isinstance(lbl, torch.Tensor) and lbl.shape == pop.shape:
                    updates["local_best_location"] = _set_row0(lbl, best)
                algo_state = algo_state.replace(**updates)
            elif isinstance(mean, torch.Tensor) and mean.shape == best.shape:
                algo_state = algo_state.replace(mean=best.to(mean.dtype))

        state = fresh.replace(algorithm=algo_state)
        mon_state = _subtree(fresh, "monitor")
        old_mon = _subtree(ctx.state, "monitor")
        if old_mon is not None and isinstance(mon_state, State):
            carried = {k: old_mon[k] for k in self._CARRY_MONITOR if k in old_mon and k in mon_state}
            if carried:
                state = state.replace(monitor=mon_state.replace(**carried))
        old_problem = _subtree(ctx.state, "problem")
        if old_problem is not None and "problem" in fresh:
            state = state.replace(problem=old_problem)
        return state, ctx.generation, True, {"pop_size": new_pop}

    def rebuild_template(self, workflow, template, lineage, runner=None):
        events = [e for e in lineage if e.policy == self.name]
        if not events or runner is None:
            return template
        self._rebuild(workflow, runner, int(events[-1].detail["pop_size"]))
        # Only structure (shapes/dtypes) matters for a template; the key
        # value is irrelevant.
        return getattr(workflow, "init", workflow.setup)(0)


class PerturbAroundBest(RestartPolicy):
    """Re-seed the population as a Gaussian cloud around the incumbent best.

    Shapes are preserved: the new population is ``best + scale * width *
    N(0, 1)`` — ``width`` being the per-dimension search-space width when
    the algorithm exposes ``lb``/``ub`` bounds (samples are clipped back
    into them), else 1.0 — with the incumbent itself kept unperturbed in
    row 0 and stale fitness reset to worst so the next generation re-ranks
    from scratch.  Mean-based ES states (no ``pop``) get ``mean := best``
    and, when the algorithm exposes a ``sigma_init``, a step-size reset.

    The normal draws come from :meth:`_normal` (the port's Philox stream;
    a test can hand it another package's draws).

    :param scale: cloud radius as a fraction of the search-space width.
    :param salt: base key fold value, offset by the restart index.
    """

    name = "perturb_around_best"

    def __init__(self, scale: float = 0.1, salt: int = 0xBE57):
        if scale <= 0:
            raise ValueError(f"scale must be > 0, got {scale}")
        self.scale = float(scale)
        self.salt = int(salt)

    def _normal(self, key: torch.Tensor, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        """``N(0, 1)`` draws of ``shape`` from the key (on its device)."""
        return rng.normal(rng.child(key), shape, dtype, key.device)

    def apply(self, ctx: RestartContext):
        best, _ = incumbent_best(ctx.state)
        state = perturb_prng_keys(ctx.state, self.salt + ctx.restart_index)
        if best is None:
            return state, ctx.generation, False, {"note": "no incumbent; PRNG perturbation only"}

        algo_state = state["algorithm"] if "algorithm" in state else state
        algo = getattr(ctx.workflow, "algorithm", None)
        lb = getattr(algo, "lb", None)
        ub = getattr(algo, "ub", None)

        pop = _subtree(algo_state, "pop")
        detail: dict[str, Any] = {"scale": self.scale}
        if isinstance(pop, torch.Tensor) and pop.ndim == 2 and pop.shape[1] == best.shape[0]:
            if lb is not None and ub is not None:
                width = (ub - lb).to(pop.dtype)
            else:
                width = torch.ones((), dtype=pop.dtype, device=pop.device)
            noise_key = _first_prng_key(algo_state)
            if noise_key is None:
                noise_key = rng.key(self.salt, pop.device)
            noise_key = _fold(noise_key, ctx.restart_index + 1)
            cloud = best.to(pop.dtype) + self.scale * width * self._normal(noise_key, tuple(pop.shape), pop.dtype)
            cloud = _set_row0(cloud, best)
            if lb is not None and ub is not None:
                cloud = torch.clamp(cloud, lb.to(pop.dtype), ub.to(pop.dtype))
            updates: dict[str, Any] = {"pop": cloud}
            # Stale per-position records belong to the COLLAPSED positions:
            # re-anchor personal-best locations on the cloud and worst-out
            # the stale scores so the next evaluation re-establishes them.
            fit = _subtree(algo_state, "fit")
            if isinstance(fit, torch.Tensor) and fit.ndim == 1 and fit.is_floating_point():
                updates["fit"] = torch.full_like(fit, float("inf"))
            lbl = _subtree(algo_state, "local_best_location")
            lbf = _subtree(algo_state, "local_best_fit")
            if isinstance(lbl, torch.Tensor) and lbl.shape == cloud.shape:
                updates["local_best_location"] = cloud.to(lbl.dtype)
            if isinstance(lbf, torch.Tensor) and lbf.ndim == 1 and lbf.is_floating_point():
                updates["local_best_fit"] = torch.full_like(lbf, float("inf"))
            algo_state = algo_state.replace(**updates)
            detail["reseeded"] = "pop"
        else:
            mean = _subtree(algo_state, "mean")
            if isinstance(mean, torch.Tensor) and mean.shape == best.shape:
                algo_state = algo_state.replace(mean=best.to(mean.dtype))
                sigma = _subtree(algo_state, "sigma")
                sigma_init = getattr(algo, "sigma_init", None)
                if sigma is not None and sigma_init is not None:
                    algo_state = algo_state.replace(
                        sigma=torch.as_tensor(sigma_init, dtype=sigma.dtype, device=sigma.device) * torch.ones_like(sigma)
                    )
                detail["reseeded"] = "mean"
            else:
                detail["reseeded"] = None

        if "algorithm" in state:
            state = state.replace(algorithm=algo_state)
        else:
            state = algo_state
        return state, ctx.generation, False, detail
