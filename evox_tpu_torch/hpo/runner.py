"""Resumable nested state: the meta-run supervisor (counterpart of
``evox_tpu/hpo/runner.py``).

:class:`HPORunner` is a :class:`~evox_tpu_torch.resilience.ResilientRunner`
specialized for meta-optimization workflows (an outer
:class:`~evox_tpu_torch.workflows.StdWorkflow` whose problem chain contains
a :class:`~evox_tpu_torch.hpo.NestedProblem`):

* **checkpointing is whole-nest** — the outer state already carries the
  full batch of inner instances plus the latest evaluation's telemetry, so
  the checkpoint store covers outer + inner state with no new format;
  every manifest additionally records the inner algorithm/bucket metadata
  (``manifest["hpo"]``) and the per-candidate inner-history ring, so a
  SIGTERM/SIGKILL mid-meta-run resumes bit-identically — outer state,
  inner instances, and the re-ingested per-candidate histories included;
* **per-candidate inner telemetry** — at every segment boundary the nested
  telemetry (each candidate's per-generation inner best-fitness series)
  is ingested into host-side ``candidate_history`` (keyed by the stable
  candidate uid, deduplicated by outer generation so a resumed run's
  re-ingest never duplicates) and published as ``evox_hpo_*`` metrics.  On
  the card the series and the uids ride in the runner's one read of a
  segment's scalars (:meth:`_boundary_reads`): the ingest makes no host
  sync of its own;
* **elastic growth** — with ``grow=GrowthLadder(...)`` and a
  :class:`~evox_tpu_torch.control.Controller`, stagnation trends on the
  inner series fire journaled ``Decision(kind="hpo-grow")`` records
  through the runner's restart machinery
  (:class:`~evox_tpu_torch.hpo.HPOGrowPolicy`): the inner population
  regrows at the boundary, the growth is restart lineage in every later
  manifest, and resume replays it bit-for-bit.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Union

import numpy as np
import torch

from ..core import State
from ..resilience.health import HealthProbe, HealthReport
from ..resilience.runner import ResilientRunner
from ..utils.checkpoint import read_manifest
from .elastic import (
    GrowthLadder,
    HPOGrowPolicy,
    grow_evidence,
    validate_ladder_window,
)
from .nested import NestedProblem, candidate_series, find_nested, series_by_uid

__all__ = ["HPORunner"]

# The host dtype a telemetry series is read back into (float32 for the
# types numpy lacks).
_NUMPY_DTYPES = {torch.float16: np.float16, torch.float32: np.float32, torch.float64: np.float64}


def _bucket(config: dict) -> str:
    """The manifest's ``hpo.bucket``: a digest of the nest's configuration
    as the ``hpo`` block records it (the inner algorithm, its population
    and dimension, the iterations, candidates and repeats)."""
    return hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:16]


class HPORunner(ResilientRunner):
    """Checkpointed, trend-growing supervisor for one meta-optimization run.

    Usage::

        inner = StdWorkflow(OpenES(...), Sphere(), monitor=HPOFitnessMonitor())
        nested = NestedProblem(inner, iterations=32, num_candidates=64)
        outer = StdWorkflow(PSO(64, lb, ub), nested,
                            solution_transform=...)
        runner = HPORunner(outer, "ckpts/meta", checkpoint_every=4,
                           grow=GrowthLadder(inner_factory=make_inner,
                                             stagnation_window=8),
                           controller=Controller(journal=journal))
        runner.run(outer.init(0), n_steps=200)
        runner.candidate_history[uid]   # [(outer_gen, [inner best...]), ...]

    :param grow: optional :class:`~evox_tpu_torch.hpo.GrowthLadder` —
        supplies the runner's restart policy
        (:class:`~evox_tpu_torch.hpo.HPOGrowPolicy`), so ``restart=`` must
        not also be passed; growths share the ``max_restarts`` budget.
        Trend-driven firing additionally needs ``controller=`` (decisions
        journal through it); without a controller the ladder only fires on
        threshold-probe unhealthy verdicts (IPOP's original trigger).
    :param history_limit: per-candidate inner-history entries persisted in
        each checkpoint manifest (the resume re-ingest ring; the in-memory
        history is unbounded).

    Every other parameter is
    :class:`~evox_tpu_torch.resilience.ResilientRunner`'s.  ``health``
    defaults to ``HealthProbe(nonfinite_skip=("instances",))`` — nested
    states legitimately carry ``inf`` placeholders in their *init*
    instances (monitor best-so-far, unevaluated fitness), which a default
    probe would misread as corruption.
    """

    def __init__(
        self,
        workflow: Any,
        checkpoint_dir: Union[str, "Any"],
        *,
        grow: GrowthLadder | None = None,
        health: HealthProbe | None = None,
        restart: Any | None = None,
        history_limit: int = 64,
        **kwargs: Any,
    ):
        nested = find_nested(getattr(workflow, "problem", None))
        if nested is None:
            raise ValueError(
                "HPORunner supervises meta-optimization workflows: the "
                "outer workflow's problem chain must contain a "
                "NestedProblem (evox_tpu_torch.hpo)"
            )
        if grow is not None:
            if restart is not None:
                raise ValueError(
                    "grow= supplies the runner's restart policy "
                    "(HPOGrowPolicy); pass grow= or restart=, not both"
                )
            validate_ladder_window(grow, nested)
            restart = HPOGrowPolicy(grow)
        if health is None:
            health = HealthProbe(nonfinite_skip=("instances",))
        if history_limit < 1:
            raise ValueError(f"history_limit must be >= 1, got {history_limit}")
        self.grow = grow
        self.history_limit = int(history_limit)
        #: Host-side inner histories: ``{candidate_uid: [(outer_generation,
        #: [per-inner-generation best fitness...]), ...]}`` — one entry per
        #: probed boundary, re-ingested from the manifest ring on resume.
        self.candidate_history: dict[int, list[tuple[int, list[float]]]] = {}
        self._last_series: dict[int, np.ndarray] = {}
        self._last_metric_gen = 0
        # (generation, per-uid series) of the newest segment, from the
        # boundary's one read; consumed by the boundary's ingest.
        self._boundary_series: tuple[int, dict[int, np.ndarray]] | None = None
        super().__init__(workflow, checkpoint_dir, health=health, restart=restart, **kwargs)
        # Growth policies swap ``workflow.problem`` (the nested problem
        # regrows); remember the base configuration so every run() starts
        # from it and resume replays the recorded lineage on top.
        self._base_problem = getattr(workflow, "problem", None)

    # -- nested surface ------------------------------------------------------
    def _nested(self) -> NestedProblem:
        nested = find_nested(getattr(self.workflow, "problem", None))
        if nested is None:  # pragma: no cover - guarded at construction
            raise RuntimeError("workflow lost its NestedProblem")
        return nested

    def inner_history(self, uid: int) -> list[tuple[int, list[float]]]:
        """One candidate's ingested inner history (see
        :attr:`candidate_history`)."""
        return list(self.candidate_history.get(int(uid), []))

    def _reset_base_algorithm(self) -> None:
        super()._reset_base_algorithm()
        if getattr(self, "_base_problem", None) is not None and self.workflow.problem is not self._base_problem:
            self.workflow.problem = self._base_problem
            self._rebind_workflow()

    # -- manifests: inner metadata + the history ring ------------------------
    def _manifest_extras(self, probed, state=None) -> dict:
        extras = super()._manifest_extras(probed, state)
        nested = self._nested()
        config = {
            "inner_algorithm": type(nested.workflow.algorithm).__name__,
            "inner_pop": nested.inner_pop,
            "inner_dim": int(getattr(nested.workflow.algorithm, "dim", 0)),
            "iterations": nested.iterations,
            "num_candidates": nested.num_candidates,
            "num_repeats": nested.num_repeats,
        }
        extras["hpo"] = {
            **config,
            "bucket": _bucket(config),
            "history": {
                str(uid): [[int(g), [float(v) for v in series]] for g, series in entries[-self.history_limit :]]
                for uid, entries in self.candidate_history.items()
            },
        }
        return extras

    def resume(self, template: State) -> tuple[State, int] | None:
        result = super().resume(template)
        self.candidate_history = {}
        self._last_series = {}
        self._last_metric_gen = 0
        self._boundary_series = None
        if result is None:
            return None
        _, gen = result
        self._last_metric_gen = int(gen)
        try:
            manifest = read_manifest(self._ckpt_path(gen)) or {}
        except Exception:  # noqa: BLE001 - history is best-effort metadata
            manifest = {}
        history = (manifest.get("hpo") or {}).get("history") or {}
        for uid, entries in history.items():
            restored = [(int(g), [float(v) for v in series]) for g, series in entries]
            if restored:
                self.candidate_history[int(uid)] = restored
                self._last_series[int(uid)] = np.asarray(restored[-1][1], dtype=float)
        if self.candidate_history:
            self._event(
                f"re-ingested inner histories for {len(self.candidate_history)} candidate(s) from the "
                f"checkpoint manifest"
            )
        return result

    # -- boundary work: telemetry ingest + elastic growth --------------------
    def _boundary_reads(self, state: State) -> dict[str, torch.Tensor]:
        """The nested telemetry's best-fitness series and the candidate
        uids, read in the runner's one copy of a segment's scalars."""
        prob = state["problem"] if isinstance(state, State) and "problem" in state else None
        if prob is None or "telemetry" not in prob or "uids" not in prob or "best_fitness" not in prob["telemetry"]:
            return {}
        return {"hpo_best_fitness": prob["telemetry"]["best_fitness"], "hpo_uids": prob["uids"]}

    def _boundary(self, state: State, done: int, host: dict, stepped: int) -> None:
        reads = host.get("reads", {})
        if "hpo_best_fitness" in reads:
            dtype = _NUMPY_DTYPES.get(state["problem"]["telemetry"]["best_fitness"].dtype, np.float32)
            series = series_by_uid(reads["hpo_best_fitness"].astype(dtype), reads["hpo_uids"].tolist())
            self._boundary_series = (int(done), series)
        super()._boundary(state, done, host, stepped)

    def _series(self, state: State, done: int) -> dict[int, np.ndarray]:
        """Per-candidate inner best-fitness series of ``state``, keyed by
        uid: the values the boundary already read when ``state`` is the
        newest segment's, else read now (a resumed state)."""
        pending, self._boundary_series = self._boundary_series, None
        if pending is not None and pending[0] == int(done):
            return pending[1]
        return candidate_series(state["problem"])

    def _hpo_boundary(self, state: State, done: int) -> None:
        """Ingest the boundary state's nested telemetry: per-candidate
        inner best-fitness series into :attr:`candidate_history` (dedup by
        outer generation — a resumed run re-probing its landing boundary
        appends exactly the entries the uninterrupted run did) plus the
        ``evox_hpo_*`` metrics."""
        nested = self._nested()
        if "problem" not in state:
            return
        if self.obs is not None:
            outer_gens = max(int(done) - self._last_metric_gen, 0)
            if outer_gens:
                self.obs.counter(
                    "evox_hpo_inner_generations_total",
                    "Inner generations executed by the fused nested "
                    "evaluate (candidates x repeats x iterations).",
                ).inc(outer_gens * nested.inner_generations_per_eval())
            self.obs.gauge(
                "evox_hpo_inner_pop",
                "Inner population size of the nested problem (grows under the elastic ladder).",
            ).set(float(nested.inner_pop))
            self.obs.gauge("evox_hpo_candidates", "Outer candidates per nested evaluation.").set(
                float(nested.num_candidates)
            )
        self._last_metric_gen = int(done)
        for uid, series in self._series(state, done).items():
            entries = self.candidate_history.setdefault(uid, [])
            if entries and entries[-1][0] >= int(done):
                continue  # already ingested (resume re-probe)
            entries.append((int(done), [float(v) for v in series]))
            self._last_series[uid] = series

    def _consult_grow(self, done: int):
        """Consult the controller's ``hpo-grow`` plane with the newest
        per-candidate inner series; returns the fired
        :class:`~evox_tpu_torch.control.Decision` or ``None``.  Never
        raises (the controller guards itself; this is the outer guard)."""
        try:
            evidence = grow_evidence(self.grow, self._last_series, self._nested().inner_pop)
            if evidence is None:
                return None
            return self.controller.hpo_grow(evidence=evidence, generation=done)
        except Exception as e:  # noqa: BLE001 - advisory plane only
            self._event(
                f"hpo-grow consult failed ({type(e).__name__}: {e}); continuing without growth",
                warn=True,
                category="control",
            )
            return None

    def _health_boundary(self, state: State, done: int, n_steps: int) -> tuple[State, int]:
        self._hpo_boundary(state, done)
        if (
            self.grow is not None
            and self.controller is not None
            and done < n_steps
            and len(self.stats.restarts) < self.max_restarts
        ):
            decision = self._consult_grow(done)
            if decision is not None and decision.action not in ("", "hold"):
                report = HealthReport(generation=done, healthy=True).with_trend(
                    [
                        f"hpo-grow: inner-run stagnation (candidate uid "
                        f"{decision.evidence.get('candidate_uid')}, "
                        f"inner pop {decision.evidence.get('inner_pop')} "
                        f"-> {decision.action})"
                    ]
                )
                # Growth rides the restart machinery: lineage event,
                # post-growth checkpoint, stale-future invalidation —
                # needs_init=False, so the outer search continues untouched
                # at the grown inner shape.
                return self._fire_restart(state, done, n_steps, report, decision)
        return super()._health_boundary(state, done, n_steps)
