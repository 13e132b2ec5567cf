"""The fused nested runner (counterpart of ``evox_tpu/hpo/nested.py``): an
entire inner workflow batch as one outer evaluation.

:class:`NestedProblem` is the meta-optimization core: the outer population
is a batch of hyper-parameter sets, and evaluating it runs
``num_candidates`` independent copies of an inner
:class:`~evox_tpu_torch.workflows.StdWorkflow` for ``iterations``
generations.  As in the JAX package, one evaluation is one vmap (two, with
repeats) of one inner run — ``init_step``, the inner workflow's segment
program (:meth:`StdWorkflow._segment_program
<evox_tpu_torch.workflows.StdWorkflow._segment_program>`) over the middle
``iterations - 2`` generations, ``final_step`` — here ``torch.func.vmap``,
and every inner run's per-generation best-fitness series rides out as
telemetry.

On the card an evaluation replays a CUDA graph of the whole vmapped batch,
captured once per shape and configuration (``utils/graph.py``): functorch's
host cost, tens of microseconds for each vmapped operation, and the
launches of the batch's thousands of operations are paid at capture, as XLA
compiles the nested program once.  Inside an enclosing capture (the outer
workflow's ``run``/``run_segment``) the batch is captured inline, under a
functorch transform (HPO of HPO) and on the CPU it runs eagerly.  A capture
that fails raises its error; there is no eager fallback on the card.

**Nested PRNG contract** (``prng="uid"``, the default): candidate ``i``'s
inner instance is keyed by ``rng.fold_in(key, uid_i)`` and its repeat ``j``
by ``rng.fold_in(candidate_key, j)``.  The uid is a stable identity carried
in the problem state (``state.uids``), never a lane position, so a
candidate's inner randomness does not depend on how many neighbours it has.
``prng="split"`` keeps the wrapper's schedule, one ``rng.split_keys(key, n
* r)`` (:class:`~evox_tpu_torch.problems.hpo_wrapper.HPOProblemWrapper`
uses it).  The uids are int64: every uint32 uid of the JAX package fits,
``rng.fold_in`` takes an int64 word, and torch's uint32 supports few
operations.

Inner states are consumed per evaluation: every evaluation starts from the
same init instances, so the problem state the outer workflow threads is the
instances, the uids and the latest evaluation's telemetry.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Literal, Mapping

import torch

from ..core import Problem, State, Workflow, get_params, set_params
from ..parallel import iter_problem_chain
from ..utils import graph, rng
from .monitor import _REPEAT_LEVEL, _REPEAT_WIRING, HPOMonitor, _reduce_axis

__all__ = ["NestedProblem", "candidate_series", "find_nested"]


def candidate_series(problem_state: Any) -> dict[int, Any]:
    """Per-candidate inner best-fitness series from a nested problem
    sub-state's telemetry (repeat lanes averaged), keyed by the stable
    candidate uid, as numpy arrays on the host.  Empty when the state
    carries no usable telemetry."""
    if problem_state is None or "telemetry" not in problem_state or "uids" not in problem_state:
        return {}
    tel = problem_state["telemetry"]
    if "best_fitness" not in tel:
        return {}
    return series_by_uid(tel["best_fitness"].detach().cpu().numpy(), problem_state["uids"].detach().cpu().tolist())


def series_by_uid(series: Any, uids: Any) -> dict[int, Any]:
    """The telemetry's best-fitness series (a host array of shape
    (candidates, [repeats,] inner generations)) keyed by candidate uid, the
    repeat lanes averaged."""
    if series.ndim == 3:
        series = series.mean(axis=1)
    return {int(u): series[i] for i, u in enumerate(uids)}


def find_nested(problem: Any) -> "NestedProblem | None":
    """The :class:`NestedProblem` inside a problem wrapper chain, or
    ``None``."""
    for p in iter_problem_chain(problem):
        if getattr(p, "hpo_nested", False):
            return p
    return None


class NestedProblem(Problem):
    """An inner workflow batch as an outer ``Problem`` (see the module
    docstring for the program and the PRNG contract).

    Usage::

        inner = StdWorkflow(PSO(64, lb, ub), Sphere(), monitor=HPOFitnessMonitor())
        nested = NestedProblem(inner, iterations=32, num_candidates=16)
        outer = StdWorkflow(OpenES(...), nested,
                            solution_transform=lambda x: {"algorithm.w": x[:, 0]})

    :param workflow: the inner workflow; its monitor must be an
        :class:`~evox_tpu_torch.hpo.HPOMonitor` (``tell_fitness`` defines
        the score of a run).
    :param iterations: total inner generations per evaluation, including the
        init and final steps (>= 2).  The middle ``iterations - 2`` are the
        segment program.
    :param num_candidates: parallel inner-workflow instances = outer
        population size.
    :param num_repeats: independent repeats per candidate (distinct key
        streams); hyper-parameters are shared across repeats.
    :param fit_aggregation: reduction over the repeats axis, called as
        ``fit_aggregation(stacked, axis=0)``; default ``torch.mean``.
    :param aggregation: ``"per_generation"`` (the monitor sees the
        repeat-aggregated fitness every generation and tracks the best of
        the mean) or ``"final"`` (each repeat lane tracks its own best; the
        lanes' final scores are aggregated once).
    :param prng: ``"uid"`` (default: identity-keyed ``fold_in(key, uid)``
        instance streams) or ``"split"`` (one ``split_keys`` schedule).
    :param telemetry: carry each evaluation's inner telemetry
        (per-generation best-fitness series, executed counts) in the
        problem state (``state.telemetry``); ``False`` drops it.
    :param base_uid: first candidate uid (uids are ``base_uid ..
        base_uid + num_candidates - 1``).
    """

    #: Marker the meta-layers' wrapper-chain walk (:func:`find_nested`)
    #: keys on.
    hpo_nested = True

    def __init__(
        self,
        workflow: Workflow,
        iterations: int,
        num_candidates: int,
        *,
        num_repeats: int = 1,
        fit_aggregation: Callable = torch.mean,
        aggregation: Literal["per_generation", "final"] = "per_generation",
        prng: Literal["uid", "split"] = "uid",
        telemetry: bool = True,
        base_uid: int = 0,
    ):
        if iterations < 2:
            raise ValueError(f"iterations must be at least 2 (init + final), got {iterations}")
        if num_candidates < 1:
            raise ValueError(f"num_candidates must be >= 1, got {num_candidates}")
        if num_repeats < 1:
            raise ValueError(f"num_repeats must be >= 1, got {num_repeats}")
        if aggregation not in ("per_generation", "final"):
            raise ValueError(f"aggregation must be 'per_generation' or 'final', got {aggregation!r}")
        if prng not in ("uid", "split"):
            raise ValueError(f"prng must be 'uid' or 'split', got {prng!r}")
        if base_uid < 0:
            raise ValueError(f"base_uid must be >= 0, got {base_uid}")
        monitor = getattr(workflow, "monitor", None)
        if not isinstance(monitor, HPOMonitor):
            raise ValueError(f"Expect workflow monitor to be `HPOMonitor`, got {type(monitor)}")
        if not hasattr(workflow, "_segment_program"):
            raise ValueError(
                f"NestedProblem needs an inner workflow exposing the fused segment builder "
                f"(_segment_program); got {type(workflow).__name__}"
            )
        self.workflow = workflow
        self.iterations = int(iterations)
        self.num_candidates = int(num_candidates)
        self.num_repeats = int(num_repeats)
        self.fit_aggregation = fit_aggregation
        self.aggregation = aggregation
        self.prng = prng
        self.telemetry = bool(telemetry)
        self.base_uid = int(base_uid)
        self._seg_cfg = None
        # Captured evaluations, one per input structure.
        self._graphs = graph.Cache()

    @property
    def capturable(self) -> bool:
        """An evaluation runs the inner problem's: capturable when it is."""
        return bool(getattr(self.workflow.problem, "capturable", True))

    # -- pickling -------------------------------------------------------------
    def __getstate__(self) -> dict:
        d = dict(self.__dict__)
        d["_seg_cfg"] = None
        # Captured graphs cannot (and must not) cross a process boundary.
        d["_graphs"] = graph.Cache()
        wf = copy.copy(d["workflow"])
        if hasattr(wf, "_graphs"):
            wf._graphs = graph.Cache()
        d["workflow"] = wf
        return d

    # -- derived configuration --------------------------------------------------
    @property
    def inner_pop(self) -> int:
        """The inner algorithm's population size."""
        return int(getattr(self.workflow.algorithm, "pop_size", 0))

    def inner_generations_per_eval(self) -> int:
        """Inner generations one outer evaluation executes across all
        candidates and repeats."""
        return self.num_candidates * self.num_repeats * self.iterations

    def _cfg(self):
        if self._seg_cfg is None:
            # History capture off (the inner monitor's score lives in its
            # state), no health metrics (the per-generation best_fitness
            # channel is the meta-telemetry), no early stop.
            self._seg_cfg = self.workflow.segment_config(
                capture_history=False, metrics=False, stop_on_unhealthy=False, barrier=False
            )
        return self._seg_cfg

    # -- state construction -----------------------------------------------------
    def _candidate_uids(self, device) -> torch.Tensor:
        return torch.arange(self.num_candidates, dtype=torch.int64, device=device) + self.base_uid

    def setup(self, key: torch.Tensor) -> State:
        n, r = self.num_candidates, self.num_repeats
        vmap = torch.func.vmap
        uids = self._candidate_uids(key.device)
        if self.prng == "uid":
            # Identity-keyed instance streams: the candidate uid keys the
            # candidate, the repeat index keys the repeat.
            cand_keys = vmap(lambda uid: rng.fold_in(key, uid))(uids)
            if r > 1:
                reps = torch.arange(r, dtype=torch.int64, device=key.device)
                keys = vmap(lambda ck: vmap(lambda rep: rng.fold_in(ck, rep))(reps))(cand_keys)
                stacked = vmap(vmap(self.workflow.setup))(keys)
            else:
                stacked = vmap(self.workflow.setup)(cand_keys)
        else:
            flat_keys = torch.stack(rng.split_keys(key, n * r))
            stacked = vmap(self.workflow.setup)(flat_keys)
            if r > 1:
                leaves, spec = graph.flatten(stacked)
                stacked = graph.unflatten(spec, [t.reshape((n, r) + t.shape[1:]) for t in leaves])
        state = State(instances=stacked, uids=uids)
        if self.telemetry:
            state = state.replace(telemetry=self._zero_telemetry(stacked))
        return state

    def get_init_params(self, state: State) -> dict[str, torch.Tensor]:
        """The stacked hyper-parameter dict of the inner workflow: every
        ``Parameter``-labelled leaf, keyed by dotted path, with a leading
        ``(num_candidates,)`` axis (repeats share hyper-parameters)."""
        params = get_params(state.instances)
        if self.num_repeats > 1:
            params = {k: v[:, 0] for k, v in params.items()}
        return params

    def get_params_keys(self, state: State) -> list[str]:
        """Dotted paths of every tunable (``Parameter``-labelled) leaf."""
        return list(self.get_init_params(state).keys())

    # -- the nested evaluation ----------------------------------------------------
    def _run_one(self, ws: State, hp: Mapping[str, Any]):
        """One inner run: init, the segment program, final.  Returns
        ``(tell_fitness, telemetry State)``."""
        wf = self.workflow
        ws = set_params(ws, hp)
        ws = wf.init_step(ws)
        inner = self.iterations - 2
        raw = None
        if inner > 0:
            (ws,), raw, _ = wf._segment_program(self._cfg())((ws,), inner)
        ws = wf.final_step(ws)
        return wf.monitor.tell_fitness(ws.monitor), self._pack_telemetry(raw, inner, ws)

    @staticmethod
    def _pack_telemetry(raw: Any, inner: int, ws: State) -> State:
        """The JAX package's telemetry of one inner run: the segment's
        ``executed``/``stopped`` (no early stop: all of its generations,
        never stopped) and its per-generation best fitness."""
        device = graph.flatten(ws)[0][0].device
        executed = torch.full((), inner, dtype=torch.int32, device=device)
        if raw is None:  # iterations == 2: no middle segment
            return State(executed=executed)
        out: dict[str, Any] = {"executed": executed, "stopped": torch.zeros((), dtype=torch.bool, device=device)}
        if "best_fitness" in raw:
            out["best_fitness"] = raw["best_fitness"]
        return State(**out)

    def _run_batch(self, instances: State, hp: Mapping[str, Any]):
        """The whole outer evaluation: one ``torch.func.vmap`` (two, with
        repeats) of the inner run over the candidates.  Returns
        ``(fitness (num_candidates,), telemetry)``."""
        vmap = torch.func.vmap
        hp = dict(hp)
        if self.num_repeats == 1:
            return vmap(self._run_one)(instances, hp)
        if self.aggregation == "per_generation":
            # The repeat lanes run under a vmap whose level binds the repeat
            # axis; the monitor's ``aggregate_repeats`` reduces over it each
            # generation, so every lane's best tracks the aggregated fitness
            # and the lanes' final tells are equal: read lane 0.
            def lane(w, h):
                token = _REPEAT_LEVEL.set(torch._C._functorch.maybe_current_level())
                try:
                    return self._run_one(w, h)
                finally:
                    _REPEAT_LEVEL.reset(token)

            fit, tel = vmap(lambda ws, h: vmap(lambda w: lane(w, h))(ws))(instances, hp)
            return fit[:, 0], tel
        # "final": aggregate each lane's independent end-of-run best.
        fit, tel = vmap(lambda ws, h: vmap(lambda w: self._run_one(w, h))(ws))(instances, hp)
        return _reduce_axis(self.fit_aggregation, fit, 1), tel

    def _wiring(self) -> tuple[int, Callable]:
        per_gen = self.aggregation == "per_generation" and self.num_repeats > 1
        return (self.num_repeats, self.fit_aggregation) if per_gen else (1, torch.mean)

    def _zero_telemetry(self, instances: State) -> State:
        """Zeros shaped like one evaluation's telemetry: the problem state
        carries the telemetry from construction, so its structure never
        changes across steps.  JAX traces the batch abstractly
        (``jax.eval_shape``); here the structure is what
        :meth:`_pack_telemetry` makes of the segment program's outputs, and
        the best-fitness entry's presence and dtype come from the segment's
        own expression applied to one instance's state on the ``meta``
        device: no inner code runs."""
        lead = (self.num_candidates,) + ((self.num_repeats,) if self.num_repeats > 1 else ())
        leaves, spec = graph.flatten(instances)
        device = leaves[0].device
        out: dict[str, Any] = {"executed": torch.zeros(lead, dtype=torch.int32, device=device)}
        inner = self.iterations - 2
        if inner > 0:
            out["stopped"] = torch.zeros(lead, dtype=torch.bool, device=device)
            from ..resilience.health import _best_fitness_expr, _subtree

            one = graph.unflatten(spec, [t[(0,) * len(lead)].to("meta") for t in leaves])
            algo = _subtree(one, "algorithm")
            best = _best_fitness_expr(one, algo if algo is not None else one)
            if best is not None:
                out["best_fitness"] = torch.zeros(lead + (inner,) + tuple(best.shape), dtype=best.dtype, device=device)
        return State(**out)

    def _program(self, carry: tuple, length: int):
        """The evaluation as the program of ``graph.run``: ``length`` is 1."""
        del length
        instances, hp = carry
        return self._run_batch(instances, hp), {}, None

    def evaluate(self, state: State, hyper_parameters: Mapping[str, Any]) -> tuple[torch.Tensor, State]:
        # Wire the monitor's repeat aggregation for the duration of this
        # evaluation only, context-locally: several wrappers may share one
        # workflow object, so nothing is set on the shared monitor.
        token = _REPEAT_WIRING.set(self._wiring())
        try:
            carry = (state.instances, dict(hyper_parameters))
            device = graph.flatten(state.instances)[0][0].device
            if self.capturable and graph.replays(device):
                (fit, tel), _, _ = graph.run(self._graphs, ("nested", self._cfg(), self._wiring()), self._program,
                                             carry, 1)
            else:
                (fit, tel), _, _ = self._program(carry, 1)
        finally:
            _REPEAT_WIRING.reset(token)
        # The inner states are consumed per evaluation (every evaluation
        # starts from the same init instances); only the latest
        # evaluation's telemetry threads forward.
        if self.telemetry and "telemetry" in state:
            state = state.replace(telemetry=tel)
        return fit, state

    def reset_graphs(self) -> None:
        """Drop the captured evaluations and their memory pool (a growth
        replaces this nest: its graphs must not outlive it)."""
        self._graphs = graph.Cache()

    # -- growth surface -------------------------------------------------------------
    def with_inner_workflow(self, workflow: Workflow) -> "NestedProblem":
        """A copy of this configuration over a different inner workflow."""
        return type(self)(
            workflow,
            self.iterations,
            self.num_candidates,
            num_repeats=self.num_repeats,
            fit_aggregation=self.fit_aggregation,
            aggregation=self.aggregation,
            prng=self.prng,
            telemetry=self.telemetry,
            base_uid=self.base_uid,
        )

    def with_inner_pop(self, pop_size: int, inner_factory: Callable[[int], Any]) -> "NestedProblem":
        """A copy with the inner algorithm regrown to ``pop_size`` through
        ``inner_factory``: same inner problem, monitor, transforms,
        precision policy and key impl, larger population."""
        from ..workflows import StdWorkflow

        wf = self.workflow
        new_wf = StdWorkflow(
            inner_factory(int(pop_size)),
            wf.problem,
            monitor=wf.monitor,
            opt_direction="min" if wf.opt_direction == 1 else "max",
            solution_transform=wf.solution_transform,
            fitness_transform=wf.fitness_transform,
            quarantine_nonfinite=wf.quarantine_nonfinite,
            nonfinite_penalty=wf.nonfinite_penalty,
            precision=getattr(wf, "precision", None),
            key_impl=getattr(wf, "key_impl", None),
        )
        return self.with_inner_workflow(new_wf)

    def regrow_state(self, old_state: State, salt: int) -> State:
        """A fresh problem sub-state for this (regrown) configuration,
        derived from the old state's first key and ``salt`` alone, so
        replaying a growth rebuilds the same instances; the candidate uids
        are kept by construction."""
        from ..resilience.health import _is_prng, _leaves_with_path

        base = None
        for name, leaf in _leaves_with_path(old_state):
            if _is_prng(leaf, name):
                base = leaf.reshape(-1, 2)[0]
                break
        if base is None:
            base = rng.key(0)
        return self.setup(rng.fold_in(base, torch.full((), int(salt), dtype=torch.int64, device=base.device)))
