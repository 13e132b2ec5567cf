"""Evaluation monitor (counterpart of ``evox_tpu/workflows/eval_monitor.py``).

Tracks the latest solution/fitness and a running top-k as State, and keeps
the full fitness/solution history.  The JAX package streams history to the
host with ``io_callback``; here the history is a list of detached tensors
left on the device, moved to the CPU only inside the accessors — a copy in
every ``pre_tell`` would wait for the card once per generation.

With ``multi_obj=True`` the fitness is (N, m) and no top-k is kept; the
approximate Pareto front is recovered from the history on demand
(``get_pf*``), through the port's non-dominated sort (its kernels when the
history is on the card).

With ``full_pop_history=True`` the per-step auxiliary values of the
algorithm (``Algorithm.record_step``: the ES family's mean or center and
step size) are kept too, one history per key (``auxiliary_history``).

Each history entry is tagged with its ``(generation, instance)``, as the
JAX package's are.  Outside a segment an entry is recorded through a host
operator (:func:`~evox_tpu_torch.utils.vmap_ops.host_op`), so under
``torch.func.vmap`` each instance records its own entry and no batched
tensor escapes.  With ``ordered=False`` and ``num_instances=N`` (a workflow
vmapped over N instances, set up with ``instance_id``) the accessors sort
the entries by their tags and stack each generation's N entries, as JAX's
unordered callbacks are regrouped; ``ordered=True`` (the default) returns
them as recorded and, like JAX's ordered callbacks, refuses vmap.

Inside a fused segment (``StdWorkflow.run_segment`` / ``run``) the
history goes through the ``Monitor._capture`` seam instead: ``_sink`` hands
each payload to the workflow, which batches them per generation, and
:meth:`EvalMonitor.ingest_sinks` appends them at the segment boundary, in
the order stepping would have.

:meth:`EvalMonitor.plot` draws the history with
:mod:`evox_tpu_torch.vis_tools.plot` (plotly, optional).
"""

from __future__ import annotations

import warnings
from enum import IntEnum
from functools import partial
from typing import Any

import torch

from .. import resolve_device
from ..core import Monitor, State
from ..utils.vmap_ops import host_op, register_vmap_op

__all__ = ["EvalMonitor"]


class HistoryType(IntEnum):
    FITNESS = 0
    SOLUTION = 1
    AUXILIARY = 2


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _total_order_bits(f: torch.Tensor) -> torch.Tensor:
    b = f.view(_BITS[f.dtype])
    width = b.element_size() * 8
    return b ^ ((b >> (width - 1)) & ((1 << (width - 1)) - 1))


# An operator, so that vmap hands it the instances' stacked physical tensor:
# reinterpreting a dtype is a view, which functorch batches only in recent
# PyTorch releases (2.11 has no rule and no fallback for it).  The key is
# elementwise, so the stack's key is each instance's.
@register_vmap_op(vmap_fn=lambda info, in_dims, f: (_total_order_bits(f), in_dims[0]), name="total_order")
def _total_order_op(f: torch.Tensor) -> torch.Tensor:
    return _total_order_bits(f)


def _total_order(f: torch.Tensor) -> torch.Tensor:
    """Integers that order like the floats of ``f`` in IEEE total order
    (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN): the bits with the
    magnitude bits flipped where the sign is set.  Ascending, this is the
    order of ``jax.lax.top_k(-f)``; an integer ``f`` is its own key."""
    if f.dtype not in _BITS:
        return f
    return _total_order_op(f)


class EvalMonitor(Monitor):
    """Monitor hooked around evaluation; records offspring, fitness, top-k
    elites and the full history.

    One ``EvalMonitor`` instance serves ONE workflow: ``StdWorkflow``
    writes its optimization direction and device onto the instance, and the
    history lives on the instance."""

    def __init__(
        self,
        multi_obj: bool = False,
        full_fit_history: bool = True,
        full_sol_history: bool = False,
        full_pop_history: bool = False,
        topk: int = 1,
        ordered: bool = True,
        num_instances: int | None = None,
    ):
        """
        :param multi_obj: whether the optimization is multi-objective
            ((N, m) fitness; use ``get_pf*`` instead of the top-k).
        :param full_fit_history: keep every generation's fitness.
        :param full_sol_history: keep every generation's solutions.
        :param full_pop_history: keep the auxiliary records that the
            workflow feeds through ``record_auxiliary``.
        :param topk: number of elite solutions tracked.
        :param ordered: record the history in program order and refuse
            vmap; set False when the workflow is vmapped over instances.
        :param num_instances: with ``ordered=False`` under a vmapped
            workflow, the instance count: each history entry the accessors
            return carries a leading ``(num_instances,)`` axis.
        """
        self.multi_obj = multi_obj
        self.full_fit_history = full_fit_history
        self.full_sol_history = full_sol_history
        self.full_pop_history = full_pop_history
        self.topk = topk
        self.ordered = ordered
        self.num_instances = num_instances
        # The host operators of the sink sites, by (history type, slot,
        # ordered).
        self._host_sinks: dict[tuple, Any] = {}
        self.opt_direction = 1
        # The auxiliary keys in slot order, taken from the first record.
        self.aux_keys: list[str] = []
        self.device: torch.device | None = None
        self.clear_history()

    # -- config ------------------------------------------------------------
    def set_config(self, **config: Any) -> "EvalMonitor":
        for k in ("multi_obj", "full_fit_history", "full_sol_history", "topk", "opt_direction", "device",
                  "ordered", "num_instances"):
            if k in config:
                setattr(self, k, config[k])
        return self

    # -- state -------------------------------------------------------------
    def setup(self, key: torch.Tensor) -> State:
        del key
        device = resolve_device(self.device)
        empty = torch.empty((0,), device=device)

        def counter(v=0):
            return torch.tensor(v, dtype=torch.int32, device=device)

        return State(
            latest_solution=empty,
            latest_fitness=empty,
            topk_solutions=empty,
            topk_fitness=empty,
            generation=counter(),
            instance_id=counter(-1),
            # Cumulative count of individuals whose fitness came back
            # non-finite and was quarantined by the workflow.
            num_nonfinite=counter(),
            num_shard_quarantines=counter(),
            num_restarts=counter(),
            num_preemptions=counter(),
        )

    # -- hooks --------------------------------------------------------------
    def post_ask(self, state: State, population: torch.Tensor) -> State:
        return state.replace(latest_solution=population)

    def pre_tell(self, state: State, fitness: torch.Tensor) -> State:
        state = state.replace(
            latest_fitness=fitness, generation=state.generation + 1
        )
        if fitness.ndim == 2:
            # Multi-objective: no single top-k; the Pareto front is
            # recovered from the history on demand (``get_pf*``).
            return self._record(state, fitness)
        if fitness.ndim != 1:
            raise ValueError(f"Invalid fitness shape: {tuple(fitness.shape)}")
        if fitness.shape[0] < self.topk:
            raise ValueError(
                f"EvalMonitor(topk={self.topk}) needs at least topk fitness "
                f"values per generation, got a population of {fitness.shape[0]}"
            )
        k = self.topk
        if state.topk_solutions.ndim <= 1:
            # First generation: the candidates are the population alone.
            order = torch.argsort(_total_order(fitness), stable=True)[:k]
            top_sol = state.latest_solution.index_select(0, order)
            top_fit = fitness.index_select(0, order)
        else:
            # Candidates are [previous top-k; population].  A stable sort
            # of the total-order key keeps the lower index on ties, like
            # jax.lax.top_k(-f) (torch.topk promises no tie order on
            # CUDA).  The (N, D) candidate solutions are never
            # concatenated: only the k chosen rows are gathered, from
            # whichever side holds them.
            cand_fit = torch.cat([state.topk_fitness, fitness])
            order = torch.argsort(_total_order(cand_fit), stable=True)[:k]
            n_old = state.topk_fitness.shape[0]
            n_new = fitness.shape[0]
            old = state.topk_solutions.index_select(0, order.clamp(max=n_old - 1))
            new = state.latest_solution.index_select(
                0, (order - n_old).clamp(0, n_new - 1)
            )
            top_sol = torch.where((order < n_old)[:, None], old, new)
            top_fit = cand_fit.index_select(0, order)
        state = state.replace(topk_fitness=top_fit, topk_solutions=top_sol)
        return self._record(state, fitness)

    def _record(self, state: State, fitness: torch.Tensor) -> State:
        if self.full_sol_history:
            self._sink(state.latest_solution, HistoryType.SOLUTION, state)
        if self.full_fit_history:
            self._sink(fitness, HistoryType.FITNESS, state)
        return state

    def _sink(self, data: torch.Tensor, data_type: int, state: State, slot: int = 0) -> None:
        """Record ``data`` in the history, or, inside a fused segment
        (``_capture`` is a list), hand it to the workflow with its site
        identity and tags; :meth:`ingest_sinks` appends it at the
        boundary."""
        if self._capture is not None:
            self._capture.append(
                (int(data_type), slot, data.detach(), state.generation, state.instance_id)
            )
            return
        site = (int(data_type), int(slot), self.ordered)
        sink = self._host_sinks.get(site)
        if sink is None:
            sink = self._host_sinks[site] = host_op(partial(self._append, *site[:2]), ordered=self.ordered)
        sink(data.detach(), state.generation, state.instance_id)

    def _append(self, data_type: int, slot: int, data: torch.Tensor, generation: torch.Tensor,
                instance: torch.Tensor) -> None:
        """One history entry ``(generation, instance, slot, data)``, left on
        its device: the tags are read only by the accessors that sort by
        them.  An auxiliary entry's slot is its key's place in
        ``aux_keys``."""
        self._history[data_type].append((generation, instance, slot, data))

    def ingest_sinks(self, meta, sinks, executed, lane: int | None = None) -> None:
        """Boundary flush of a fused segment's captured sink batches into
        the history (the batched counterpart of recording every
        generation).

        :param meta: ``[(history_type, slot), ...]`` — one site descriptor
            per sink call of the step, in program order.
        :param sinks: ``[(data, generations, instances), ...]`` matching
            ``meta``, each with a leading ``(n_generations,)`` axis — or
            ``(n_instances, n_generations, ...)`` for a vmapped segment.
        :param executed: how many of the batched generations ran (a segment
            may stop early on an unhealthy state); rows past it are padding
            and are dropped.  A scalar, or ``(n_instances,)`` for a vmapped
            segment.
        :param lane: demux mode: ingest only this instance-axis row of a
            vmapped pack's telemetry into this monitor, as if the lane had
            run alone (``TenantPack`` routes each lane's rows to its
            tenant's monitor this way).  The tags come from the lane's own
            rows, so the history is entry for entry the tenant's solo one.

        Entries are appended per generation in site order, as stepping
        records them, on the device the telemetry lies on (a pack's is on
        the host).  Call once per executed segment: ingesting the same
        telemetry twice duplicates entries."""
        executed = torch.as_tensor(executed)
        if lane is not None:
            if executed.ndim == 0:
                raise ValueError(
                    "ingest_sinks(lane=...) demuxes a VMAPPED pack's "
                    "telemetry (leading instance axis); this telemetry is "
                    "unbatched — ingest it directly"
                )
            lane = int(lane)
            executed = executed[lane]
            sinks = [tuple(torch.as_tensor(x)[lane] for x in site) for site in sinks]
        if executed.ndim == 0:
            for g in range(int(executed)):
                for (data_type, slot), (data, gens, insts) in zip(meta, sinks):
                    self._append(int(data_type), int(slot), data[g], gens[g], insts[g])
            return
        # A vmapped segment: a leading instance axis on every batch.
        for b, n in enumerate(executed.tolist()):
            for g in range(int(n)):
                for (data_type, slot), (data, gens, insts) in zip(meta, sinks):
                    self._append(int(data_type), int(slot), data[b, g], gens[b, g], insts[b, g])

    def record_history(self, state: State) -> State:
        """Record the latest solution and fitness in the history by hand
        (the automatic path does this inside :meth:`pre_tell`)."""
        return self._record(state, state.latest_fitness)

    def record_auxiliary(self, state: State, aux: dict[str, Any]) -> State:
        """Record the algorithm's per-step auxiliary values (one history per
        key) when ``full_pop_history`` is on.  The keys and their slot order
        are taken from the first record (``record_step`` returns the same
        keys every generation)."""
        if self.full_pop_history:
            if not self.aux_keys:
                self.aux_keys = list(aux.keys())
            for slot, k in enumerate(self.aux_keys):
                self._sink(aux[k], HistoryType.AUXILIARY, state, slot=slot)
        return state

    def record_nonfinite(self, state: State, mask: torch.Tensor) -> State:
        """Count quarantined individuals (non-finite fitness rows replaced
        by the workflow's worst-case penalty) into ``num_nonfinite``."""
        if "num_nonfinite" not in state:
            return state
        return state.replace(
            num_nonfinite=state.num_nonfinite + mask.sum(dtype=torch.int32)
        )

    def record_shard_quarantine(self, state: State, shard_mask: torch.Tensor) -> State:
        """Count shard-quarantine events (whole mesh shards penalized by the
        workflow's shard-granular quarantine) into
        ``num_shard_quarantines``: each ``True`` of the per-shard mask is
        one event."""
        if "num_shard_quarantines" not in state:
            return state
        return state.replace(
            num_shard_quarantines=state.num_shard_quarantines + shard_mask.sum(dtype=torch.int32)
        )

    def record_restart(self, state: State) -> State:
        """Count an automatic restart (fired by a supervising
        ``ResilientRunner`` restart policy) into the cumulative
        ``num_restarts`` counter.  Runs between segments; the counter lives
        in the monitor state, so it is checkpointed and survives
        kill-and-resume with the rest of the run."""
        if "num_restarts" not in state:
            return state
        return state.replace(num_restarts=state.num_restarts + 1)

    def record_preemption(self, state: State) -> State:
        """Count a graceful preemption (a signal or maintenance event caught
        by a supervising ``PreemptionGuard``) into ``num_preemptions``, at
        the tripping boundary, just before the emergency checkpoint is
        written — so the counter the resumed run restores includes it."""
        if "num_preemptions" not in state:
            return state
        return state.replace(num_preemptions=state.num_preemptions + 1)

    def truncate_history(self, generation: int) -> None:
        """Drop history entries tagged PAST ``generation`` — rollback
        support: a run restarted from an earlier checkpoint replays those
        generations, and the stale entries would otherwise sit beside (and,
        for the unordered accessors, collide with) the replay's.  Entries
        at or before ``generation`` are the ones the restored state's
        trajectory already produced, so they stay.  Reads each entry's
        generation tag on the host."""
        for data_type in list(self._history):
            self._history[data_type] = [e for e in self._history[data_type] if int(e[0]) <= generation]

    # -- history accessors (host side) --------------------------------------
    def clear_history(self) -> None:
        """Drop this monitor's history (state-side top-k and latest buffers
        are untouched)."""
        self._history: dict[int, list] = {t: [] for t in HistoryType}

    def _grouped(self, entries: list) -> list[torch.Tensor]:
        """The data of ``(generation, instance, slot, data)`` entries as CPU
        tensors.

        ``ordered=True``: in the order they were recorded.

        ``ordered=False``: sorted by their ``(generation, instance)`` tags
        (stably: entries without an instance id, -1, keep their order within
        a generation), then, with ``num_instances=N``, each generation's N
        per-instance entries stacked into one (N, ...) tensor.  A reused
        monitor must be ``clear_history()``-ed between runs: duplicate tags
        raise rather than mis-group."""
        if self.ordered:
            return [d.cpu() for (_, _, _, d) in entries]
        tags = [(int(g), int(i)) for (g, i, _, _) in entries]
        tagged = [t for t in tags if t[1] != -1]
        if len(set(tagged)) != len(tagged):
            raise RuntimeError(
                "duplicate (generation, instance) history tags: this monitor recorded more than one run; "
                "call clear_history() (or use a fresh monitor) between unordered/vmapped runs"
            )
        order = sorted(range(len(entries)), key=lambda j: tags[j])
        data = [entries[j][3].cpu() for j in order]
        n = self.num_instances
        if not n or n <= 1:
            return data
        if len(data) % n:
            raise RuntimeError(
                f"history has {len(data)} entries, not a multiple of num_instances={n}: was the "
                f"workflow vmapped over {n} instances?"
            )
        return [torch.stack(data[i : i + n]) for i in range(0, len(data), n)]

    @property
    def fitness_history(self) -> list[torch.Tensor]:
        """Per-generation fitness, as CPU tensors (``fit_history`` is the
        alias)."""
        return self._grouped(self._history[HistoryType.FITNESS])

    fit_history = fitness_history

    @property
    def solution_history(self) -> list[torch.Tensor]:
        """Per-generation solutions, as CPU tensors (requires
        ``full_sol_history``; ``sol_history`` is the alias)."""
        return self._grouped(self._history[HistoryType.SOLUTION])

    sol_history = solution_history

    @property
    def auxiliary_history(self) -> dict[str, list[torch.Tensor]]:
        """Per-key lists of per-generation auxiliary records (from
        ``Algorithm.record_step``), as CPU tensors; ``aux_history`` is the
        alias."""
        raw = self._history[HistoryType.AUXILIARY]
        return {k: self._grouped([e for e in raw if e[2] == slot]) for slot, k in enumerate(self.aux_keys)}

    aux_history = auxiliary_history

    def get_fitness_history(self) -> list[torch.Tensor]:
        """``fitness_history`` with the original optimization sign
        restored."""
        return [self.opt_direction * f for f in self.fitness_history]

    def get_solution_history(self) -> list[torch.Tensor]:
        """``solution_history`` (CPU tensors)."""
        return self.solution_history

    # -- plotting -------------------------------------------------------------
    def plot(self, problem_pf=None, source: str = "eval", **kwargs):
        """Plot the fitness history with :mod:`evox_tpu_torch.vis_tools.plot`
        (1/2/3-objective dispatch); ``None`` with a warning when nothing was
        recorded, when plotly is missing, or for more than 3 objectives.

        :param problem_pf: the true Pareto front overlaid on a 2- or
            3-objective plot (a tensor on any device, or a numpy array).
        :param source: ``"eval"`` plots the evaluated fitness (the original
            sign restored); ``"pop"`` the algorithm's own record
            ``aux_history["fit"]``.
        :param kwargs: passed on to the plot function (``animation=False``
            for a static figure, plotly layout options)."""
        if not self.fitness_history and not self.aux_history:
            warnings.warn("No fitness history recorded, return None")
            return None
        from ..vis_tools import plot

        if source == "pop":
            fitness_history = self.aux_history["fit"]
        elif source == "eval":
            fitness_history = self.get_fitness_history()
        else:
            raise ValueError(f"Invalid source argument: {source}, expect 'eval' or 'pop'.")
        if not fitness_history:
            warnings.warn(f"No data recorded for source={source!r}, return None")
            return None
        n_objs = 1 if fitness_history[0].ndim == 1 else fitness_history[0].shape[1]
        try:
            if n_objs == 1:
                return plot.plot_obj_space_1d(fitness_history, **kwargs)
            if n_objs == 2:
                return plot.plot_obj_space_2d(fitness_history, problem_pf, **kwargs)
            if n_objs == 3:
                return plot.plot_obj_space_3d(fitness_history, problem_pf, **kwargs)
        except ImportError as e:
            # plotly is optional.
            warnings.warn(f"No visualization tool available ({e}), return None")
            return None
        warnings.warn("Not supported yet.")
        return None

    # -- result accessors ----------------------------------------------------
    def get_latest_fitness(self, state: State) -> torch.Tensor:
        """Fitness of the latest generation (original sign restored)."""
        return self.opt_direction * state.latest_fitness

    def get_latest_solution(self, state: State) -> torch.Tensor:
        """Population of the latest generation (pre-transform solutions)."""
        return state.latest_solution

    def get_num_nonfinite(self, state: State) -> torch.Tensor:
        """Cumulative count of individuals quarantined for non-finite
        fitness."""
        return state.num_nonfinite

    def get_num_shard_quarantines(self, state: State) -> torch.Tensor:
        """Cumulative count of shard-quarantine events (whole mesh shards
        penalized by the workflow's shard-granular quarantine)."""
        return state.num_shard_quarantines

    def get_num_restarts(self, state: State) -> torch.Tensor:
        """Cumulative count of automatic restarts."""
        return state.num_restarts

    def get_num_preemptions(self, state: State) -> torch.Tensor:
        """Cumulative count of graceful preemptions."""
        return state.num_preemptions

    def get_topk_fitness(self, state: State) -> torch.Tensor:
        """Best ``topk`` fitness values so far (original sign restored)."""
        return self.opt_direction * state.topk_fitness

    def get_topk_solutions(self, state: State) -> torch.Tensor:
        """Solutions achieving the best ``topk`` fitness values so far."""
        self._assert_single("get_topk_solutions")
        return state.topk_solutions

    def get_best_solution(self, state: State) -> torch.Tensor:
        """The single best solution so far."""
        self._assert_single("get_best_solution")
        return state.topk_solutions[0]

    def get_best_fitness(self, state: State) -> torch.Tensor:
        """The single best fitness so far (original sign restored)."""
        self._assert_single("get_best_fitness")
        return self.opt_direction * state.topk_fitness[0]

    def _assert_single(self, name: str) -> None:
        if self.multi_obj:
            raise ValueError(
                f"Multi-objective optimization does not have a single best; "
                f"use get_pf_* instead of {name}"
            )

    # -- Pareto front from history -------------------------------------------
    def _pooled(self, kind: HistoryType) -> torch.Tensor:
        """Every generation's rows of one history, concatenated (on the
        device the history lives on)."""
        return torch.cat([d.reshape(-1, d.shape[-1]) for (_, _, _, d) in self._history[kind]], dim=0)

    def get_pf_fitness(self, deduplicate: bool = True) -> torch.Tensor:
        """Approximate Pareto-front fitness over all evaluations so far
        (requires ``full_fit_history``), on the history's device."""
        from ..operators.selection import non_dominate_rank

        if not self.multi_obj:
            raise ValueError("get_pf_fitness is only available for multi-objective optimization.")
        if not self.full_fit_history:
            warnings.warn("`get_pf_fitness` requires enabling `full_fit_history`.")
        all_fit = self._pooled(HistoryType.FITNESS)
        if deduplicate:
            all_fit = torch.unique(all_fit, dim=0)
        # Only the first front is consumed: stop peeling after it.
        rank = non_dominate_rank(all_fit, until_count=1)
        return all_fit[rank == 0] * self.opt_direction

    def get_pf(self, deduplicate: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Approximate Pareto-front ``(solutions, fitness)`` over all
        evaluations (requires ``full_sol_history`` and
        ``full_fit_history``), on the history's device."""
        from ..operators.selection import non_dominate_rank

        if not self.multi_obj:
            raise ValueError("get_pf is only available for multi-objective optimization.")
        if not (self.full_fit_history and self.full_sol_history):
            warnings.warn("`get_pf` requires enabling both `full_sol_history` and `full_fit_history`.")
        all_sol = self._pooled(HistoryType.SOLUTION)
        all_fit = self._pooled(HistoryType.FITNESS)
        if deduplicate:
            # The first occurrence of each distinct solution, in order.
            _, inverse = torch.unique(all_sol, dim=0, return_inverse=True)
            pos = torch.arange(all_sol.shape[0], device=all_sol.device)
            first = torch.full((int(inverse.max()) + 1,), all_sol.shape[0], device=all_sol.device)
            first = first.scatter_reduce(0, inverse, pos, reduce="amin")
            idx = torch.sort(first).values
            all_sol, all_fit = all_sol[idx], all_fit[idx]
        rank = non_dominate_rank(all_fit, until_count=1)
        return all_sol[rank == 0], all_fit[rank == 0] * self.opt_direction

    def get_pf_solutions(self, deduplicate: bool = True) -> torch.Tensor:
        """Solutions of :meth:`get_pf` (requires both full histories)."""
        sol, _ = self.get_pf(deduplicate)
        return sol
