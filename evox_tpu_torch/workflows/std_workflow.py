"""Standard ask-eval-tell workflow (counterpart of
``evox_tpu/workflows/std_workflow.py``, the single-device subset).

``step(state) -> state`` runs one generation eagerly.  The evaluation proxy
is an explicit ``evaluate`` closure handed to ``Algorithm.step``; monitor
and problem sub-states are carried through it.

Fused multi-generation runs (:meth:`StdWorkflow.run`,
:meth:`StdWorkflow.run_segment`) are the counterpart of JAX's compiled
``fori_loop`` and ``lax.scan``: on the card the generations are one replay
of a captured CUDA graph (``utils/graph.py``), on the CPU the same
generation code runs eagerly in a Python loop (the plain version).  Either
way the state equals that of the same number of :meth:`StdWorkflow.step`
calls, bit for bit.

``torch.func.vmap`` maps ``setup`` (``instance_id`` labels each instance),
``init_step`` and ``step`` over stacked instances; the kernels batch
through their operators' rules (:mod:`evox_tpu_torch.utils.vmap_ops`).

The precision plane (:mod:`evox_tpu_torch.precision`): under
``precision=PrecisionPolicy()`` the algorithm's declared leaves are carried
in the storage dtype between generations (so a fused segment's captured
graph keeps one dtype per leaf) and promoted to the compute dtype for each
generation's math, at the one seam in :meth:`StdWorkflow._step`;
``key_impl`` names the stream family of the workflow's keys.

Distributed evaluation (``enable_distributed=True``, ``mesh=``): the
problem is wrapped in a :class:`~evox_tpu_torch.parallel.ShardedProblem`
over a :class:`~evox_tpu_torch.parallel.PopMesh` of ranks (a one-rank NCCL
group on one card when no process group exists): every rank steps the
same replicated algorithm state, evaluates its row block, and one
all-gather returns the whole fitness.  On the card the all-gather is
captured with the generations of a fused segment into its CUDA graph.
``quarantine_granularity="shard"`` condemns every row of a shard that
produced a non-finite row.

The flight recorder's signals (``segment_config(flight=True)``,
``run_segment(flight=True)``): :func:`~evox_tpu_torch.obs.flight_signals`
of every generation's state, stacked as ``telemetry["flight"]`` — tensor
reductions captured with the generations, which the state they compute
does not depend on.

The service layer's lane freeze (``segment_config(lane_freeze=True)``,
``run_segment(frozen=...)``): the segment takes a ``frozen`` flag in its
carry (so a captured graph is never recaptured for it), every generation
steps unconditionally and a select keeps the stepped or the frozen state.
Under ``torch.func.vmap`` that is one flag a lane, the body of
:class:`~evox_tpu_torch.service.TenantPack`'s captured program.

``run_segment`` under ``torch.func.vmap`` runs its generations eagerly (a
graph's static buffers cannot hold the transform's batched tensors) and
returns the telemetry with a leading instance axis, as JAX's
``jax.vmap(lambda s: wf.run_segment(s, n))`` does.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import torch

from ..core import Algorithm, Monitor, Problem, State, Workflow
from ..obs.flight import flight_signals
from ..parallel import ShardedProblem, find_sharded, iter_problem_chain, make_pop_mesh, shard_row_ids
from ..resilience.health import _best_fitness_expr, _subtree, scan_state
from ..utils import rng
from ..utils import graph

__all__ = ["StdWorkflow", "SegmentConfig", "check_kernel_dtypes"]


class SegmentConfig(NamedTuple):
    """Configuration of one fused multi-generation segment (hashable: one
    captured graph per distinct configuration, as JAX compiles one program
    per distinct static configuration).  The fields are the JAX package's.

    ``check_nonfinite`` / ``nonfinite_skip`` / ``diversity`` / ``step_size``
    / ``shards`` select the health metrics computed on the segment's final
    state (:func:`~evox_tpu_torch.resilience.health.scan_state`).
    ``diversity_floor`` / ``step_size_range`` are the early-stop thresholds;
    with ``stop_on_unhealthy`` the generation that first produces an
    unhealthy state is the segment's last that counts: every later one is
    computed and its result dropped by a per-leaf select (a graph cannot
    skip work), so the state stays frozen.  ``barrier`` is accepted and has
    no effect (eager PyTorch fuses nothing it could pin).  ``flight``
    stacks the flight recorder's signals of every generation.
    ``lane_freeze`` makes the segment take a ``frozen`` flag as the
    initial stop flag (the service's no-recapture eviction): the same
    select body, with the health predicate only under
    ``stop_on_unhealthy``.  Build one with
    :meth:`StdWorkflow.segment_config`."""

    capture_history: bool = True
    metrics: bool = True
    check_nonfinite: bool = True
    nonfinite_skip: tuple = ()
    diversity: bool = False
    step_size: bool = False
    shards: int | None = None
    diversity_floor: float | None = None
    step_size_range: tuple | None = None
    stop_on_unhealthy: bool = False
    barrier: bool = True
    lane_freeze: bool = False
    flight: bool = False


def _tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    """``a`` where ``pred`` else ``b``, leaf by leaf (a 0-dim bool ``pred``;
    the values of the selected operand are returned exactly)."""
    la, spec = graph.flatten(a)
    lb, _ = graph.flatten(b)
    return graph.unflatten(spec, [torch.where(pred, x, y) for x, y in zip(la, lb)])


def _stack(outs: list, dim: int = 0) -> Any:
    """Per-generation outputs stacked along a new axis ``dim`` (the leading
    one; 1 behind a lane axis)."""
    first, spec = graph.flatten(outs[0])
    columns = [graph.flatten(o)[0] for o in outs]
    return graph.unflatten(spec, [torch.stack([c[i] for c in columns], dim) for i in range(len(first))])


def check_kernel_dtypes(algorithm: Algorithm, device: torch.device, dtype: torch.dtype | None) -> None:
    """Refuse, before anything runs, an algorithm whose step would hand a
    CUDA kernel a compute dtype it does not take: on a CUDA ``device``, each
    kernel the algorithm declares in ``kernel_dtypes`` (``{kernel name:
    dtypes}``) must take ``dtype``.  Raises :class:`TypeError` naming the
    kernels and the dtypes they take.  The CPU runs every dtype (the plain
    versions), so nothing is refused there."""
    table = getattr(algorithm, "kernel_dtypes", None)
    if device.type != "cuda" or dtype is None or not table:
        return
    refusing = {name: dtypes for name, dtypes in table.items() if dtype not in dtypes}
    if refusing:
        kernels = "; ".join(
            f"{name} takes {' or '.join(str(d).split('.')[-1] for d in dtypes)}" for name, dtypes in refusing.items()
        )
        raise TypeError(
            f"{type(algorithm).__name__} on {device} computes in {str(dtype).split('.')[-1]}, which its CUDA "
            f"kernels refuse ({kernels}); compute in a dtype they take or run on the CPU (device='cpu'): "
            f"a {str(dtype).split('.')[-1]} kernel route is not ported"
        )


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
        :param precision: a :class:`~evox_tpu_torch.precision.PrecisionPolicy`:
            the algorithm's ``storage_leaves`` are carried in its storage
            dtype between generations and promoted to its compute dtype
            within each.  An algorithm that declares none raises
            ``TypeError`` here.
        :param key_impl: the stream family of the workflow's keys
            (:data:`~evox_tpu_torch.precision.KEY_IMPLS`; resolved once,
            here, also from ``EVOX_TPU_KEY_IMPL``).  ``setup`` builds an int
            seed's key in it and re-seeds a key of another family.  Without
            it (and the variable) a key is used as it is given.
        :param enable_distributed: shard evaluation over ``pop_axis`` of
            ``mesh`` (the problem is wrapped in a
            :class:`~evox_tpu_torch.parallel.ShardedProblem` unless its
            wrapper chain already holds one); ``pop_size`` must divide the
            axis unless that problem pads.
        :param mesh: the :class:`~evox_tpu_torch.parallel.PopMesh` to shard
            over; by default :func:`~evox_tpu_torch.parallel.make_pop_mesh`
            over every rank (a one-rank group when none is set up, on the
            algorithm's device).  Stored only when ``enable_distributed``:
            an unsharded workflow is not mesh-bound.
        :param quarantine_granularity: ``"individual"`` penalizes exactly the
            non-finite rows; ``"shard"`` (sharded evaluation only) condemns
            every row of a shard that produced one, reported to
            ``Monitor.record_shard_quarantine``.
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
        self.opt_direction = 1 if opt_direction == "min" else -1
        self.algorithm = algorithm
        self.problem = problem
        self.enable_distributed = bool(enable_distributed)
        if enable_distributed and mesh is None:
            mesh = make_pop_mesh(axis_name=pop_axis, device=getattr(algorithm, "device", None))
        # Only a distributed workflow is mesh-bound (the elastic layer's
        # workflow_mesh reads this).
        self.mesh = mesh if enable_distributed else None
        self.pop_axis = pop_axis
        if enable_distributed:
            n_shards = mesh.shape[pop_axis]
            pop_size = getattr(algorithm, "pop_size", None)
            # The chain walk keeps a wrapper around an existing
            # ShardedProblem from being sharded twice.
            existing = find_sharded(self.problem)
            pads = existing is not None and existing.pad
            if pop_size is not None and pop_size % n_shards != 0 and not pads:
                raise ValueError(
                    f"Distributed evaluation shards the population over the "
                    f"'{pop_axis}' mesh axis; pop_size={pop_size} must be "
                    f"divisible by the {n_shards} devices on that axis "
                    f"(or wrap the problem in ShardedProblem(pad=True) to "
                    f"pad and mask instead)."
                )
            if existing is None:
                self.problem = ShardedProblem(self.problem, mesh, pop_axis)
        sharded = find_sharded(self.problem)
        for p in iter_problem_chain(self.problem):
            if hasattr(p, "in_sharded_program"):
                p.in_sharded_program = sharded is not None
        self.quarantine_granularity = quarantine_granularity
        # Shards of the evaluation the workflow runs through, for the
        # shard-granular quarantine and the per-shard health metrics.
        self._n_shards = int(sharded.mesh.shape[sharded.axis_name]) if sharded is not None else None
        if quarantine_granularity == "shard" and self._n_shards is None:
            raise ValueError(
                "quarantine_granularity='shard' needs a sharded evaluation: "
                "pass enable_distributed=True (or wrap the problem in "
                "ShardedProblem) so rows map to mesh shards"
            )
        # The numerics plane: audit the policy against the algorithm's
        # declaration now (an undeclared algorithm fails here), and resolve
        # the key impl once, from the argument or the environment.
        self.precision = precision
        if precision is not None:
            precision.leaf_map(algorithm)
        if key_impl is not None or os.environ.get("EVOX_TPU_KEY_IMPL"):
            from ..precision import resolve_key_impl

            key_impl = resolve_key_impl(key_impl)
        self.key_impl = key_impl
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
        # Captured CUDA graphs of fused segments (``utils/graph.py``).
        self._graphs = graph.Cache()

    # -- state -------------------------------------------------------------
    def setup(self, key: int | torch.Tensor, instance_id: int | torch.Tensor | None = None) -> State:
        """Build the initial workflow state from an int seed or a key
        (:func:`evox_tpu_torch.utils.rng.key`); the keys live on the
        algorithm's device (where it names none, a seed's key on the CPU).
        An int seed's key is of the workflow's ``key_impl``, and a key of
        another family is re-seeded on the device
        (:func:`~evox_tpu_torch.precision.coerce_key`).  The state is
        returned in its storage form (:meth:`apply_precision`).  On the card,
        a compute dtype (the policy's, else the algorithm's ``dtype``) that
        one of the algorithm's kernels refuses raises :class:`TypeError`
        here, before anything runs (:func:`check_kernel_dtypes`).

        :param instance_id: optional integer label of this workflow
            instance, stored in the monitor state (its ``instance_id``
            leaf) and attached to every history entry.  Pass it when
            vmapping over instances, so that the history is grouped by
            instance whatever order it was recorded in::

                states = torch.func.vmap(wf.init)(keys, torch.arange(n))
                states = torch.func.vmap(wf.init_step)(states)
                step = torch.func.vmap(wf.step)
        """
        key = self._setup_key(key)
        # The state lands on the key's device: refuse a compute dtype the
        # algorithm's kernels there would refuse, before any launch.
        compute = self.precision.compute_dtype if self.precision is not None else getattr(self.algorithm, "dtype", None)
        check_kernel_dtypes(self.algorithm, key.device, compute)
        algo_key, prob_key, mon_key = rng.split_keys(key, 3)
        mon_state = self.monitor.setup(mon_key)
        if instance_id is not None and "instance_id" in mon_state:
            mon_state = mon_state.replace(
                instance_id=torch.as_tensor(instance_id).to(device=mon_state.instance_id.device, dtype=torch.int32)
            )
        return self.apply_precision(
            State(
                algorithm=self.algorithm.setup(algo_key),
                problem=self.problem.setup(prob_key),
                monitor=mon_state,
            )
        )

    def _setup_key(self, key: int | torch.Tensor) -> torch.Tensor:
        """The workflow's key from ``setup``'s argument, on the algorithm's
        device and of the workflow's ``key_impl`` (tensor operations on a
        given key: no host sync)."""
        device = getattr(self.algorithm, "device", None)
        if self.key_impl is not None or not isinstance(key, torch.Tensor):
            from ..precision import coerce_key

            return coerce_key(key, self.key_impl, device)
        return key if device is None else key.to(device)

    @property
    def _precision_leaf_map(self) -> dict | None:
        """The policy's per-leaf dtype map for the current algorithm
        (computed on use, never cached)."""
        if self.precision is None:
            return None
        return self.precision.leaf_map(self.algorithm)

    def apply_precision(self, state: State) -> State:
        """The storage form of a workflow state under this workflow's
        policy (the state itself without one): the mapped algorithm leaves
        demoted to their storage dtype.  The map is validated against the
        state's real leaf names here (``ValueError`` on a misnamed one)."""
        if self.precision is None:
            return state
        leaf_map = self._precision_leaf_map
        self.precision.validate_state(state.algorithm, leaf_map)
        return state.replace(algorithm=self.precision.demote(state.algorithm, leaf_map))

    init = setup  # convenience alias

    def get_submodule(self, target: str) -> Any:
        """Dotted-path component lookup: ``"algorithm"``, ``"problem"``,
        ``"monitor"``, or an attribute path below one of them."""
        obj = self
        for part in target.split("."):
            obj = getattr(obj, part)
        return obj

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
        shard_mode = self.quarantine_granularity == "shard"
        if not fit.is_floating_point():
            mask = torch.zeros((fit.shape[0],), dtype=torch.bool, device=fit.device)
            mon = self.monitor.record_nonfinite(mon, mask)
            if shard_mode:
                shards = torch.zeros((self._n_shards,), dtype=torch.bool, device=fit.device)
                mon = self.monitor.record_shard_quarantine(mon, shards)
            return fit, mon
        # Clamp the penalty into the dtype's finite range: 1e30 would itself
        # round to inf in float16 fitness, defeating the quarantine.
        penalty = min(self.nonfinite_penalty, float(torch.finfo(fit.dtype).max))
        bad = ~torch.isfinite(fit)
        row_bad = bad if fit.ndim == 1 else bad.any(dim=-1)
        if shard_mode:
            # Any bad row condemns every row its shard evaluated: the
            # finite-looking rows of a broken device must not survive
            # selection.  The row -> shard map is the parallel layer's.
            ids = shard_row_ids(row_bad.shape[0], self._n_shards, fit.device)
            counts = torch.zeros((self._n_shards,), dtype=torch.int32, device=fit.device)
            shard_bad = counts.index_add(0, ids, row_bad.to(torch.int32)) > 0
            mon = self.monitor.record_shard_quarantine(mon, shard_bad)
            row_bad = shard_bad[ids]
        mon = self.monitor.record_nonfinite(mon, row_bad)
        # Demote the whole individual, not just its non-finite components.
        row_mask = row_bad if fit.ndim == 1 else row_bad[:, None]
        worst = torch.full((), self.opt_direction * penalty, dtype=fit.dtype, device=fit.device)
        return torch.where(row_mask, worst, fit), mon

    # -- stepping ----------------------------------------------------------
    def _step(self, state: State, which: str) -> State:
        # The precision seam: the mapped leaves are promoted to the compute
        # dtype for this generation's math and demoted on the way out, so
        # evaluation, the monitor and the best folds see the compute dtype
        # and everything carried between generations the storage form.
        if self.precision is None:
            return self._step_inner(state, which)
        leaf_map = self._precision_leaf_map
        state = state.replace(algorithm=self.precision.promote(state.algorithm, leaf_map))
        state = self._step_inner(state, which)
        return state.replace(algorithm=self.precision.demote(state.algorithm, leaf_map))

    def _step_inner(self, state: State, which: str) -> State:
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

    def run(self, state: State, n_steps: int, init: bool = True, unroll: int = 1) -> State:
        """Run ``n_steps`` generations: ``init_step`` (when ``init``, eagerly)
        followed by ``step`` as one fused segment (the counterpart of JAX's
        ``lax.fori_loop``) — on the card, one replay of the captured CUDA
        graph of the remaining generations that :meth:`run_segment` uses,
        with no host sync between generations; on the CPU, the same
        generations eagerly.  The monitor's history is flushed at the end,
        entry for entry what stepping records.  The state equals
        ``n_steps`` steps bit for bit.

        :param unroll: accepted for the JAX signature; no effect.  A graph
            of ``unroll`` generations replayed in turn would copy the state
            back into its input buffers after every replay, which at large
            populations costs most of a generation."""
        del unroll
        if init:
            state = self.init_step(state)
            n_steps -= 1
        if n_steps < 1:
            return state
        # Under torch.func.vmap the monitor records every generation itself
        # (through its host operators, one call an instance), as JAX's
        # vmapped ``fori_loop`` fires its callbacks.
        vmapped = torch._C._functorch.peek_interpreter_stack() is not None
        cfg = self.segment_config(metrics=False, capture_history=not vmapped)
        state, telemetry = self._run_segment(state, n_steps, cfg)
        self.flush_telemetry(telemetry)
        return state

    # -- run-health surface -------------------------------------------------
    def health_metrics(self, state: State) -> dict[str, torch.Tensor]:
        """Snapshot of the run-health metrics (0-dim tensors on the state's
        device; nothing is read back to the host), with the JAX package's
        keys:

        * ``nonfinite_state_values`` — count of NaN/±Inf scalars anywhere in
          the state (floating leaves; keys and integer leaves skipped);
        * ``pop_diversity`` — largest per-dimension std of the population
          (when the algorithm state carries a 2-D ``pop``);
        * ``step_size_min`` / ``step_size_max`` — extrema of the ES
          ``sigma`` leaf (when present);
        * ``best_fitness`` — monitor top-k best (minimizing frame) when
          available, else ``min(state.algorithm.fit)``;
        * ``num_nonfinite`` / ``num_shard_quarantines`` / ``num_restarts`` /
          ``num_preemptions`` — the monitor's cumulative counters (when the
          monitor tracks them).

        Keys are present only when the state supports them, so the dict is
        stable per workflow configuration."""
        raw = scan_state(state, diversity=True, step_size=True)
        out: dict[str, torch.Tensor] = {}
        nonfinite = raw.get("nonfinite")
        if nonfinite:
            out["nonfinite_state_values"] = sum(nonfinite.values())
        if "diversity" in raw:
            out["pop_diversity"] = raw["diversity"]
        if "step_size_min" in raw:
            out["step_size_min"] = raw["step_size_min"]
            out["step_size_max"] = raw["step_size_max"]
        if "best_fitness" in raw:
            out["best_fitness"] = raw["best_fitness"]
        mon = _subtree(state, "monitor")
        if mon is not None:
            for key in ("num_nonfinite", "num_shard_quarantines", "num_restarts", "num_preemptions"):
                if key in mon:
                    out[key] = mon[key]
        return out

    # -- fused segments -------------------------------------------------------
    def segment_config(
        self,
        *,
        capture_history: bool = True,
        metrics: bool = True,
        stop_on_unhealthy: bool = False,
        health: Any | None = None,
        barrier: bool = True,
        lane_freeze: bool = False,
        flight: bool = False,
    ) -> SegmentConfig:
        """Build the :class:`SegmentConfig` for :meth:`run_segment` (the JAX
        package's options).

        :param capture_history: batch the monitor's history out of the
            segment as telemetry (flushed by :meth:`flush_telemetry`).
            ``False`` is JAX's per-generation debug mode; here it is the
            eager loop, the monitor recording every generation itself.
        :param metrics: the health-metric snapshot of the final state.
        :param stop_on_unhealthy: freeze the segment when a generation
            produces an unhealthy state (see :class:`SegmentConfig`).
        :param health: an object with ``HealthProbe``'s detector-config
            attributes (``check_nonfinite``, ``nonfinite_skip``,
            ``diversity_floor``, ``step_size_range``, ``shards``); without
            it the metric set mirrors :meth:`health_metrics` and the early
            stop watches non-finite state only.
        :param barrier: accepted for the JAX signature; no effect.
        :param flight: stack the flight recorder's per-generation signals
            (:func:`~evox_tpu_torch.obs.flight_signals` of each stepped
            state, raw form) as ``telemetry["flight"]``.
        :param lane_freeze: the segment takes a ``frozen`` flag (the
            service layer's eviction and quarantine: a frozen segment's
            state and counters stay as they are, and changing the flag
            never recaptures).  ``barrier`` is then False, as in JAX.
        """
        barrier = bool(barrier) and not lane_freeze
        if health is not None:
            step_range = getattr(health, "step_size_range", None)
            return SegmentConfig(
                capture_history=bool(capture_history),
                metrics=bool(metrics),
                check_nonfinite=bool(getattr(health, "check_nonfinite", True)),
                nonfinite_skip=tuple(getattr(health, "nonfinite_skip", ())),
                diversity=getattr(health, "diversity_floor", None) is not None,
                step_size=step_range is not None,
                shards=getattr(health, "shards", None),
                diversity_floor=getattr(health, "diversity_floor", None),
                step_size_range=None if step_range is None else tuple(step_range),
                stop_on_unhealthy=bool(stop_on_unhealthy),
                barrier=bool(barrier),
                lane_freeze=bool(lane_freeze),
                flight=bool(flight),
            )
        return SegmentConfig(
            capture_history=bool(capture_history),
            metrics=bool(metrics),
            check_nonfinite=True,
            diversity=True,
            step_size=True,
            shards=self._n_shards,
            stop_on_unhealthy=bool(stop_on_unhealthy),
            barrier=bool(barrier),
            lane_freeze=bool(lane_freeze),
            flight=bool(flight),
        )

    def _capture_step(self, state: State, meta_out: list, capture: bool, which: str = "step"):
        """One generation with the monitor's history redirected into a
        capture list (``Monitor._capture``).  Returns the new state and the
        captured payloads, one ``(data, generation, instance)`` triple per
        sink site in program order, and records the site identities
        ``(history_type, slot)`` in ``meta_out``."""
        mon = self.monitor
        cap: list | None = [] if capture else None
        prev = mon._capture
        if cap is not None:
            mon._capture = cap
        try:
            new_state = self._step(state, which)
        finally:
            if cap is not None:
                mon._capture = prev
        entries = cap or []
        meta_out[:] = [(t, slot) for (t, slot, _, _, _) in entries]
        return new_state, tuple((data, gen, inst) for (_, _, data, gen, inst) in entries)

    def _unhealthy(self, state: State, cfg: SegmentConfig) -> torch.Tensor:
        """The early-stop predicate (a 0-dim bool tensor, never read on the
        host).  It scans only what it reads: a captured graph keeps every
        metric computed, used or not."""
        raw = scan_state(
            state,
            check_nonfinite=cfg.check_nonfinite,
            nonfinite_skip=cfg.nonfinite_skip,
            diversity=cfg.diversity_floor is not None,
            step_size=cfg.step_size_range is not None,
            shards=cfg.shards,
        )
        bad = None
        counts = raw.get("nonfinite")
        if counts:
            bad = sum(counts.values()) > 0
        if "diversity" in raw:
            low = raw["diversity"] < cfg.diversity_floor
            bad = low if bad is None else bad | low
        if "step_size_min" in raw:
            lo, hi = cfg.step_size_range
            out = ~((raw["step_size_min"] >= lo) & (raw["step_size_max"] <= hi))
            bad = out if bad is None else bad | out
        if "shard_nonfinite" in raw:
            # A shard whose every row is non-finite is dead.
            rows = raw["shard_rows"]
            dead = ((rows > 0) & (raw["shard_nonfinite"] == rows)).any()
            bad = dead if bad is None else bad | dead
        if cfg.diversity_floor is not None and "shard_diversity" in raw:
            low = (raw["shard_diversity"] < cfg.diversity_floor).any()
            bad = low if bad is None else bad | low
        return bad

    @staticmethod
    def _scan_metrics(state: State, cfg: SegmentConfig) -> dict:
        return scan_state(
            state,
            check_nonfinite=cfg.check_nonfinite,
            nonfinite_skip=cfg.nonfinite_skip,
            diversity=cfg.diversity,
            step_size=cfg.step_size,
            shards=cfg.shards,
        )

    @staticmethod
    def _selects(cfg: SegmentConfig) -> bool:
        """Whether a segment of ``cfg`` carries ``(state, stopped,
        executed)`` and selects each generation's result."""
        return cfg.stop_on_unhealthy or cfg.lane_freeze

    def _generation(self, cfg: SegmentConfig, which: str = "step") -> Callable:
        """One generation of a segment: ``generation(carry, meta) ->
        (carry, out)``; ``carry`` is ``(state,)`` or, with the early stop or
        the lane freeze, ``(state, stopped, executed)``; ``out`` holds the
        captured sinks, the best fitness and the flight signals; ``meta``
        receives the sink sites' identities.  It runs under
        ``torch.func.vmap`` as it is (one stop flag a lane: the service's
        packs)."""

        def generation(carry: tuple, meta: list) -> tuple[tuple, dict]:
            st = carry[0]
            new_st, ys = self._capture_step(st, meta, cfg.capture_history, which)
            if graph.structure(new_st) != graph.structure(st):
                raise ValueError(
                    "a fused segment needs a state whose structure, shapes and dtypes "
                    "a generation keeps (run init_step first)"
                )
            out: dict[str, Any] = {"sinks": ys}
            algo = _subtree(new_st, "algorithm")
            best = _best_fitness_expr(new_st, algo if algo is not None else new_st)
            if best is not None:
                out["best_fitness"] = best
            if cfg.flight:
                # Reductions of the stepped state, outputs only: the carry
                # never reads them.
                out["flight"] = flight_signals(new_st, raw=True)
            if not self._selects(cfg):
                return (new_st,), out
            _, stopped, executed = carry
            # A stopped (or frozen) segment keeps its state, keys included,
            # and reports zeros, as JAX's cond-guarded body; the step still
            # runs (a graph cannot skip it), and the select returns the kept
            # operand exactly.
            kept = _tree_where(stopped, st, new_st)
            leaves, spec = graph.flatten(out)
            out = _tree_where(stopped, graph.unflatten(spec, [torch.zeros_like(t) for t in leaves]), out)
            # Under a pure lane freeze the stop flag enters only through
            # ``frozen``: no health predicate runs in the segment.
            bad = self._unhealthy(kept, cfg) if cfg.stop_on_unhealthy else None
            stopped_next = stopped if bad is None else stopped | bad
            return (kept, stopped_next, executed + (~stopped).to(torch.int32)), out

        return generation

    def _segment_program(self, cfg: SegmentConfig, which: str = "step") -> Callable:
        """The segment body: ``program(carry, L) -> (carry, outs, meta)``
        runs ``L`` generations (:meth:`_generation`) eagerly; ``outs``
        holds each generation's outputs stacked along a leading axis;
        ``meta`` the sink sites' identities.  On the card
        :func:`graph.run` captures it, on the CPU it runs as it is."""
        generation = self._generation(cfg, which)

        def program(carry: tuple, length: int):
            meta: list = []
            outs = []
            for _ in range(length):
                carry, out = generation(carry, meta)
                outs.append(out)
            return carry, _stack(outs), list(meta)

        return program

    def _segment_plan(self, state: State, n_steps: int, cfg: SegmentConfig, frozen: Any = None):
        """``(device, carry, program, key)`` of a segment: ``key`` is the
        graph cache's key on the card, ``None`` where the generations run
        eagerly (the CPU, ``capture_history=False``, and under
        ``torch.func.vmap``, whose batched tensors a graph's static buffers
        cannot hold)."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if cfg.lane_freeze and frozen is None:
            raise ValueError(
                "SegmentConfig(lane_freeze=True) compiles the segment to "
                "take the frozen flag as a traced input; pass frozen="
            )
        if frozen is not None and not cfg.lane_freeze:
            raise ValueError(
                "frozen= requires SegmentConfig(lane_freeze=True): the "
                "cond-guarded program shape must be chosen at config time "
                "so cached executables stay in sync with their inputs"
            )
        leaves, _ = graph.flatten(state)
        device = leaves[0].device if leaves else torch.device("cpu")
        carry: tuple = (state,)
        if self._selects(cfg):
            if frozen is None:
                stopped = torch.zeros((), dtype=torch.bool, device=device)
            elif isinstance(frozen, torch.Tensor):
                stopped = frozen.to(device=device, dtype=torch.bool)
            else:
                # A fill, not a copy from the host.
                stopped = torch.full((), bool(frozen), dtype=torch.bool, device=device)
            carry = (state, stopped, torch.zeros((), dtype=torch.int32, device=device))
        program = self._segment_program(cfg)
        key = None
        vmapped = torch._C._functorch.peek_interpreter_stack() is not None
        if device.type == "cuda" and cfg.capture_history and not vmapped:
            if not self.problem.capturable:
                raise NotImplementedError(
                    f"StdWorkflow.run / run_segment on the card with {type(self.problem).__name__}, "
                    "whose evaluation calls the host (a CUDA graph cannot): step the workflow eagerly"
                )
            # The metrics are computed on the final state after the replay,
            # so one capture serves every metric setting (the shards count
            # only in the early stop's predicate, inside the graph).
            shards = cfg.shards if cfg.stop_on_unhealthy else None
            key = ("step", cfg._replace(metrics=False, diversity=False, step_size=False, shards=shards))
        return device, carry, program, key

    def prepare_segment(
        self, state: State, n_steps: int, cfg: SegmentConfig, before: Callable[[], None] | None = None
    ) -> bool:
        """Capture, without replaying it, the CUDA graph that
        :meth:`_run_segment` would replay for ``(state, n_steps, cfg)``;
        returns whether a capture was made now (``False`` on the CPU, in
        the eager debug mode, and when the graph is already captured).  The
        capture's warm-up generation steps a clone of ``state``.  The
        resilient runner calls this before a segment, so the capture (the
        counterpart of the JAX package's ahead-of-time compile) is timed
        apart from the replay.  ``before`` is called just before a capture
        is made."""
        _, carry, program, key = self._segment_plan(state, int(n_steps), cfg)
        if key is None:
            return False
        return graph.prepare(self._graphs, key, program, carry, int(n_steps), before)

    def reset_graphs(self) -> None:
        """Drop every captured segment and its memory pool (a changed
        algorithm must not replay a graph of the old one); the cache's
        reserved capacity is kept."""
        self._graphs = graph.Cache(self._graphs.max_graphs)

    def reserve_graphs(self, n: int) -> None:
        """Keep at least ``n`` captured segments before dropping the least
        recently used one (a runner under self-tuning cadence reserves one
        for every length its cadence can pick)."""
        self._graphs.max_graphs = max(self._graphs.max_graphs, int(n))

    def _run_segment(self, state: State, n_steps: int, cfg: SegmentConfig, frozen: Any = None):
        device, carry, program, key = self._segment_plan(state, n_steps, cfg, frozen)
        if key is not None:
            carry, outs, meta = graph.run(self._graphs, key, program, carry, n_steps)
        else:
            # The CPU, the per-generation debug mode and vmap: the same
            # generations, eagerly.
            carry, outs, meta = program(carry, n_steps)
        final = carry[0]
        if self._selects(cfg):
            stopped, executed = carry[1], carry[2]
        else:
            stopped = torch.zeros((), dtype=torch.bool, device=device)
            executed = torch.full((), n_steps, dtype=torch.int32, device=device)
        telemetry: dict[str, Any] = {"stopped": stopped, "executed": executed, "sinks": outs["sinks"]}
        if "best_fitness" in outs:
            telemetry["best_fitness"] = outs["best_fitness"]
        if "flight" in outs:
            telemetry["flight"] = outs["flight"]
        if cfg.metrics:
            telemetry["metrics"] = self._scan_metrics(final, cfg)
        # The sites' identities, fixed when the segment was captured (a CPU
        # tensor: flushing reads it without waiting for the card).
        telemetry["sink_meta"] = torch.tensor(meta, dtype=torch.int32).reshape(len(meta), 2)
        return final, State(**telemetry)

    def run_segment(
        self,
        state: State,
        n_steps: int,
        *,
        capture_history: bool = True,
        metrics: bool = True,
        stop_on_unhealthy: bool = False,
        health: Any | None = None,
        barrier: bool = True,
        frozen: Any | None = None,
        flight: bool = False,
    ) -> tuple[State, State]:
        """Run ``n_steps`` generations as ONE fused segment and return
        ``(state, telemetry)`` (the counterpart of JAX's ``lax.scan``
        segment).

        On the card the segment is one replay of a captured CUDA graph of
        ``n_steps`` generations (captured on first use per configuration,
        state structure and ``n_steps``; a workflow keeps its last few
        captures, in one memory pool), with no host sync; on the CPU the
        same generation code runs eagerly.  Quarantine and the
        monitor's counters stay in the step; the monitor's history is
        captured into the telemetry (``capture_history``; flush it with
        :meth:`flush_telemetry`); the best fitness of every generation, the
        health metrics of the final state (``metrics``) and an optional
        early stop (``stop_on_unhealthy``) ride along.  The state equals
        ``n_steps`` :meth:`step` calls bit for bit when the early stop is
        off, and up to the generation that stopped it when it is on.

        The telemetry is a :class:`~evox_tpu_torch.core.State`, with the
        JAX package's keys and shapes::

            stopped       bool    — the early stop tripped
            executed      int32   — generations that counted
            sinks         tuple   — per sink site, (data, generation,
                                    instance) batches of leading length
                                    n_steps
            best_fitness  (n,)    — per-generation best (minimizing
                                    frame), when the state exposes one
            metrics       dict    — scan_state() of the final state
            flight        dict    — with ``flight=True``, the flight
                                    recorder's raw signals, each (n,)
                                    (:func:`evox_tpu_torch.obs.flight_signals`)
            sink_meta     (k, 2)  — int32 (history_type, slot) of each sink
                                    site (a CPU tensor)

        Under ``torch.func.vmap`` the generations run eagerly, and every
        telemetry entry gains the leading instance axis (``sink_meta``
        becomes ``(B, k, 2)``).

        :param barrier: accepted for the JAX signature; no effect.
        :param frozen: a bool (or a 0-dim bool tensor, one a lane under
            vmap): the segment's initial stop flag.  A frozen segment keeps
            its state and reports 0 generations executed; its generations
            still run (a graph cannot skip them) and their results are
            selected away.  Given, the segment is built with
            ``lane_freeze=True``.
        """
        cfg = self.segment_config(
            capture_history=capture_history,
            metrics=metrics,
            stop_on_unhealthy=stop_on_unhealthy,
            health=health,
            barrier=barrier,
            lane_freeze=frozen is not None,
            flight=flight,
        )
        return self._run_segment(state, int(n_steps), cfg, frozen)

    def flush_telemetry(self, telemetry: Any) -> None:
        """Boundary flush: append a fused segment's captured history to the
        monitor (a no-op for monitors without history).  Call exactly once
        per executed segment: flushing twice duplicates entries.  Reads the
        number of generations executed (one wait for the card a segment)."""
        sinks = telemetry["sinks"] if "sinks" in telemetry else ()
        ingest = getattr(self.monitor, "ingest_sinks", None)
        if ingest is None or not sinks:
            return
        ingest(self.sink_meta_pairs(telemetry), sinks, telemetry["executed"])

    @staticmethod
    def sink_meta_pairs(telemetry: Any) -> list[tuple[int, int]]:
        """The ``(history_type, slot)`` identity of each sink site in a
        segment's telemetry, as ``ingest_sinks`` expects it."""
        meta = telemetry["sink_meta"]
        if meta.ndim == 3:
            meta = meta[0]
        return [(int(t), int(s)) for t, s in meta.tolist()]
