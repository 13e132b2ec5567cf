"""Deterministic fault injection for resilience testing (counterpart of
``evox_tpu/resilience/faults.py``).

:class:`FaultyProblem` wraps any :class:`~evox_tpu_torch.core.Problem` and
injects, on a schedule keyed by the 0-based **evaluation index** (which
lives in the wrapper's state, so it is checkpointed and rolls back with the
run):

* **device faults** — tensor operations on the fitness, keyed by the
  evaluation index in the state, so they run inside a captured segment on
  the card: NaN rows (``nan_generations``), ``+inf`` rows
  (``inf_generations``), stagnation plateaus (``plateau_from`` /
  ``plateau_until``: fitness clamped from below) and dead shards
  (``dead_shards``: a whole shard's row block goes NaN);
* **host faults** — injected exceptions (:class:`InjectedBackendError`,
  whose message carries ``UNAVAILABLE``, retryable;
  :class:`InjectedFatalError`, carrying ``NONRETRYABLE``), delays, a real
  ``SIGTERM`` to the process, attempt-counted in-state corruption,
  straggler shards and the eval deadline with its penalty fallback.  A CUDA
  graph cannot call the host, so with any of them scheduled the wrapper's
  ``capturable`` is ``False``, and the runner steps those segments
  eagerly, on the card all the same.  The injected exception reaches the
  caller as itself (the JAX package's arrives wrapped in an XLA runtime
  error; both retry predicates give the same verdict on both).

Transient faults are **attempt-counted on the host side**: a fault fires
for its first ``*_times`` attempts of a given evaluation index and then
stops, modeling an outage that passes — which is what lets retry/resume
tests complete.  Counters live on the wrapper instance, not in the state:
a retry that reloads the checkpoint rolls the evaluation index back but
still sees the outage as "over".

* **tenant-keyed lane faults** — ``lane_faults={uid: {...}}``: NaN rows,
  ``+inf`` rows and plateaus that fire only where the state's
  ``fault_lane`` leaf holds ``uid`` (the service stamps each tenant's uid
  there; an unpacked run carries ``-1`` and matches nothing).  They are
  tensor operations, so they run under a pack's ``torch.func.vmap`` inside
  its captured graph; a lane delay is a host hook, called once a lane
  through a host operator with a batching rule, and makes the wrapper not
  capturable.

The **whole fault plan is audited at construction** with the JAX
package's checks and messages.  The fleet faults (``kill_process_at``,
``partition_process_at``, ``slow_process_at``) are not ported yet
(ROADMAP Queue 1, item 13.7): setting one raises
:class:`NotImplementedError`.

:class:`FaultyStore` is the storage-side counterpart: a
:class:`~evox_tpu_torch.utils.CheckpointStore` that injects torn
publishes, bit flips, ``ENOSPC``/``EIO``, crash-between-temp-and-rename,
and slow disks by **save schedule** (0-based count of saves through the
store).
"""

from __future__ import annotations

import errno
import os
import signal
import threading
import time
from typing import Any, Mapping, Sequence

import torch

from ..core import Problem, State
from ..utils.checkpoint import CheckpointStore
from ..utils.vmap_ops import host_op
from .schedule import validate_schedule

__all__ = [
    "FaultyProblem",
    "FaultyStore",
    "InjectedBackendError",
    "InjectedFatalError",
    "InjectedStorageError",
    "validate_schedule",
]


class InjectedBackendError(RuntimeError):
    """Simulated transient backend loss (retryable signature)."""


class InjectedFatalError(RuntimeError):
    """Simulated unrecoverable crash (carries the NONRETRYABLE marker)."""


class InjectedStorageError(OSError):
    """Simulated storage failure (crash between temp write and publish)."""


class FaultyProblem(Problem):
    """Wraps a problem with a deterministic, generation-scheduled fault plan.

    The wrapper is numerically transparent (same fitness, no extra draws) —
    host faults raise/sleep but never touch the data path, and NaN/Inf
    injection only fires on scheduled evaluations.  The parameters are the
    JAX package's (see the module docstring and
    ``evox_tpu/resilience/faults.py`` for each one's meaning).

    :attr:`capturable` is ``False`` whenever a host fault is scheduled
    (whatever its ``*_times``, so a ``*_times=0`` comparator steps the same
    way; a lane delay included), or when the wrapped problem is not
    capturable.
    """

    _FLEET_ITEM = "ROADMAP Queue 1, item 13.7 (multi-host fleets)"

    def __init__(
        self,
        problem: Problem,
        *,
        nan_generations: Sequence[int] = (),
        nan_rows: int = 1,
        inf_generations: Sequence[int] = (),
        inf_rows: int = 1,
        corrupt_generations: Sequence[int] = (),
        corrupt_times: int = 1,
        plateau_from: int | None = None,
        plateau_until: int | None = None,
        plateau_floor: float = 1.0,
        error_generations: Sequence[int] = (),
        error_times: int = 1,
        error_message: str = "UNAVAILABLE: injected backend loss (fault schedule)",
        fatal_generations: Sequence[int] = (),
        fatal_times: int = 1,
        delay_generations: Sequence[int] = (),
        delay_seconds: float = 1.0,
        delay_times: int = 1,
        sigterm_generations: Sequence[int] = (),
        sigterm_times: int = 1,
        dead_shards: Mapping[int, Sequence[int]] | None = None,
        straggler_shards: Mapping[int, Sequence[int]] | None = None,
        straggler_delay: float = 1.0,
        straggler_times: int = 1,
        shards: int | None = None,
        eval_deadline: float | None = None,
        deadline_penalty: float = float("nan"),
        kill_process_at: Mapping[int, Sequence[int]] | None = None,
        kill_times: int = 1,
        partition_process_at: Mapping[int, Sequence[int]] | None = None,
        partition_seconds: float = 3600.0,
        partition_times: int = 1,
        slow_process_at: Mapping[int, Sequence[int]] | None = None,
        slow_process_seconds: float = 1.0,
        slow_process_times: int = 1,
        lane_faults: Mapping[int, Mapping[str, Any]] | None = None,
    ):
        for name, value in (
            ("kill_process_at", kill_process_at),
            ("partition_process_at", partition_process_at),
            ("slow_process_at", slow_process_at),
        ):
            if value:
                raise NotImplementedError(
                    f"FaultyProblem({name}=...) is not ported yet: the fleet faults need the multi-host "
                    f"supervisor ({self._FLEET_ITEM})"
                )
        self.problem = problem
        self.nan_generations = tuple(int(g) for g in nan_generations)
        self.nan_rows = int(nan_rows)
        self.inf_generations = tuple(int(g) for g in inf_generations)
        self.inf_rows = int(inf_rows)
        self.corrupt_generations = frozenset(int(g) for g in corrupt_generations)
        self.corrupt_times = int(corrupt_times)
        self.plateau_from = None if plateau_from is None else int(plateau_from)
        self.plateau_until = None if plateau_until is None else int(plateau_until)
        self.plateau_floor = float(plateau_floor)
        self.error_generations = frozenset(int(g) for g in error_generations)
        self.error_times = int(error_times)
        self.error_message = error_message
        self.fatal_generations = frozenset(int(g) for g in fatal_generations)
        self.fatal_times = int(fatal_times)
        self.delay_generations = frozenset(int(g) for g in delay_generations)
        self.delay_seconds = float(delay_seconds)
        self.delay_times = int(delay_times)
        self.sigterm_generations = frozenset(int(g) for g in sigterm_generations)
        self.sigterm_times = int(sigterm_times)
        self.dead_shards = tuple(
            (int(s), tuple(int(g) for g in gens)) for s, gens in sorted((dead_shards or {}).items())
        )
        self.straggler_shards = {int(s): frozenset(int(g) for g in gens) for s, gens in (straggler_shards or {}).items()}
        self.straggler_delay = float(straggler_delay)
        self.straggler_times = int(straggler_times)
        self.shards = None if shards is None else int(shards)
        if self.dead_shards and self._n_shards() is None:
            raise ValueError(
                "dead_shards needs the shard count to map shards to row "
                "blocks: wrap a ShardedProblem (auto-detected) or pass "
                "shards=N explicitly"
            )
        self.eval_deadline = None if eval_deadline is None else float(eval_deadline)
        self.deadline_penalty = float(deadline_penalty)
        # The fleet schedules are refused above; the attributes keep the
        # JAX package's shape for the audit.
        self.kill_process_at: dict[int, frozenset] = {}
        self.kill_times = int(kill_times)
        self.partition_process_at: dict[int, frozenset] = {}
        self.partition_seconds = float(partition_seconds)
        self.partition_times = int(partition_times)
        self.slow_process_at: dict[int, frozenset] = {}
        self.slow_process_seconds = float(slow_process_seconds)
        self.slow_process_times = int(slow_process_times)
        self.lane_faults = self._normalize_lane_faults(lane_faults or {})
        # Host-side count of eval-deadline expiries on this process.
        self.deadline_trips = 0
        # Set by StdWorkflow when this wrapper ends up in a sharded
        # evaluation it cannot see from its own chain.
        self.in_sharded_program = False
        self._lock = threading.Lock()
        self._attempts: dict[tuple[str, int], int] = {}
        self._has_host_faults = bool(
            self.error_generations
            or self.fatal_generations
            or self.delay_generations
            or self.sigterm_generations
            or self.straggler_shards
        )
        # Lane-keyed delays have their own hook: it reads the lane's uid.
        self._has_lane_host_faults = any(spec["delay_generations"] for spec in self.lane_faults.values())
        self._validate_schedules()

    @property
    def capturable(self) -> bool:
        """Whether an evaluation can run inside a captured CUDA graph: not
        with a host fault scheduled (the attempt-counted corruption, the
        eval deadline and a lane delay included), whose hook reads the
        evaluation index on the host."""
        host = (
            self._has_host_faults
            or self._has_lane_host_faults
            or bool(self.corrupt_generations)
            or self.eval_deadline is not None
        )
        return not host and bool(getattr(self.problem, "capturable", True))

    # -- the tenant-keyed plan ------------------------------------------------
    _LANE_FAULT_FIELDS = {
        "nan_generations": (),
        "nan_rows": 1,
        "inf_generations": (),
        "inf_rows": 1,
        "plateau_from": None,
        "plateau_until": None,
        "plateau_floor": 1.0,
        "delay_generations": (),
        "delay_seconds": 1.0,
        "delay_times": 1,
    }

    def _normalize_lane_faults(self, lane_faults: Mapping[int, Mapping[str, Any]]) -> dict[int, dict[str, Any]]:
        out: dict[int, dict[str, Any]] = {}
        for lane, spec in sorted(lane_faults.items()):
            unknown = sorted(set(spec) - set(self._LANE_FAULT_FIELDS))
            if unknown:
                raise ValueError(
                    f"lane_faults[{lane}] has unknown fault field(s) "
                    f"{unknown}; valid per-lane fields are "
                    f"{sorted(self._LANE_FAULT_FIELDS)}"
                )
            full = {k: spec.get(k, default) for k, default in self._LANE_FAULT_FIELDS.items()}
            out[int(lane)] = {
                "nan_generations": tuple(int(g) for g in full["nan_generations"]),
                "nan_rows": int(full["nan_rows"]),
                "inf_generations": tuple(int(g) for g in full["inf_generations"]),
                "inf_rows": int(full["inf_rows"]),
                "plateau_from": None if full["plateau_from"] is None else int(full["plateau_from"]),
                "plateau_until": None if full["plateau_until"] is None else int(full["plateau_until"]),
                "plateau_floor": float(full["plateau_floor"]),
                "delay_generations": frozenset(int(g) for g in full["delay_generations"]),
                "delay_seconds": float(full["delay_seconds"]),
                "delay_times": int(full["delay_times"]),
            }
        return out

    # -- construction-time schedule audit -----------------------------------
    def _validate_schedules(self) -> None:
        """Reject malformed or self-contradictory fault plans loudly, at
        construction — the single audit point for every schedule field the
        wrapper has grown (the full matrix is tabulated in
        ``docs/guide/resilience.md``)."""

        def gens(name: str, values) -> None:
            bad = [g for g in values if g < 0]
            if bad:
                raise ValueError(
                    f"{name} schedules 0-based evaluation indices; got "
                    f"negative index(es) {sorted(bad)}"
                )

        def nonneg(name: str, value) -> None:
            if value < 0:
                raise ValueError(f"{name} must be >= 0, got {value}")

        gens("nan_generations", self.nan_generations)
        gens("inf_generations", self.inf_generations)
        gens("corrupt_generations", self.corrupt_generations)
        gens("error_generations", self.error_generations)
        gens("fatal_generations", self.fatal_generations)
        gens("delay_generations", self.delay_generations)
        gens("sigterm_generations", self.sigterm_generations)
        for name, count in (
            ("nan_rows", self.nan_rows),
            ("inf_rows", self.inf_rows),
            ("corrupt_times", self.corrupt_times),
            ("error_times", self.error_times),
            ("fatal_times", self.fatal_times),
            ("delay_times", self.delay_times),
            ("sigterm_times", self.sigterm_times),
            ("straggler_times", self.straggler_times),
            ("kill_times", self.kill_times),
            ("partition_times", self.partition_times),
            ("slow_process_times", self.slow_process_times),
            ("delay_seconds", self.delay_seconds),
            ("straggler_delay", self.straggler_delay),
            ("partition_seconds", self.partition_seconds),
            ("slow_process_seconds", self.slow_process_seconds),
        ):
            nonneg(name, count)
        for name, frm, until in [
            ("plateau", self.plateau_from, self.plateau_until)
        ] + [
            (f"lane_faults[{lane}] plateau", s["plateau_from"], s["plateau_until"])
            for lane, s in self.lane_faults.items()
        ]:
            if until is not None and frm is None:
                raise ValueError(
                    f"{name}_until without {name}_from: a plateau window "
                    f"needs its start (plateau_from=N)"
                )
            if frm is not None and frm < 0:
                raise ValueError(f"{name}_from must be >= 0, got {frm}")
            if until is not None and frm is not None and until < frm:
                raise ValueError(
                    f"{name}_until ({until}) must be >= {name}_from ({frm}) "
                    f"— the window is [from, until)"
                )
        n_shards = self._n_shards()
        for name, shard_map_ in (
            ("dead_shards", dict(self.dead_shards)),
            ("straggler_shards", self.straggler_shards),
        ):
            for shard, shard_gens in shard_map_.items():
                gens(f"{name}[{shard}]", shard_gens)
                if shard < 0:
                    raise ValueError(
                        f"{name} keys are mesh shard indices; got {shard}"
                    )
                if n_shards is not None and shard >= n_shards:
                    raise ValueError(
                        f"{name} schedules shard {shard}, but the "
                        f"evaluation runs on {n_shards} shard(s) "
                        f"(indices 0..{n_shards - 1}) — a fault that can "
                        f"never fire is a misconfigured test, not chaos"
                    )
        if self.eval_deadline is not None and self.eval_deadline <= 0:
            raise ValueError(
                f"eval_deadline must be > 0 seconds, got {self.eval_deadline}"
            )
        for name, proc_map in (
            ("kill_process_at", self.kill_process_at),
            ("partition_process_at", self.partition_process_at),
            ("slow_process_at", self.slow_process_at),
        ):
            for proc, proc_gens in proc_map.items():
                if proc < 0:
                    raise ValueError(
                        f"{name} keys are process index values; "
                        f"got {proc}"
                    )
                gens(f"{name}[{proc}]", proc_gens)
        # A process SIGKILLed at (proc, eval) cannot also wedge or slow
        # there: the overlap means the plan's author expected two
        # different fates for one host at one moment.
        for proc, kill_gens in self.kill_process_at.items():
            for other_name, other in (
                ("partition_process_at", self.partition_process_at),
                ("slow_process_at", self.slow_process_at),
            ):
                overlap = kill_gens & other.get(proc, frozenset())
                if overlap:
                    raise ValueError(
                        f"conflicting fleet schedules for process {proc}: "
                        f"kill_process_at and {other_name} both fire at "
                        f"evaluation(s) {sorted(overlap)} — a SIGKILLed "
                        f"process cannot also be wedged/slowed"
                    )
        for lane, spec in self.lane_faults.items():
            if lane < 0:
                raise ValueError(
                    f"lane_faults keys are stable lane/tenant ids >= 0 "
                    f"(-1 is the unassigned sentinel); got {lane}"
                )
            gens(f"lane_faults[{lane}].nan_generations", spec["nan_generations"])
            gens(f"lane_faults[{lane}].inf_generations", spec["inf_generations"])
            gens(
                f"lane_faults[{lane}].delay_generations",
                spec["delay_generations"],
            )
            for fname in (
                "nan_rows",
                "inf_rows",
                "delay_times",
                "delay_seconds",
            ):
                nonneg(f"lane_faults[{lane}].{fname}", spec[fname])

    def _mesh_in_chain(self) -> int | None:
        """Shard count of a ShardedProblem on the wrapped chain, if any."""
        from ..parallel import find_sharded

        sharded = find_sharded(self.problem)
        if sharded is None:
            return None
        return int(sharded.mesh.shape[sharded.axis_name])

    def _n_shards(self) -> int | None:
        """Shard count for row-block mapping: explicit ``shards`` wins, else
        the mesh axis size of a ShardedProblem on the wrapped chain."""
        if self.shards is not None:
            return self.shards
        return self._mesh_in_chain()

    # -- pickling ----------------------------------------------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        state.pop("_lane_op", None)
        state["_attempts"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # -- host side ---------------------------------------------------------
    def _bump(self, kind: str, gen: int) -> int:
        with self._lock:
            n = self._attempts.get((kind, gen), 0) + 1
            self._attempts[(kind, gen)] = n
            return n

    def attempts(self, kind: str, gen: int) -> int:
        """How many times the ``kind`` fault at evaluation ``gen`` has been
        reached so far (test observability)."""
        with self._lock:
            return self._attempts.get((kind, gen), 0)

    def reset_faults(self) -> None:
        """Forget all attempt counts (faults re-arm)."""
        with self._lock:
            self._attempts.clear()
            self.deadline_trips = 0

    def _corrupt_flag(self, g: int) -> bool:
        """Host side of the corruption schedule: True while the fault is
        live for this evaluation index (first ``corrupt_times`` attempts)."""
        if g in self.corrupt_generations:
            if self._bump("corrupt", g) <= self.corrupt_times:
                return True
        return False

    def _host_hook(self, g: int) -> None:
        if g in self.fatal_generations:
            if self._bump("fatal", g) <= self.fatal_times:
                raise InjectedFatalError(
                    f"NONRETRYABLE: injected unrecoverable crash at evaluation {g} (simulated process kill)"
                )
        if g in self.error_generations:
            if self._bump("error", g) <= self.error_times:
                raise InjectedBackendError(f"{self.error_message} [eval {g}]")
        if g in self.sigterm_generations:
            if self._bump("sigterm", g) <= self.sigterm_times:
                # A real signal to the real process: exactly what a
                # scheduler's grace-window kill delivers.  The evaluation
                # continues — the PreemptionGuard's flag is checked at the
                # next segment boundary.
                os.kill(os.getpid(), signal.SIGTERM)
        if g in self.delay_generations:
            if self._bump("delay", g) <= self.delay_times:
                time.sleep(self.delay_seconds)
        for shard, gens in self.straggler_shards.items():
            if g in gens:
                if self._bump(f"straggler{shard}", g) <= self.straggler_times:
                    time.sleep(self.straggler_delay)

    def _lane_host_hook(self, gen: torch.Tensor, lane: torch.Tensor) -> None:
        """Host side of the lane-keyed delay faults: sleeps only when THIS
        lane has a scheduled delay, attempt-counted per ``(lane, eval)``.
        Under a vmapped pack it is called once a lane (the host operator's
        batching rule), each call with its own lane's uid: a slow tenant
        stalls the pack's step, and no value changes."""
        g, l = int(gen), int(lane)
        spec = self.lane_faults.get(l)
        if spec is None or g not in spec["delay_generations"]:
            return
        if self._bump(f"lane_delay{l}", g) <= spec["delay_times"]:
            time.sleep(spec["delay_seconds"])

    def _deadline_guarded(self, fn) -> bool:
        """Run ``fn()`` in an abandoned-on-timeout daemon worker; returns
        whether the eval deadline tripped.  A worker that finishes in time
        re-raises its exception; one that does not is left to die with its
        sleep.  Every trip is counted in ``deadline_trips``."""
        result: dict = {}

        def target() -> None:
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - re-raised below
                result["error"] = e

        worker = threading.Thread(target=target, name="evox-tpu-torch-eval-deadline", daemon=True)
        worker.start()
        worker.join(self.eval_deadline)
        if worker.is_alive():
            with self._lock:
                self.deadline_trips += 1
            return True
        if "error" in result:
            raise result["error"]
        return False

    # -- component protocol ------------------------------------------------
    def setup(self, key: torch.Tensor) -> State:
        inner = self.problem.setup(key)
        device = key.device

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=device)

        return State(
            inner=inner,
            # 0-based evaluation index; lives in the state so it is
            # checkpointed and rolls back with the run on resume.
            fault_generation=scalar(0, torch.int32),
            # In-state corruption canary: NaN during scheduled evaluations
            # (``corrupt_generations``), 0.0 otherwise; always present so
            # faulted runs and their comparators share one structure.
            corruption=scalar(0.0, torch.float32),
            # Stable lane/tenant identity of ``lane_faults``: the service
            # stamps the tenant's uid here at admission; the -1 sentinel
            # matches no schedule.
            fault_lane=scalar(-1, torch.int32),
        )

    @staticmethod
    def _scheduled(gen: torch.Tensor, schedule) -> torch.Tensor:
        """Whether the evaluation index ``gen`` (a 0-dim tensor) is one of
        ``schedule``: comparisons with Python ints, so nothing is copied to
        the card (a captured graph refuses a copy from pageable memory)."""
        hit = gen == int(schedule[0])
        for g in schedule[1:]:
            hit = hit | (gen == int(g))
        return hit

    @classmethod
    def _inject_rows(
        cls, fit: torch.Tensor, gen: torch.Tensor, schedule: tuple, rows: int, value: float, extra=None
    ) -> torch.Tensor:
        scheduled = cls._scheduled(gen, schedule)
        if extra is not None:
            scheduled = scheduled & extra
        row_mask = torch.arange(fit.shape[0], device=fit.device) < rows
        mask = row_mask if fit.ndim == 1 else row_mask[:, None]
        return torch.where(scheduled & mask, torch.full((), value, dtype=fit.dtype, device=fit.device), fit)

    def evaluate(self, state: State, pop: torch.Tensor) -> tuple[torch.Tensor, State]:
        gen = state.fault_generation
        # Host faults read the evaluation index on the host; this wrapper
        # is then not capturable, and the evaluation runs eagerly.
        host_index = None
        if self._has_host_faults or self.corrupt_generations:
            host_index = int(gen)
        timed_out = False
        if self._has_host_faults:
            if self.eval_deadline is None:
                self._host_hook(host_index)
            else:
                # Deadline-guarded: a timeout instead of stalling forever;
                # the fitness falls back to the penalty below.
                timed_out = self._deadline_guarded(lambda: self._host_hook(host_index))
        if self._has_lane_host_faults:
            # One call a lane under a pack's vmap, each with its own uid.
            lane_op = self.__dict__.get("_lane_op")
            if lane_op is None:
                lane_op = self._lane_op = host_op(self._lane_host_hook)
            lane_op(gen, state.fault_lane)
        fit, inner = self.problem.evaluate(state.inner, pop)
        if self.nan_generations:
            fit = self._inject_rows(fit, gen, self.nan_generations, self.nan_rows, float("nan"))
        if self.inf_generations:
            fit = self._inject_rows(fit, gen, self.inf_generations, self.inf_rows, float("inf"))
        # Tenant-keyed lane faults: every schedule is masked on the state's
        # lane identity, so one program serves the whole pack and only the
        # scheduled tenant's rows are touched.
        for uid, spec in self.lane_faults.items():
            is_lane = state.fault_lane == uid
            if spec["nan_generations"]:
                fit = self._inject_rows(
                    fit, gen, spec["nan_generations"], spec["nan_rows"], float("nan"), extra=is_lane
                )
            if spec["inf_generations"]:
                fit = self._inject_rows(
                    fit, gen, spec["inf_generations"], spec["inf_rows"], float("inf"), extra=is_lane
                )
            if spec["plateau_from"] is not None:
                in_plateau = (gen >= spec["plateau_from"]) & is_lane
                if spec["plateau_until"] is not None:
                    in_plateau = in_plateau & (gen < spec["plateau_until"])
                floor = torch.full((), spec["plateau_floor"], dtype=fit.dtype, device=fit.device)
                fit = torch.where(in_plateau, torch.maximum(fit, floor), fit)
        if self.dead_shards:
            # Mesh-position-keyed NaN rows: the scheduled shard's whole
            # contiguous row block dies (the parallel layer's row map).
            from ..parallel import shard_row_ids

            row_shard = shard_row_ids(fit.shape[0], self._n_shards(), fit.device)
            nan = torch.full((), float("nan"), dtype=fit.dtype, device=fit.device)
            for shard, gens in self.dead_shards:
                scheduled = self._scheduled(gen, gens)
                mask = scheduled & (row_shard == shard)
                mask = mask if fit.ndim == 1 else mask[:, None]
                fit = torch.where(mask, nan, fit)
        if timed_out:
            # Deadline fallback: the whole evaluation is abandoned — every
            # row takes the penalty (NaN by default, so the workflow's
            # quarantine penalizes and counts it).
            fit = torch.full_like(fit, self.deadline_penalty)
        if self.plateau_from is not None:
            in_plateau = gen >= self.plateau_from
            if self.plateau_until is not None:
                in_plateau = in_plateau & (gen < self.plateau_until)
            # Clamp from below: nothing can beat the floor while the
            # plateau lasts, so the best fitness flatlines.
            floor = torch.full((), self.plateau_floor, dtype=fit.dtype, device=fit.device)
            fit = torch.where(in_plateau, torch.maximum(fit, floor), fit)
        if self.corrupt_generations and self._corrupt_flag(host_index):
            corruption = torch.full_like(state.corruption, float("nan"))
        else:
            corruption = torch.zeros_like(state.corruption)
        return fit, state.replace(inner=inner, fault_generation=gen + 1, corruption=corruption)


class FaultyStore(CheckpointStore):
    """Deterministic storage chaos for the checkpoint pipeline.

    Wraps the :class:`~evox_tpu_torch.utils.CheckpointStore` seam every
    ``save_state`` call flows through and injects faults by **save index**
    (0-based count of saves routed through this store instance), the same
    way :class:`FaultyProblem` schedules eval faults:

    * ``crash_saves`` — raise :class:`InjectedStorageError` *between* the
      completed temp write and the atomic rename: the classic
      kill-mid-checkpoint.  The destination is untouched (old checkpoint
      intact) and the temp file is cleaned up by ``save_state``.
    * ``torn_saves`` — publish a **truncated** final file (first
      ``torn_fraction`` of the bytes) *silently*: the signature of a
      non-atomic writer, or of a disk that acknowledged writes it lost to
      power failure.  Only ``verify_checkpoint`` / digest checks catch it.
    * ``flip_saves`` — publish normally, then flip a single bit in the
      final file (offset ``flip_offset``, default mid-file): bit rot that
      ``np.load`` reads back without complaint — the case SHA-256 leaf
      digests exist for.
    * ``enospc_saves`` / ``eio_saves`` — the archive write raises
      ``OSError`` with ``ENOSPC`` ("no space left on device") / ``EIO``;
      the checkpoint GC contract (never delete the predecessor before the
      successor is durably published) is tested with exactly this.
    * ``slow_saves`` — the archive write sleeps ``slow_seconds`` first
      (a congested or throttled disk), for async-writer overlap tests.

    Save indices count *attempts*: a save that faults still consumes its
    index, so "the next retry succeeds" schedules naturally.  ``saves``
    and ``unlinks`` expose what happened for test assertions; ``events``
    records one ``(index, kind)`` tuple per fired fault.
    """

    def __init__(
        self,
        *,
        crash_saves: Sequence[int] = (),
        torn_saves: Sequence[int] = (),
        torn_fraction: float = 0.5,
        flip_saves: Sequence[int] = (),
        flip_offset: int | None = None,
        enospc_saves: Sequence[int] = (),
        eio_saves: Sequence[int] = (),
        slow_saves: Sequence[int] = (),
        slow_seconds: float = 1.0,
    ):
        # Construction-time audit, the FaultyProblem discipline: negative
        # save indices and one save scheduled for two incompatible fates
        # (an aborted write — crash/ENOSPC/EIO — never publishes, so it
        # cannot also tear or bit-flip the published file) fail loudly
        # here, never lazily mid-run.
        schedules = validate_schedule(
            "FaultyStore",
            indices={
                "crash_saves": crash_saves,
                "torn_saves": torn_saves,
                "flip_saves": flip_saves,
                "enospc_saves": enospc_saves,
                "eio_saves": eio_saves,
                "slow_saves": slow_saves,
            },
            nonneg={
                "torn_fraction": float(torn_fraction),
                "slow_seconds": float(slow_seconds),
            },
            exclusive=[
                ("crash_saves", "enospc_saves"),
                ("crash_saves", "eio_saves"),
                ("enospc_saves", "eio_saves"),
                ("crash_saves", "torn_saves"),
                ("crash_saves", "flip_saves"),
                ("enospc_saves", "torn_saves"),
                ("enospc_saves", "flip_saves"),
                ("eio_saves", "torn_saves"),
                ("eio_saves", "flip_saves"),
            ],
        )
        self.crash_saves = schedules["crash_saves"]
        self.torn_saves = schedules["torn_saves"]
        self.torn_fraction = float(torn_fraction)
        self.flip_saves = schedules["flip_saves"]
        self.flip_offset = None if flip_offset is None else int(flip_offset)
        self.enospc_saves = schedules["enospc_saves"]
        self.eio_saves = schedules["eio_saves"]
        self.slow_saves = schedules["slow_saves"]
        self.slow_seconds = float(slow_seconds)
        self._lock = threading.Lock()
        self.saves = 0  # completed open_temp calls == save attempts
        self.unlinks: list[str] = []  # every file the caller deleted via us
        self.renames: list[tuple[str, str]] = []  # quarantine moves via us
        self.events: list[tuple[int, str]] = []
        self._current = -1  # save index of the attempt in progress

    def _fire(self, kind: str) -> None:
        with self._lock:
            self.events.append((self._current, kind))

    # -- the seam ----------------------------------------------------------
    def open_temp(self, directory, prefix):
        with self._lock:
            self._current = self.saves
            self.saves += 1
        return super().open_temp(directory, prefix)

    def write_archive(self, f, arrays):
        if self._current in self.slow_saves:
            self._fire("slow")
            time.sleep(self.slow_seconds)
        if self._current in self.enospc_saves:
            self._fire("enospc")
            raise OSError(
                errno.ENOSPC, "No space left on device (injected)"
            )
        if self._current in self.eio_saves:
            self._fire("eio")
            raise OSError(errno.EIO, "Input/output error (injected)")
        super().write_archive(f, arrays)

    def publish(self, tmp, final):
        if self._current in self.crash_saves:
            self._fire("crash")
            raise InjectedStorageError(
                f"injected crash between temp write and publish of {final} "
                f"(save #{self._current})"
            )
        if self._current in self.torn_saves:
            self._fire("torn")
            # Truncate the temp in place, then publish it: the final file
            # exists, opens, and is short — a lying-disk torn write.
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as tf:
                tf.truncate(max(1, int(size * self.torn_fraction)))
        super().publish(tmp, final)
        if self._current in self.flip_saves:
            self._fire("flip")
            size = os.path.getsize(final)
            offset = (
                self.flip_offset if self.flip_offset is not None else size // 2
            )
            with open(final, "r+b") as ff:
                ff.seek(offset)
                byte = ff.read(1)
                ff.seek(offset)
                ff.write(bytes([byte[0] ^ 0x01]))

    def write_bytes(self, f, data):
        # Raw-payload writes share the archive
        # write's fault surface: the save index was assigned by the
        # open_temp that staged this temp file.
        if self._current in self.slow_saves:
            self._fire("slow")
            time.sleep(self.slow_seconds)
        if self._current in self.enospc_saves:
            self._fire("enospc")
            raise OSError(
                errno.ENOSPC, "No space left on device (injected)"
            )
        if self._current in self.eio_saves:
            self._fire("eio")
            raise OSError(errno.EIO, "Input/output error (injected)")
        super().write_bytes(f, data)

    def append_record(self, f, data):
        # Journal appends have no open_temp: each append consumes its own
        # save index, so "the third journal record is torn" schedules the
        # same way "the third checkpoint is torn" does.
        with self._lock:
            self._current = self.saves
            self.saves += 1
        if self._current in self.slow_saves:
            self._fire("slow")
            time.sleep(self.slow_seconds)
        if self._current in self.enospc_saves:
            self._fire("enospc")
            # Model a disk that accepted part of the record before filling
            # up: the torn prefix lands, then the OSError — exactly the
            # tail the replay's checksum discipline must skip.
            f.write(data[: max(1, len(data) // 3)])
            raise OSError(
                errno.ENOSPC, "No space left on device (injected)"
            )
        if self._current in self.eio_saves:
            self._fire("eio")
            raise OSError(errno.EIO, "Input/output error (injected)")
        if self._current in self.torn_saves:
            self._fire("torn")
            torn = data[: max(1, int(len(data) * self.torn_fraction))]
            f.write(torn)
            return len(torn)
        if self._current in self.flip_saves:
            self._fire("flip")
            offset = (
                self.flip_offset
                if self.flip_offset is not None
                else len(data) // 2
            ) % max(1, len(data))
            data = (
                data[:offset]
                + bytes([data[offset] ^ 0x01])
                + data[offset + 1 :]
            )
        return super().append_record(f, data)

    def unlink(self, path):
        self.unlinks.append(str(path))
        super().unlink(path)

    def rename(self, src, dst):
        self.renames.append((str(src), str(dst)))
        super().rename(src, dst)
