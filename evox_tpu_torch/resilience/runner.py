"""Checkpointed, retrying run supervisor for long workflow executions
(counterpart of ``evox_tpu/resilience/runner.py``).

:class:`ResilientRunner` executes a run as **fused segments**: on the card
each segment of ``checkpoint_every`` generations is one replay of a
captured CUDA graph (:meth:`StdWorkflow._run_segment
<evox_tpu_torch.workflows.StdWorkflow.run_segment>`) whose generations
carry every per-generation resilience feature (non-finite quarantine,
monitor counters, the monitor's history captured as telemetry, the
optional unhealthy-state early stop, the flight recorder's signals).
Between segments the supervisor — plain Python on the host — flushes the
telemetry, probes health, checkpoints atomically, enforces a watchdog
deadline and retries with exponential backoff.  ``fused=False`` steps
every generation eagerly (the debug path).

**The host touches the card once a segment.**  The one wait is a single
copy to the host of the segment's scalars (the generations executed, the
early-stop flag, the monitor's counters and, with a flight recorder, the
flight signals); the telemetry flush, the metrics and the flight recorder
read that copy.  Checkpoints go through
:class:`~evox_tpu_torch.utils.AsyncCheckpointWriter`, which copies the
state into pinned host buffers after an event of the submitting stream.

**"Compile" is the first capture.**  The JAX package AOT-compiles each
segment program before the watchdog starts.  Here that step is the
capture of the segment's CUDA graph (one warm-up generation on a clone,
then the capture), made before the segment runs: ``compile_timeout``
guards it, the ``aot-compile`` span and ``SegmentTiming.compile_seconds``
record it, and the execution deadline never pays for it.  A capture is
made once per chunk length and state structure; a restart that changes
the state's shapes (a population regrow) captures anew, and the
workflow's earlier captures are dropped with their memory.  Any write of
the async checkpoint writer is waited out before a capture.

**The watchdog** runs an attempt in a daemon worker thread that waits on
a CUDA event by polling it (``event.query()``), never on a device-wide
synchronize, and abandons the worker past the deadline.  An abandoned
attempt still owns its graph's static buffers: before the next attempt
the runner waits for the abandoned worker and its event (at most the
watchdog deadline; past it the wait is one more retryable timeout), so a
retry never writes those buffers or replays that graph while the card is
still running the old replay.

**Host faults** (a problem whose evaluation calls the host:
``problem.capturable`` is False, e.g. a
:class:`~evox_tpu_torch.resilience.FaultyProblem` with host faults
scheduled) run the segment's generations eagerly on the card — the
workflow's per-generation route.  Nothing moves to the CPU unless the
caller asked for the CPU fallback.

**Retry predicate.**  :func:`default_retryable` keeps the JAX package's
contract (a :class:`WatchdogTimeout` always retries, the ``NONRETRYABLE``
marker never does, backend-loss words such as ``UNAVAILABLE`` do) and
adds one rule: a sticky CUDA error (an illegal memory access, an
unspecified launch failure, a device-side assert, a cuBLAS internal
error, ...) poisons the CUDA context for the rest of the process, so it
is never retried in the process — it raises.

The checkpoint layout under ``checkpoint_dir`` is the JAX package's::

    ckpt_00000010.npz          # state after 10 completed generations
    ckpt_00000020.npz          # manifest records generation, versions
    ckpt_00000030.npz.corrupt  # quarantined: failed digest verification

Resume scans newest-first (:func:`scan_checkpoints`): files whose bytes
are damaged are **quarantined** (renamed ``*.corrupt``, never deleted) and
recorded as :class:`CheckpointSkip`; the first remaining candidate that
validates against the template state wins.  ``SIGTERM``/``SIGINT`` is
handled cooperatively via
:class:`~evox_tpu_torch.resilience.PreemptionGuard`.

**The control plane** (``controller=``, a
:class:`~evox_tpu_torch.control.Controller`) consults at boundaries, on the
host: a trend verdict from the flight window may fire the restart policy
before the threshold probe would, and self-tuning cadence picks the next
segment's length from ``stats.segment_timings``.  A segment's capture is
booked as its ``compile_seconds``, as the JAX package books its compile, so
the cadence sees the same evidence for the same timings.  Cadence lengths
are powers of two up to ``checkpoint_every``, plus ``checkpoint_every``
itself before the first decision and a run's ragged tail: with cadence
armed the workflow's graph cache is sized to keep every one of them
(``StdWorkflow.reserve_graphs``), so a length is captured once and a
changed cadence never recaptures.  A controller that fires no decision
leaves the run bit-identical to ``controller=None``.

**Fleets** (``primary=``, ``heartbeat=``): in a multi-process fleet every
rank steps the same replicated state, and only the primary (rank 0,
:func:`~evox_tpu_torch.parallel.is_primary`) mutates the checkpoint
directory — it alone runs the async writer, publishes, collects old
checkpoints, quarantines, invalidates after a restart and clears a fresh
directory; the other ranks read through a
:class:`~evox_tpu_torch.utils.ReadOnlyCheckpointStore`.  Restarts meet at
a :func:`~evox_tpu_torch.parallel.fleet_barrier` (a ``fleet-barrier``
span), and each boundary publishes a heartbeat beat (completed generation,
segment seconds) for the :class:`~evox_tpu_torch.resilience.FleetSupervisor`.
A gloo fleet's evaluation calls the host, so its segments step eagerly
(``ShardedProblem.capturable`` is false).

**The persistent program cache** (``exec_cache=``, an
:class:`~evox_tpu_torch.utils.ExecutableCache`): a captured graph cannot be
serialized, so each fused segment program's *capture record* is persisted
instead — the kernel libraries the capture needed, so a restarted process
runs no ``nvcc``.  Labels are salted with the workflow's static signature,
as the JAX package's, so two workflows of one shape never share an entry;
a load is counted by ``evox_runner_exec_cache_loads_total``.  The capture
itself still runs once a program.
**The CPU fallback** (``cpu_fallback=True``): a segment that still fails
after its retries runs again on the CPU with a fresh retry budget, and so
does every later segment of the run, as in the JAX package (one fallback
a run, counted in ``stats.cpu_fallbacks`` and
``evox_runner_cpu_fallbacks_total``, and warned).  JAX moves the state
with ``jax.device_put`` and lowers the programs for the CPU; the port's
components are bound to their device when they are built, so the runner
runs the rest of the run on a *CPU twin* of the workflow
(:func:`~evox_tpu_torch.utils.relocate.relocate`): the same configuration
with every tensor and ``device`` of its components on the CPU and no
captured graph, sharing the host-side state of the original (the
monitor and its history, a fault injector's attempt counts).  The
segment's input checkpoint is reloaded into a CPU template, the kernels'
wrappers take their plain versions on the CPU tensors, and the state
``run`` returns is on the CPU.  The next ``run()`` starts on the card
workflow again.  A sharded evaluation on the card cannot join a CPU twin
(its process group and the other ranks stay on the card): ``run()``
refuses ``cpu_fallback=True`` with it by name.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, NamedTuple, Union

import numpy as np
import torch

from ..core import State, Workflow
from ..obs.plane import Observability, resolve_obs
from ..utils.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    CheckpointError,
    CheckpointStore,
    ReadOnlyCheckpointStore,
    load_state,
    read_manifest,
    save_state,
    verify_checkpoint,
)
from ..utils.checkpoint import quarantine_target as _quarantine_target
from ..utils import graph
from ..utils.relocate import relocate
from .elastic import (
    _num_processes,
    check_topology,
    remesh_state,
    topology_differs,
    workflow_mesh,
    workflow_topology,
)
from .health import HealthProbe, HealthReport
from .preemption import Preempted, PreemptionGuard
from .restart import RestartContext, RestartEvent, RestartPolicy

__all__ = [
    "ResilientRunner",
    "RetryPolicy",
    "RunStats",
    "SegmentTiming",
    "CheckpointSkip",
    "ResilienceError",
    "WatchdogTimeout",
    "default_retryable",
    "latest_checkpoint",
    "scan_checkpoints",
]

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")

# The monitor's in-state counters the runner publishes at boundaries.
_MONITOR_COUNTERS = ("num_nonfinite", "num_shard_quarantines", "num_restarts", "num_preemptions")

# Seconds between two polls of a CUDA event by a watchdog worker.
_POLL_SECONDS = 5e-5


class WatchdogTimeout(RuntimeError):
    """A segment exceeded the runner's watchdog deadline (the silent-hang
    signature: work that neither finishes nor fails)."""


class ResilienceError(RuntimeError):
    """A segment kept failing after the full retry budget (and CPU fallback,
    if enabled) was exhausted.  ``__cause__`` carries the last failure."""


# Substrings of error messages that indicate the *backend* — not the
# program — failed, so that a retry against a recovered backend can
# succeed (the JAX package's list).
RETRYABLE_SIGNATURES = (
    "UNAVAILABLE",
    "INTERNAL",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "DATA_LOSS",
    "Connection refused",
    "Connection reset",
    "Socket closed",
    "failed to connect",
)

# Marker an error message can carry to opt out of retries even when it
# matches a retryable signature (fault injection's simulated fatal crash).
NONRETRYABLE_MARKER = "NONRETRYABLE"

# CUDA errors that leave the process's CUDA context unusable ("sticky"):
# every later CUDA call of the process fails, so retrying in the process
# only burns the budget.  The fleet supervisor's process restart is their
# answer (resilience/fleet.py).  ``CUBLAS_STATUS_INTERNAL_ERROR`` would otherwise
# match the ``INTERNAL`` signature.
STICKY_CUDA_SIGNATURES = (
    "an illegal memory access was encountered",
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "an illegal instruction was encountered",
    "misaligned address",
    "invalid program counter",
    "hardware stack error",
    "uncorrectable ECC error",
    "the launch timed out and was terminated",
    "CUBLAS_STATUS_INTERNAL_ERROR",
    "CUBLAS_STATUS_EXECUTION_FAILED",
    "CUDA_ERROR_ILLEGAL_ADDRESS",
    "cudaErrorIllegalAddress",
    "cudaErrorLaunchFailure",
    "cudaErrorAssert",
)


def default_retryable(exc: BaseException) -> bool:
    """Is this failure worth retrying in this process?

    * :class:`WatchdogTimeout` — always (it is the hang signature).
    * Errors whose message carries ``NONRETRYABLE`` — never.
    * Sticky CUDA errors (:data:`STICKY_CUDA_SIGNATURES`) — never: the
      process's CUDA context is lost.
    * ``RuntimeError`` whose message matches a backend-loss signature
      (``UNAVAILABLE``, ``INTERNAL``, ...) — yes.
    * Everything else (shape errors, user exceptions, ...) — no: retrying a
      deterministic program bug burns the budget without hope.
    """
    if isinstance(exc, WatchdogTimeout):
        return True
    msg = str(exc)
    if NONRETRYABLE_MARKER in msg:
        return False
    if any(sig in msg for sig in STICKY_CUDA_SIGNATURES):
        return False
    if isinstance(exc, RuntimeError):
        return any(sig in msg for sig in RETRYABLE_SIGNATURES)
    return False


@dataclass
class RetryPolicy:
    """Exponential-backoff retry budget for one segment.

    ``max_retries`` counts *retries* (the first attempt is free); the delay
    before retry ``k`` (1-based) is ``backoff_base * backoff_factor**(k-1)``
    capped at ``backoff_max`` seconds.
    """

    max_retries: int = 3
    backoff_base: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 300.0
    retryable: Callable[[BaseException], bool] = default_retryable

    def delay(self, retry_index: int) -> float:
        """Backoff delay before 1-based retry ``retry_index``."""
        return min(self.backoff_base * self.backoff_factor ** (retry_index - 1), self.backoff_max)


@dataclass
class CheckpointSkip:
    """Structured record of one resume candidate the scan rejected.

    ``quarantined=True`` means the file's bytes were damaged and it was
    renamed ``*.corrupt``; ``quarantined=False`` means a well-formed
    checkpoint failed validation against this run's template and was left
    in place."""

    path: str
    reason: str
    quarantined: bool = False


class SegmentTiming(NamedTuple):
    """Where one segment's wall clock went, measured at the boundary.

    ``compile_seconds`` is the capture of the segment's CUDA graph paid for
    this segment (0.0 once captured, and on the CPU); ``execute_seconds``
    is dispatch + the wait for the segment's scalars;
    ``checkpoint_block_seconds`` is how long the loop was blocked
    publishing this boundary's checkpoint (submit + predecessor barrier
    under the async writer).  On a retried segment the numbers are the
    *successful* attempt's."""

    generation: int
    compile_seconds: float
    execute_seconds: float
    checkpoint_block_seconds: float


@dataclass
class RunStats:
    """Observable record of what the supervisor did during :meth:`run` (the
    JAX package's fields).  ``cpu_fallbacks`` counts the runs that fell back
    to the CPU (at most one a run)."""

    resumed_from_generation: int | None = None
    completed_generations: int = 0
    segments_run: int = 0
    retries: int = 0
    watchdog_timeouts: int = 0
    cpu_fallbacks: int = 0
    checkpoints_written: int = 0
    failures: list[str] = field(default_factory=list)
    health_checks: int = 0
    unhealthy_probes: int = 0
    restarts: list[RestartEvent] = field(default_factory=list)
    last_report: HealthReport | None = None
    preempted: bool = False
    preemption_reason: str | None = None
    resumed_after_preemption: bool = False
    checkpoint_skips: list[CheckpointSkip] = field(default_factory=list)
    checkpoint_write_failures: int = 0
    checkpoint_block_seconds: float = 0.0
    chunk_sizes: list[int] = field(default_factory=list)
    early_stops: int = 0
    segment_timings: list[SegmentTiming] = field(default_factory=list)


def _numbered_checkpoints(checkpoint_dir: Union[str, Path]) -> list[tuple[int, Path]]:
    """All ``ckpt_<generation>.npz`` files in the directory, sorted by
    generation ascending.  Stray non-numbered files are ignored."""
    out = []
    for path in Path(checkpoint_dir).glob("ckpt_*.npz"):
        m = _CKPT_RE.search(path.name)
        if m:
            out.append((int(m.group(1)), path))
    return sorted(out)


def scan_checkpoints(
    checkpoint_dir: Union[str, Path],
    *,
    verify: Union[bool, str] = False,
    quarantine: bool = False,
    store: CheckpointStore | None = None,
) -> tuple[list[tuple[int, Path]], list[tuple[Path, str, bool]]]:
    """Enumerate a checkpoint directory into ``(valid, rejected)`` (the JAX
    package's decisions; archives of either package are read).

    ``valid`` is ``[(generation, path)]`` ascending.  ``rejected`` is
    ``[(path, reason, quarantined)]`` for every numbered file excluded:
    byte-damaged archives (:class:`~evox_tpu_torch.utils.CheckpointCorruptError`
    from :func:`~evox_tpu_torch.utils.verify_checkpoint`) and, with
    ``verify``, archives without a usable manifest.  With
    ``quarantine=True``, *corrupt* files are renamed ``<name>.corrupt``
    (``.corrupt.N`` when earlier evidence holds the name) through
    ``store``; the reject's ``quarantined`` flag reports whether the rename
    happened.  ``verify=False`` trusts the directory listing;
    ``True``/``"full"`` digests every candidate; ``"manifest"`` checks each
    manifest's digest and entry list only.
    """
    if verify not in (False, True, "full", "manifest"):
        raise ValueError(f"verify must be False, True, 'full', or 'manifest', got {verify!r}")
    store = store if store is not None else CheckpointStore()
    valid: list[tuple[int, Path]] = []
    rejected: list[tuple[Path, str, bool]] = []
    for gen, path in _numbered_checkpoints(checkpoint_dir):
        if verify:
            try:
                if verify == "manifest":
                    verify_checkpoint(path, leaves=False)
                else:
                    verify_checkpoint(path)
            except FileNotFoundError:
                rejected.append((path, "vanished during scan (concurrent cleaner)", False))
                continue
            except CheckpointCorruptError as e:
                renamed = False
                if quarantine:
                    try:
                        store.rename(path, _quarantine_target(path))
                        renamed = True
                    except OSError:  # racing cleaners / read-only store
                        pass
                rejected.append((path, str(e), renamed))
                continue
            except CheckpointError as e:
                rejected.append((path, str(e), False))
                continue
        valid.append((gen, path))
    return valid, rejected


def latest_checkpoint(checkpoint_dir: Union[str, Path], *, verify: bool = False) -> Path | None:
    """Newest checkpoint file (by generation number) in ``checkpoint_dir``,
    or ``None``.  By default a pure directory-listing lookup (validity is
    NOT checked); ``verify=True`` skips archives that fail digest
    verification (nothing is renamed)."""
    valid, _ = scan_checkpoints(checkpoint_dir, verify=verify)
    return valid[-1][1] if valid else None


def _state_device(state: Any) -> torch.device:
    leaves, _ = graph.flatten(state)
    return leaves[0].device if leaves else torch.device("cpu")


class ResilientRunner:
    """Supervises a workflow run: fused segments + atomic checkpoints +
    auto-resume + retry/backoff + watchdog + health probes and restarts +
    preemption.

    Usage::

        wf = StdWorkflow(PSO(10_000, lb, ub), Ackley(), monitor=EvalMonitor())
        runner = ResilientRunner(wf, "ckpts/run1", checkpoint_every=50)
        state = runner.run(wf.init(0), n_steps=5_000)
        # ... process dies at generation 3_217; rerun the same two lines:
        # the runner resumes from ckpt_00003200.npz instead of restarting.

    Determinism: a resumed (or retried) run is bit-identical to an
    uninterrupted run of the same configuration — keys live in the
    checkpointed state, and resume always lands on a segment boundary.  A
    fused segment computes the same bits as the same number of eager
    steps, so the runner's final state also equals ``workflow.run(state,
    n_steps)`` bit for bit.

    The parameters are the JAX package's; see the module docstring for
    what changes on the card and what is refused.
    """

    def __init__(
        self,
        workflow: Workflow,
        checkpoint_dir: Union[str, Path],
        *,
        checkpoint_every: int = 10,
        retry: RetryPolicy | None = None,
        watchdog_timeout: float | None = None,
        compile_timeout: float | None = None,
        cpu_fallback: bool = False,
        keep_checkpoints: int = 3,
        on_event: Callable[[str], None] | None = None,
        health: HealthProbe | None = None,
        restart: RestartPolicy | None = None,
        max_restarts: int = 5,
        remesh: bool = True,
        async_checkpoints: bool = True,
        checkpoint_wall_interval: float | None = None,
        preemption: Union[PreemptionGuard, bool, None] = None,
        store: CheckpointStore | None = None,
        exec_cache: Any | None = None,
        verify_resume: Union[bool, str] = True,
        fused: bool = True,
        fused_early_stop: bool = False,
        primary: bool | None = None,
        heartbeat: Any | None = None,
        obs: Union[Observability, bool, None] = None,
        controller: Any | None = None,
    ):
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if keep_checkpoints < 0:
            raise ValueError(f"keep_checkpoints must be >= 0, got {keep_checkpoints}")
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if restart is not None and health is None:
            raise ValueError(
                "a restart policy needs a health probe to trigger it; pass "
                "health=HealthProbe(...) alongside restart="
                f"{type(restart).__name__}(...)"
            )
        self.workflow = workflow
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_every = int(checkpoint_every)
        self.retry = retry if retry is not None else RetryPolicy()
        self.watchdog_timeout = watchdog_timeout
        self.compile_timeout = compile_timeout
        self.cpu_fallback = cpu_fallback
        self.keep_checkpoints = int(keep_checkpoints)
        self.on_event = on_event
        if checkpoint_wall_interval is not None and checkpoint_wall_interval <= 0:
            raise ValueError(f"checkpoint_wall_interval must be > 0 seconds, got {checkpoint_wall_interval}")
        self.health = health
        self.restart = restart
        self.max_restarts = int(max_restarts)
        self.remesh = bool(remesh)
        if primary is None:
            from ..parallel.multihost import is_primary

            primary = is_primary()
        self.primary = bool(primary)
        # A non-primary process mutates nothing: even a path that slips
        # past the primary gating below is refused at the store.
        self.store = (store if store is not None else CheckpointStore()) if self.primary else ReadOnlyCheckpointStore()
        self.heartbeat = heartbeat
        self.obs = resolve_obs(obs, run_id=Path(checkpoint_dir).name)
        # The closed-loop control plane: trend verdicts from the flight
        # window and self-tuned cadence from measured timings, publishing
        # its decisions through this runner's obs plane.
        self.controller = controller
        if controller is not None:
            controller.bind(self.obs)
        self._controller_chunk = self.checkpoint_every
        # Counters are monotone and (by default) process-shared: publish
        # per-run stats as deltas against this cursor, reset with stats.
        self._metric_cursor: dict[str, float] = {}
        if verify_resume not in (False, True, "full", "manifest"):
            raise ValueError(f"verify_resume must be False, True, 'full', or 'manifest', got {verify_resume!r}")
        self.verify_resume = verify_resume
        self.checkpoint_wall_interval = checkpoint_wall_interval
        # ``preemption=True`` builds a guard the runner OWNS: each run()
        # resets it.  A caller-provided guard belongs to the caller.
        self._owns_guard = preemption is True
        self.preemption: PreemptionGuard | None = PreemptionGuard() if preemption is True else (preemption or None)
        self._writer: AsyncCheckpointWriter | None = (
            AsyncCheckpointWriter(
                store=self.store,
                durable=True,
                on_error=self._note_write_failure,
                registry=self.obs.registry if self.obs is not None else None,
            )
            if async_checkpoints and self.primary
            else None
        )
        self.exec_cache = exec_cache or None
        # Programs looked up in the cache by this runner: (label,
        # signature) -> whether the record came from the cache.
        self._cached_programs: dict[tuple, bool] = {}
        # The workflow's static-configuration digest salting the labels
        # (recomputed after a restart swaps the algorithm).
        self._exec_cache_identity: str | None = None
        self.fused = bool(fused) and hasattr(workflow, "_run_segment")
        self.fused_early_stop = bool(fused_early_stop)
        self._segment_cfg = None
        self._adaptive_chunk = 1
        self._per_gen_ema: float | None = None
        self._last_exec_seconds = 0.0
        self._last_compile_seconds = 0.0
        # An attempt the watchdog abandoned: (worker thread, its event
        # holder), waited out before the next attempt.
        self._abandoned: tuple[threading.Thread, dict] | None = None
        # The key impl of the run's state (read once a run: a key's stream
        # family never changes).
        self._key_impl: str | None = None
        self.stats = RunStats()
        self._forced_cpu = False
        # The workflow a CPU fallback swapped out for its CPU twin; put
        # back when the next run() starts.
        self._card_workflow: Workflow | None = None
        # Restart policies may swap ``workflow.algorithm``; every run()
        # starts from the base configuration.
        self._base_algorithm = getattr(workflow, "algorithm", None)
        self._resumed_probed = False

    def _rebind_workflow(self) -> None:
        """Drop the workflow's captured segments (and their memory) —
        called whenever a restart policy swaps the workflow's algorithm (or
        a run puts the base one back): a captured graph replays the
        algorithm it was captured with, and a regrown population's state
        has new shapes.  A new runner keeps the workflow's captures."""
        reset = getattr(self.workflow, "reset_graphs", None)
        if reset is not None:
            reset()
        self._segment_cfg = None
        self._exec_cache_identity = None

    # -- program shapes ----------------------------------------------------
    def _capturable(self) -> bool:
        """Whether every problem of the workflow's wrapper chain can run in
        a captured graph (a host-fault problem cannot)."""
        from ..parallel import iter_problem_chain

        problem = getattr(self.workflow, "problem", None)
        return all(bool(getattr(p, "capturable", True)) for p in iter_problem_chain(problem))

    def _fused_cfg(self, state: State):
        """The fused segment's configuration: the health probe's detector
        set (which drives the early-stop predicate), the early-stop choice,
        ``metrics=False`` (the boundary verdict comes from the probe's own
        scan) and the flight signals when the obs plane carries a
        recorder.  On the card a problem that calls the host runs the
        per-generation route (``capture_history=False``: eager generations
        on the card)."""
        if self._segment_cfg is None:
            self._segment_cfg = self.workflow.segment_config(
                health=self.health,
                metrics=False,
                stop_on_unhealthy=self.fused_early_stop,
                flight=self.obs is not None and self.obs.flight is not None,
            )
        cfg = self._segment_cfg
        if _state_device(state).type == "cuda" and not self._capturable():
            cfg = cfg._replace(capture_history=False)
        return cfg

    def _is_fused(self, which: str, chunk: int | None) -> bool:
        return which == "segment" and self.fused and chunk is not None and chunk > 1

    def _dispatch(self, which: str, state: State, chunk: int | None):
        """Enqueue one attempt's work: ``(state, telemetry)`` for a fused
        segment, the bare state otherwise."""
        if which == "init":
            return self.workflow.init_step(state)
        if chunk == 1:
            # A single-generation segment (the ragged tail of a run) is the
            # plain step, as in the JAX package (the same bits either way).
            return self.workflow.step(state)
        if self.fused:
            return self.workflow._run_segment(state, chunk, self._fused_cfg(state))
        for _ in range(chunk):
            state = self.workflow.step(state)
        return state

    def _boundary_reads(self, state: State) -> dict[str, torch.Tensor]:
        """Further tensors of a completed attempt's state that the boundary
        reads on the host, folded into :meth:`_complete`'s one copy and
        handed back as float64 numpy arrays of their shapes (a subclass's
        hook: the HPO runner's nested telemetry)."""
        return {}

    def _complete(self, result: Any, fused: bool, holder: dict) -> dict[str, Any]:
        """Wait for one attempt's work and read its scalars to the host in
        ONE copy: ``executed``/``stopped`` and the flight signals of a fused
        segment, the monitor's counters and :meth:`_boundary_reads`.  Under
        the watchdog the wait polls a CUDA event (recorded into ``holder``,
        so an abandoned attempt can be waited out later)."""
        state, tel = result if fused else (result, None)
        parts: list[tuple[Any, torch.Tensor]] = []
        if tel is not None:
            parts.append(("executed", tel["executed"]))
            parts.append(("stopped", tel["stopped"]))
            for name, values in (tel["flight"].items() if "flight" in tel else ()):
                parts.append((("flight", name), values))
        mon = state["monitor"] if isinstance(state, State) and "monitor" in state else None
        if mon is not None:
            for key in _MONITOR_COUNTERS:
                if key in mon and isinstance(mon[key], torch.Tensor):
                    parts.append((("monitor", key), mon[key]))
        for name, t in self._boundary_reads(state).items():
            parts.append((("reads", name), t))
        device = _state_device(state)
        if device.type == "cuda" and (self.watchdog_timeout is not None or not parts):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            holder["event"] = event
            if self.watchdog_timeout is not None:
                while not event.query():
                    time.sleep(_POLL_SECONDS)
            else:
                # Nothing to read: wait for the stream's work (the same as
                # the event, on the one stream the attempt used).
                torch.cuda.current_stream(device).synchronize()
        host: dict[str, Any] = {"flight": {}, "monitor": {}, "reads": {}}
        if not parts:
            return host
        values = torch.cat([t.detach().reshape(-1).to(device=device, dtype=torch.float64) for _, t in parts]).tolist()
        pos = 0
        for label, t in parts:
            n = t.numel()
            chunk = values[pos : pos + n]
            pos += n
            if label == "executed":
                host["executed"] = int(chunk[0])
            elif label == "stopped":
                host["stopped"] = bool(chunk[0])
            elif label[0] == "reads":
                host["reads"][label[1]] = np.asarray(chunk, dtype=np.float64).reshape(tuple(t.shape))
            else:
                host[label[0]][label[1]] = chunk if t.ndim else chunk[0]
        return host

    # -- events ------------------------------------------------------------
    def _event(self, msg: str, *, warn: bool = False, category: str = "runner", **payload: Any) -> None:
        """One supervisor event: always onto the obs bus (typed, with
        severity), AND through the string callback / warning."""
        if self.obs is not None:
            self.obs.event(category, msg, severity="warning" if warn else "info", **payload)
        if self.on_event is not None:
            self.on_event(msg)
        elif warn:
            warnings.warn(msg)

    def _span(self, name: str, **args: Any):
        """A tracer span when the obs plane is live, else a no-op context."""
        if self.obs is not None:
            return self.obs.span(name, **args)
        return contextlib.nullcontext()

    # -- metrics -----------------------------------------------------------
    def _sync_counter(self, name: str, value: float, help: str = "") -> None:
        self.obs.registry.counter_sync(self._metric_cursor, name, value, help)

    def _publish_metrics(self, counters: dict[str, float] | None = None) -> None:
        """Feed the registry from ``RunStats`` and, when given, the
        monitor's in-state counters as read at the boundary (the JAX
        package's metric names) — strictly host-side."""
        if self.obs is None:
            return
        s = self.stats
        self._sync_counter("evox_runner_generations_total", s.completed_generations, "Generations completed by ResilientRunner.")
        self._sync_counter("evox_runner_segments_total", s.segments_run, "Compiled segments executed.")
        self._sync_counter("evox_runner_retries_total", s.retries, "Segment retries.")
        self._sync_counter(
            "evox_runner_watchdog_timeouts_total", s.watchdog_timeouts, "Segments abandoned past the watchdog deadline."
        )
        self._sync_counter("evox_runner_cpu_fallbacks_total", s.cpu_fallbacks, "Runs that fell back to the CPU backend.")
        self._sync_counter("evox_runner_restarts_total", len(s.restarts), "Health-triggered restart-policy firings.")
        self._sync_counter("evox_runner_health_checks_total", s.health_checks, "Boundary health probes run.")
        self._sync_counter(
            "evox_runner_unhealthy_probes_total", s.unhealthy_probes, "Boundary health probes with unhealthy verdicts."
        )
        self._sync_counter("evox_runner_early_stops_total", s.early_stops, "Fused segments frozen early by the in-scan detector.")
        self._sync_counter("evox_runner_checkpoints_written_total", s.checkpoints_written, "Checkpoints durably published.")
        self._sync_counter(
            "evox_runner_checkpoint_write_failures_total",
            s.checkpoint_write_failures,
            "Checkpoint writes that failed (run continued).",
        )
        self._sync_counter(
            "evox_runner_checkpoint_skips_total", len(s.checkpoint_skips), "Resume candidates rejected by the scan."
        )
        self._sync_counter(
            "evox_runner_checkpoint_quarantines_total",
            sum(1 for k in s.checkpoint_skips if k.quarantined),
            "Byte-damaged checkpoints renamed *.corrupt.",
        )
        self._sync_counter(
            "evox_runner_preemptions_total",
            1.0 if s.preempted else 0.0,
            "Graceful preemption stops (emergency checkpoint published).",
        )
        self._sync_counter(
            "evox_runner_checkpoint_block_seconds_total",
            s.checkpoint_block_seconds,
            "Wall seconds the generation loop spent blocked on checkpointing.",
        )
        if counters:
            labels = {"run_id": self.obs.run_id} if self.obs.run_id is not None else {}
            for key in _MONITOR_COUNTERS:
                if key in counters:
                    self.obs.gauge(
                        f"evox_monitor_{key}", "EvalMonitor in-state counter (boundary snapshot).", **labels
                    ).set(float(counters[key]))

    @staticmethod
    def _read_counters(state: State) -> dict[str, float]:
        """The monitor's counters of ``state``, in one copy to the host."""
        mon = state["monitor"] if isinstance(state, State) and "monitor" in state else None
        keys = [k for k in _MONITOR_COUNTERS if mon is not None and k in mon]
        if not keys:
            return {}
        values = torch.stack([mon[k].reshape(()).to(torch.float64) for k in keys]).tolist()
        return dict(zip(keys, values))

    def _publish_introspection(self, device: torch.device, stepped: int) -> None:
        """Segment-boundary device introspection (host-side): the card's
        allocator statistics as ``evox_device_*`` gauges and a Chrome-trace
        counter track, and the segment's generations/sec.  A captured graph
        has no cost model (``obs.xla.program_analysis`` of it is empty), so
        no roofline gauge is published: the JAX package's contract for a
        backend without one."""
        if self.obs is None:
            return
        from ..obs import xla as obs_xla

        stats = obs_xla.publish_device_memory_gauges(self.obs.registry, device)
        if stats:
            self.obs.record_counter(
                "device-memory",
                bytes_in_use=stats.get("bytes_in_use"),
                peak_bytes_in_use=stats.get("peak_bytes_in_use"),
            )
        seconds = self._last_exec_seconds
        gps = stepped / seconds if seconds > 0 and stepped else 0.0
        if gps:
            self.obs.record_counter("throughput", gens_per_sec=gps)
            labels = {"run_id": self.obs.run_id} if self.obs.run_id is not None else {}
            self.obs.gauge(
                "evox_runner_gens_per_sec", "Blocked-execution generations/sec of the latest segment.", **labels
            ).set(gps)

    # -- checkpointing -----------------------------------------------------
    def _ckpt_path(self, generation: int) -> Path:
        return self.checkpoint_dir / f"ckpt_{generation:08d}.npz"

    def _manifest_extras(self, probed: bool, state: State | None = None) -> dict:
        """Topology, numerics identity and health/restart context riding in
        the checkpoint manifest so a resumed run replays decisions exactly
        (the JAX package's entries)."""
        from ..precision import precision_tag

        extras: dict = {"topology": workflow_topology(self.workflow).to_manifest()}
        extras["precision"] = precision_tag(getattr(self.workflow, "precision", None))
        extras["key_impl"] = self._run_key_impl(state)
        if self.health is not None:
            extras.update(
                restarts=[e.to_manifest() for e in self.stats.restarts],
                health_window=list(self.health.window),
                health_probed=bool(probed),
            )
        return extras

    def _observed_key_impl(self, state: State | None) -> str:
        """The key impl this run's numerics identity records: that of
        ``state``'s key leaves when it has any (read on the host), else
        the workflow's knob resolved through the environment."""
        from ..precision import resolve_key_impl, state_key_impl

        observed = None if state is None else state_key_impl(state)
        return observed or resolve_key_impl(getattr(self.workflow, "key_impl", None))

    def _run_key_impl(self, state: State | None) -> str:
        """:meth:`_observed_key_impl` read once a run (the family of a
        run's keys never changes), so a boundary does not read a key."""
        if self._key_impl is None:
            self._key_impl = self._observed_key_impl(state)
        return self._key_impl

    def _note_write_failure(self, path, exc: BaseException) -> None:
        """A checkpoint write failed: the run goes on — the previous
        checkpoint remains the resume point."""
        name = Path(path).name
        self.stats.checkpoint_write_failures += 1
        self.stats.failures.append(f"checkpoint {name}: {type(exc).__name__}: {exc}")
        self._event(
            f"checkpoint write of {name} failed ({type(exc).__name__}: "
            f"{exc}); continuing — the previous checkpoint remains the "
            f"resume point",
            warn=True,
            category="checkpoint",
            path=name,
            error=f"{type(exc).__name__}: {exc}",
        )

    def _gc_stale_checkpoints(self) -> None:
        """Delete all but the newest ``keep_checkpoints`` files — only after
        a successful durable publish, and only on the fleet's primary."""
        if not self.keep_checkpoints or not self.primary:
            return
        numbered = _numbered_checkpoints(self.checkpoint_dir)
        for _, stale in numbered[: -self.keep_checkpoints]:
            try:
                self.store.unlink(stale)
            except OSError:  # pragma: no cover - racing cleaners
                pass

    def _barrier_writer(self) -> None:
        """Wait out any in-flight async checkpoint write."""
        if self._writer is not None:
            with self._span("checkpoint-barrier"):
                self._writer.barrier()

    def _fleet_sync(self) -> None:
        """Meet the other ranks where the single writer's disk state is about
        to be read fleet-wide (a restart policy scanning the directory).
        No-op for one process.  Every rank reaches the call sites under the
        same control flow (boundary verdicts are functions of the
        replicated state), so the barrier always matches up."""
        if _num_processes() <= 1:
            return
        from ..parallel.multihost import fleet_barrier

        with self._span("fleet-barrier"):
            fleet_barrier("evox_tpu_runner_boundary")

    def _beat(self, generation: int) -> None:
        """Publish a heartbeat progress beat for this boundary (no-op
        without a heartbeat)."""
        if self.heartbeat is not None:
            self.heartbeat.beat(generation=int(generation), segment_seconds=self._last_exec_seconds)

    def _write_checkpoint(
        self,
        state: State,
        generation: int,
        *,
        probed: bool = False,
        emergency: bool = False,
        extra_metadata: dict | None = None,
    ) -> bool:
        """Publish ``state`` as ``ckpt_<generation>.npz``.

        Async by default: the call submits to the background writer (waiting
        only for a *previous* in-flight write) and returns.  Emergency writes
        (preemption) wait for the publish — through the pinned-buffer writer
        (a one-off writer when the runner writes synchronously), so the copy
        is ordered after the segment's work on the card by an event.
        Returns whether a waited-for write succeeded.  A non-primary fleet
        process returns ``True`` and touches nothing: the primary's write of
        the same replicated state is this boundary's checkpoint."""
        if not self.primary:
            return True
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        path = self._ckpt_path(generation)
        metadata = self._manifest_extras(probed, state)
        if extra_metadata:
            metadata.update(extra_metadata)
        t0 = time.perf_counter()
        try:
            if self._writer is not None and not emergency:

                def _published(gen: int = generation) -> None:
                    self.stats.checkpoints_written += 1
                    self._event(f"checkpoint written at generation {gen}", category="checkpoint", generation=gen)
                    self._gc_stale_checkpoints()

                self._writer.submit(path, state, generation=generation, metadata=metadata, on_published=_published)
                return True
            if emergency:
                published = []
                writer = self._writer or AsyncCheckpointWriter(
                    store=self.store, durable=True, on_error=self._note_write_failure
                )
                try:
                    writer.submit(
                        path, state, generation=generation, metadata=metadata, on_published=lambda: published.append(1)
                    )
                    writer.barrier()
                finally:
                    if writer is not self._writer:
                        writer.close()
                if not published:
                    return False
            else:
                try:
                    save_state(path, state, generation=generation, metadata=metadata, store=self.store, durable=True)
                except (OSError, RuntimeError, ValueError) as e:
                    self._note_write_failure(path, e)
                    return False
            self.stats.checkpoints_written += 1
            self._event(
                f"checkpoint written at generation {generation}" + (" (emergency)" if emergency else ""),
                category="checkpoint",
                generation=generation,
                emergency=emergency,
            )
            self._gc_stale_checkpoints()
            return True
        finally:
            t1 = time.perf_counter()
            self.stats.checkpoint_block_seconds += t1 - t0
            if self.obs is not None:
                self.obs.record_span("checkpoint-submit", t0, t1, generation=generation, emergency=emergency)

    def _pop_size_hint(self) -> int | None:
        """Population size for re-mesh divisibility checks (``None`` when
        the evaluation pads)."""
        from ..parallel import find_sharded

        sharded = find_sharded(getattr(self.workflow, "problem", None))
        if sharded is not None and sharded.pad:
            return None
        algo = self._base_algorithm or getattr(self.workflow, "algorithm", None)
        size = getattr(algo, "pop_size", None)
        return int(size) if isinstance(size, int) else None

    def _skip_candidate(self, path: Path, reason: str, *, quarantined: bool = False) -> None:
        """Record one rejected resume candidate."""
        self.stats.checkpoint_skips.append(CheckpointSkip(path=str(path), reason=reason, quarantined=quarantined))
        if quarantined:
            self._event(f"quarantined unusable checkpoint {path.name} -> {path.name}.corrupt: {reason}", warn=True)
        else:
            self._event(f"skipping unusable checkpoint {path.name}: {reason}", warn=True)

    def resume(self, template: State) -> tuple[State, int] | None:
        """Load the newest checkpoint that validates against ``template``.

        Returns ``(state, completed_generations)`` or ``None`` when no
        usable checkpoint exists.  The scan digest-verifies every candidate
        (``verify_resume``): byte-damaged files are quarantined as
        ``*.corrupt``, intact candidates that fail template validation are
        skipped in place, each recorded as a :class:`CheckpointSkip`.
        Restart lineage, the probe's stagnation window and the topology
        ride in the manifest: the lineage is replayed (rebuilding the
        template after a regrow), the window restored, and a topology
        change re-meshes (``remesh=True``) or raises."""
        if not self.checkpoint_dir.is_dir():
            return None
        self._barrier_writer()  # the scan must see every submitted write
        self._resumed_probed = False
        current_topo = workflow_topology(self.workflow)
        meshed = workflow_mesh(self.workflow)
        candidates, rejected = scan_checkpoints(
            self.checkpoint_dir,
            verify=self.verify_resume,
            # Quarantine renames mutate the directory: the primary's alone.
            quarantine=bool(self.verify_resume) and self.primary,
            store=self.store,
        )
        for path, reason, quarantined in rejected:
            self._skip_candidate(path, reason, quarantined=quarantined)
        for gen, path in reversed(candidates):
            try:
                manifest = read_manifest(path)
                if manifest.get("generation") not in (None, gen):
                    raise CheckpointError(
                        f"manifest generation {manifest['generation']} does not match filename generation {gen}"
                    )
            except FileNotFoundError:
                self._skip_candidate(path, "vanished during resume (concurrent cleaner)")
                continue
            except (CheckpointError, ValueError) as e:
                self._skip_candidate(path, str(e))
                continue
            # A mesh mismatch with remesh disabled fails the resume loudly.
            recorded_topo = check_topology(
                (manifest or {}).get("topology"),
                current_topo,
                remesh=self.remesh,
                pop_size=self._pop_size_hint(),
                pop_axis=meshed[1] if meshed is not None else None,
                context=f"checkpoint {path.name}",
            )
            topology_changed = topology_differs(recorded_topo, current_topo)
            try:
                try:
                    lineage = [RestartEvent.from_manifest(d) for d in (manifest or {}).get("restarts", [])]
                    # Each candidate is validated under ITS lineage.
                    self._reset_base_algorithm()
                    candidate_template = template
                    if lineage and self.restart is not None:
                        candidate_template = self.restart.rebuild_template(
                            self.workflow, template, lineage, runner=self
                        )
                except (CheckpointError, ValueError):
                    raise
                except Exception as e:
                    raise CheckpointError(f"restart lineage in manifest is unusable: {e!r}") from e
                state = load_state(
                    path,
                    candidate_template,
                    allow_missing=True,
                    verify=self.verify_resume == "manifest",
                    precision=getattr(self.workflow, "precision", None),
                    key_impl=self._observed_key_impl(candidate_template),
                )
            except FileNotFoundError:
                self._skip_candidate(path, "vanished during resume (concurrent cleaner)")
                continue
            except CheckpointCorruptError as e:
                quarantined = True
                try:
                    self.store.rename(path, _quarantine_target(path))
                except OSError:  # pragma: no cover - racing cleaners
                    quarantined = False
                self._skip_candidate(path, str(e), quarantined=quarantined)
                continue
            except (CheckpointError, ValueError) as e:
                self._skip_candidate(path, str(e))
                continue
            if topology_changed and meshed is not None:
                mesh, axis = meshed
                state = remesh_state(state, mesh, axis)
                self._event(
                    f"re-meshed {path.name}: written on a {recorded_topo.describe()}, resuming on a "
                    f"{current_topo.describe()}"
                )
            if lineage:
                self.stats.restarts = lineage
                self._event(f"restored restart lineage of {len(lineage)} event(s) from {path.name}")
            if self.health is not None and manifest:
                self.health.restore(manifest.get("health_window", []))
                self._resumed_probed = bool(manifest.get("health_probed", False))
            if manifest.get("preempted"):
                self.stats.resumed_after_preemption = True
                self._event(
                    f"{path.name} is an emergency checkpoint "
                    f"({manifest.get('preemption_reason', 'preempted')}); "
                    f"continuing the interrupted run"
                )
            self._event(f"resumed from {path.name} (generation {gen})")
            return state, gen
        self._reset_base_algorithm()
        return None

    def _reset_base_algorithm(self) -> None:
        """Undo any restart-policy mutation of ``workflow.algorithm``."""
        if self._base_algorithm is not None and getattr(self.workflow, "algorithm", None) is not self._base_algorithm:
            self.workflow.algorithm = self._base_algorithm
            self._rebind_workflow()

    # -- guarded execution -------------------------------------------------
    def _with_deadline(self, fn: Callable[[dict], Any], timeout: float, what: str) -> Any:
        """Run ``fn(holder)`` in a daemon worker thread and abandon it past
        ``timeout``.  An abandoned worker (and the CUDA event it recorded in
        ``holder``) is kept, and waited out before the next attempt
        (:meth:`_drain_abandoned`)."""
        result: dict = {}
        holder: dict = {}

        def target() -> None:
            try:
                result["value"] = fn(holder)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                result["error"] = e

        worker = threading.Thread(target=target, name="evox-tpu-torch-guard", daemon=True)
        worker.start()
        worker.join(timeout)
        if worker.is_alive():
            self._abandoned = (worker, holder)
            raise WatchdogTimeout(
                f"{what} exceeded the {timeout:.1f}s watchdog deadline (hung work); abandoning the attempt"
            )
        if "error" in result:
            raise result["error"]
        return result["value"]

    def _drain_abandoned(self) -> None:
        """Wait for an attempt the watchdog abandoned: its worker thread,
        then the card's work up to its event (polled).  A retry must not
        write the static buffers of a graph, or replay it, while an older
        replay of it may still run.  Past the watchdog deadline the wait
        raises :class:`WatchdogTimeout` (retryable) and stays pending."""
        if self._abandoned is None:
            return
        worker, holder = self._abandoned
        limit = self.watchdog_timeout if self.watchdog_timeout is not None else 0.0
        deadline = time.monotonic() + limit
        worker.join(max(limit, 0.0))
        while True:
            event = holder.get("event")
            if not worker.is_alive() and (event is None or event.query()):
                self._abandoned = None
                return
            if time.monotonic() >= deadline:
                raise WatchdogTimeout(
                    f"an abandoned attempt has not drained within the {limit:.1f}s watchdog deadline; "
                    f"the next attempt waits for it"
                )
            time.sleep(_POLL_SECONDS)

    def _prepare(self, which: str, state: State, chunk: int | None) -> None:
        """Capture the fused segment's CUDA graph before the segment runs
        (once per chunk length and state structure; the counterpart of the
        JAX package's AOT compile), under ``compile_timeout`` when set.
        The async writer is waited out first: a capture refuses some of
        its CUDA work on the other thread.  With ``exec_cache`` the
        program's capture record is looked up before its first capture and
        saved after it when missing."""
        if not self._is_fused(which, chunk):
            return
        on_card = _state_device(state).type == "cuda"
        pkey = self._program_key(which, chunk, state) if self.exec_cache is not None else None
        if pkey in self._cached_programs:
            pkey = None  # looked up before: the capture alone, if any
        if not on_card and pkey is None:
            return
        cfg = self._fused_cfg(state) if on_card else None
        waited = []

        def barrier() -> None:
            # A wait for the checkpoint writer, not part of the capture.
            b0 = time.perf_counter()
            self._barrier_writer()
            waited.append(time.perf_counter() - b0)

        def capture(holder: dict | None = None) -> bool:
            hit = pkey is not None and self.exec_cache.load(*pkey) is not None
            captured = on_card and self.workflow.prepare_segment(state, chunk, cfg, before=barrier)
            if pkey is not None:
                if not hit:
                    from ..utils.exec_cache import capture_record

                    self.exec_cache.save(*pkey, capture_record())
                self._cached_programs[pkey] = hit
            return captured

        t0 = time.perf_counter()
        if self.compile_timeout is not None:
            captured = self._with_deadline(capture, self.compile_timeout, f"capture of {which}")
        else:
            captured = capture()
        blocked = sum(waited)
        self.stats.checkpoint_block_seconds += blocked
        t0 += blocked
        t1 = time.perf_counter()
        loaded = pkey is not None and self._cached_programs[pkey]
        if self.obs is not None and loaded:
            self.obs.counter(
                "evox_runner_exec_cache_loads_total",
                "Segment programs whose capture record came from the persistent executable cache.",
            ).inc()
        if not captured:
            return
        self._last_compile_seconds += t1 - t0
        if self.obs is not None:
            from ..obs import xla as obs_xla

            label = f"{which}[{chunk}]"
            analysis = obs_xla.program_analysis(None)
            obs_xla.publish_program_gauges(self.obs.registry, label, analysis)
            self.obs.record_span("aot-compile", t0, t1, which=which, chunk=chunk, cached=loaded, **analysis)
            self.obs.counter("evox_runner_compiles_total", "Cold AOT compiles paid by the runner.").inc()
            self.obs.histogram(
                "evox_runner_segment_compile_seconds", "AOT compile seconds per compiled segment program."
            ).observe(t1 - t0)

    def _program_key(self, which: str, chunk: int | None, state: State) -> tuple[str, tuple]:
        """``(label, signature)`` of a segment program in the persistent
        cache.  The abstract signature covers shapes and dtypes but not the
        program: two workflows with identically-shaped states (another
        problem) would collide, so the label is salted with the workflow's
        static-configuration digest, as in the JAX package."""
        from ..service.tenant import static_signature
        from ..utils.exec_cache import abstract_signature

        if self._exec_cache_identity is None:
            self._exec_cache_identity = static_signature(self.workflow)[:16]
        label = which if chunk is None else f"{which}[{chunk}]"
        if self._forced_cpu:
            label += "[cpu]"
        return label + f"[{self._exec_cache_identity}]", abstract_signature(state)

    def _execute_once(self, which: str, state: State, chunk: int | None, retry_from: int | None = None):
        """One attempt: wait out an abandoned one, capture (first time),
        then dispatch and wait under the watchdog.  Returns ``(result,
        host)``: the attempt's result and its scalars on the host."""
        self._last_compile_seconds = 0.0
        if self._forced_cpu:
            # As JAX's device_put of every attempt's state: a restart policy
            # may have handed back card tensors or a card-built component.
            self._to_cpu_twin()
            state = relocate(state, "cpu")
        else:
            # The CPU twin never touches an abandoned attempt's graph.
            self._drain_abandoned()
        if retry_from is not None:
            # History an earlier, failed attempt recorded eagerly belongs
            # to generations the retry runs again.
            self._truncate_history(state, retry_from)
        self._prepare(which, state, chunk)
        fused = self._is_fused(which, chunk)
        out: dict = {}

        def run(holder: dict):
            out["result"] = self._dispatch(which, state, chunk)
            return self._complete(out["result"], fused, holder)

        t0 = time.perf_counter()
        try:
            if self.watchdog_timeout is None:
                host = run({})
            else:
                host = self._with_deadline(run, self.watchdog_timeout, "segment execution")
            return out["result"], host
        finally:
            t1 = time.perf_counter()
            self._last_exec_seconds = t1 - t0
            if self.obs is not None:
                self.obs.record_span("execute", t0, t1, which=which, chunk=chunk)
                self.obs.histogram(
                    "evox_runner_segment_execute_seconds", "Blocked execution seconds per segment attempt."
                ).observe(t1 - t0)

    def _truncate_history(self, state: State, generation: int) -> None:
        """Drop the monitor's history entries past ``state``'s generation
        count (its monitor's ``generation`` leaf, else ``generation``)."""
        truncate = getattr(getattr(self.workflow, "monitor", None), "truncate_history", None)
        if truncate is None:
            return
        mon = state["monitor"] if isinstance(state, State) and "monitor" in state else None
        if mon is not None and "generation" in mon:
            generation = int(mon["generation"])
        truncate(generation)

    def _reload_for_retry(self, state: State, generation: int) -> State:
        """Best source of truth for a retry: the on-disk checkpoint of the
        segment's input generation; falls back to the in-memory state."""
        self._barrier_writer()
        path = self._ckpt_path(generation)
        if path.exists():
            try:
                return load_state(
                    path,
                    state,
                    verify=bool(self.verify_resume),
                    precision=getattr(self.workflow, "precision", None),
                    key_impl=self._run_key_impl(state),
                )
            except (CheckpointError, ValueError) as e:  # pragma: no cover
                self._event(f"retry reload of {path.name} failed ({e}); reusing in-memory state", warn=True)
        return state

    def _attempt(self, which: str, state: State, generation: int, desc: str, chunk: int | None = None):
        """Execute one segment with the full recovery ladder: retries with
        backoff, then (optionally, on the CPU) a fallback with a fresh
        budget.  Returns ``(result, host)``."""
        failures = 0
        failed = False
        while True:
            try:
                # A retry, and the fallback's first attempt, run again
                # generations a failed attempt may have recorded.
                return self._execute_once(which, state, chunk, retry_from=generation if failed else None)
            except Exception as e:  # noqa: BLE001 - predicate filters below
                if not self.retry.retryable(e):
                    raise
                failed = True
                failures += 1
                if isinstance(e, WatchdogTimeout):
                    self.stats.watchdog_timeouts += 1
                self.stats.failures.append(f"{desc}: {type(e).__name__}: {e}")
                if failures > self.retry.max_retries:
                    if self.cpu_fallback and not self._forced_cpu:
                        # The rest of the run runs on the CPU twin, from the
                        # segment's input checkpoint loaded into a CPU
                        # template, with a fresh budget.
                        self._forced_cpu = True
                        self.stats.cpu_fallbacks += 1
                        failures = 0
                        self._event(f"{desc}: retry budget exhausted; falling back to the CPU backend", warn=True)
                        state = self._reload_for_retry(relocate(state, "cpu"), generation)
                        continue
                    raise ResilienceError(
                        f"{desc} failed after {self.retry.max_retries} retries"
                        + (" and a CPU fallback" if self._forced_cpu else "")
                    ) from e
                delay = self.retry.delay(failures)
                self.stats.retries += 1
                self._event(f"{desc}: attempt {failures} failed ({type(e).__name__}); retrying in {delay:.2f}s", warn=True)
                time.sleep(delay)
                state = self._reload_for_retry(state, generation)

    def _to_cpu_twin(self) -> None:
        """Run on the CPU twin of the workflow from here on (see the module
        docstring), keeping the card workflow for the next ``run()``.  The
        monitor is shared whole: its history stays one history.  A no-op
        once the workflow is on the CPU."""
        twin = relocate(self.workflow, "cpu", share=[getattr(self.workflow, "monitor", None)])
        if twin is self.workflow:
            return
        if self._card_workflow is None:
            self._card_workflow = self.workflow
        self.workflow = twin
        # The twin's segment configuration, program-cache identity and
        # programs are its own.
        self._segment_cfg = None
        self._exec_cache_identity = None

    def _restore_card_workflow(self) -> None:
        """Put back the workflow a CPU fallback swapped out."""
        if self._card_workflow is not None:
            self.workflow = self._card_workflow
            self._card_workflow = None
            self._segment_cfg = None
            self._exec_cache_identity = None

    # -- run-health probing and restarts -----------------------------------
    def _controller_trend(self, done: int):
        """Consult the controller's trend plane with the flight window.
        Returns a fired :class:`~evox_tpu_torch.control.Decision` or
        ``None``; never raises — a missing/detached flight recorder and any
        controller failure degrade to the threshold probes (the controller
        emits the structured warning and ``degrade`` decision; this wrapper
        is the outer guard)."""
        flight = self.obs.flight if self.obs is not None else None
        rows = None
        if flight is not None:
            try:
                rows = flight.rows()
            except Exception:  # noqa: BLE001 - detached/broken recorder
                rows = None
        try:
            return self.controller.trend_verdict(rows, generation=done)
        except Exception as e:  # noqa: BLE001 - advisory plane only
            self._event(
                f"controller trend consult failed ({type(e).__name__}: {e}); continuing on threshold probes",
                warn=True,
                category="control",
            )
            return None

    def _health_boundary(self, state: State, done: int, n_steps: int) -> tuple[State, int]:
        """Probe the state at a segment boundary; apply the restart policy
        on an unhealthy verdict.  Called exactly once per boundary, so the
        probe's stagnation window advances identically in interrupted and
        uninterrupted runs.  Where the probe reads healthy, the controller's
        trend plane reads the flight window and may fire the restart early
        (an unhealthy probe verdict always wins)."""
        if self.health is None and self.controller is None:
            return state, done
        report: HealthReport | None = None
        if self.health is not None:
            with self._span("health-probe", generation=done):
                report = self.health.check(state, generation=done)
            self.stats.health_checks += 1
            self.stats.last_report = report
            if not report.healthy:
                self.stats.unhealthy_probes += 1
        trend_decision = None
        if (
            (report is None or report.healthy)
            and self.controller is not None
            and self.controller.trend_enabled
            and done < n_steps
        ):
            trend_decision = self._controller_trend(done)
            if trend_decision is not None:
                base = report if report is not None else HealthReport(generation=done, healthy=True)
                report = base.with_trend([f"controller trend verdict: {trend_decision.action}"])
                self.stats.last_report = report
        if report is None or report.healthy:
            return state, done
        reasons = "; ".join(report.reasons)
        if self.restart is None or done >= n_steps:
            self._event(
                f"unhealthy state at generation {done}: {reasons}",
                warn=True,
                category="health",
                generation=done,
                reasons=list(report.reasons),
            )
            return state, done
        if len(self.stats.restarts) >= self.max_restarts:
            self._event(
                f"unhealthy state at generation {done} ({reasons}) but the "
                f"restart budget of {self.max_restarts} is spent; continuing",
                warn=True,
                category="health",
                generation=done,
                reasons=list(report.reasons),
            )
            return state, done
        return self._fire_restart(state, done, n_steps, report, trend_decision)

    def _fire_restart(
        self, state: State, done: int, n_steps: int, report: HealthReport, trend_decision: Any = None
    ) -> tuple[State, int]:
        """Apply the restart policy to an unhealthy boundary verdict: policy
        apply, lineage event, post-restart checkpoint and stale-future
        invalidation.  A control-plane decision that fired the verdict
        rides into ``RestartContext.decision`` and the lineage event's
        ``trend``/``decision_seq``.  Subclasses (the HPO runner's growth
        ladder) fire the same machinery with their own verdicts; callers
        guarantee a restart policy and an unspent budget."""
        reasons = "; ".join(report.reasons)
        # Restart policies read checkpoints from disk: flush the boundary's
        # in-flight async write first, and in a fleet meet the other ranks
        # on the primary's flush.
        self._barrier_writer()
        self._fleet_sync()
        idx = len(self.stats.restarts)
        ctx = RestartContext(
            runner=self,
            workflow=self.workflow,
            state=state,
            generation=done,
            report=report,
            restart_index=idx,
            lineage=tuple(self.stats.restarts),
            decision=trend_decision,
        )
        new_state, new_done, needs_init, detail = self.restart.apply(ctx)
        if trend_decision is not None:
            # Which plane fired: the journaled decision (seq) holds the
            # full evidence.
            detail = {**detail, "trend": trend_decision.action, "decision_seq": trend_decision.seq}
        event = RestartEvent(
            generation=done, policy=self.restart.name, restart_index=idx, reasons=list(report.reasons), detail=detail
        )
        self.stats.restarts.append(event)
        self._event(
            f"restart #{idx + 1} ({self.restart.name}) at generation {done}: {reasons}",
            warn=True,
            category="restart",
            policy=self.restart.name,
            generation=done,
            restart_index=idx,
            reasons=list(report.reasons),
        )
        # A full window for the restarted search to prove itself.
        if self.health is not None:
            self.health.reset()
        monitor = getattr(self.workflow, "monitor", None)
        if new_done < done:
            # A rollback replays the generations past new_done.
            self._truncate_history(new_state, new_done)
        if monitor is not None and "monitor" in new_state:
            new_state = new_state.replace(monitor=monitor.record_restart(new_state["monitor"]))
        if needs_init:
            # Fresh-setup policies hand back a pre-init state: drive it
            # through one init segment before chunking resumes.
            new_state, _ = self._attempt("init", new_state, new_done, f"restart init (generation {new_done + 1})")
            new_done += 1
            self.stats.segments_run += 1
        # Publish the post-restart state and invalidate the stale future.
        self._write_checkpoint(new_state, new_done, probed=not needs_init)
        self._barrier_writer()
        if self.primary:
            for gen, path in _numbered_checkpoints(self.checkpoint_dir):
                if gen > new_done:
                    try:
                        self.store.unlink(path)
                    except OSError:  # pragma: no cover - racing cleaners
                        pass
        # Fleet lockstep: no rank runs on while the writer invalidates.
        self._fleet_sync()
        self.stats.completed_generations = new_done
        if needs_init:
            return self._health_boundary(new_state, new_done, n_steps)
        return new_state, new_done

    # -- preemption --------------------------------------------------------
    def _handle_preemption(self, state: State, done: int, probed: bool):
        """The guard tripped: flush in-flight writes, publish an emergency
        checkpoint marked ``preempted`` (the monitor's ``num_preemptions``
        bumped in the saved state), and raise :class:`Preempted`."""
        reason = self.preemption.reason or "preempted"
        self._barrier_writer()
        monitor = getattr(self.workflow, "monitor", None)
        if monitor is not None and "monitor" in state:
            state = state.replace(monitor=monitor.record_preemption(state["monitor"]))
        ok = self._write_checkpoint(
            state,
            done,
            probed=probed,
            emergency=True,
            extra_metadata={"preempted": True, "preemption_reason": reason},
        )
        self.stats.preempted = True
        self.stats.preemption_reason = reason
        path = self._ckpt_path(done)
        outcome = "published" if ok else "FAILED — prior boundary checkpoint remains the resume point"
        self._event(
            f"preempted at generation {done} ({reason}); emergency checkpoint {outcome}",
            warn=True,
            category="preemption",
            generation=done,
            reason=reason,
            checkpoint_published=ok,
        )
        self._publish_metrics(self._read_counters(state))
        raise Preempted(
            f"run preempted at generation {done} ({reason}); rerun the same "
            f"supervisor to resume bit-identically from "
            f"{path.name if ok else 'the previous checkpoint'}",
            generation=done,
            reason=reason,
            checkpoint=path if ok else None,
        )

    # -- wall-clock checkpoint cadence ---------------------------------------
    def _next_chunk(self) -> int:
        if self.controller is not None and self.controller.cadence_enabled:
            chunk = None
            try:
                chunk = self.controller.next_chunk(
                    self.stats.segment_timings,
                    checkpoint_every=self.checkpoint_every,
                    generation=self.stats.completed_generations,
                    current=self._controller_chunk,
                )
            except Exception as e:  # noqa: BLE001 - advisory plane only
                self._event(
                    f"controller cadence consult failed ({type(e).__name__}: {e}); keeping the configured cadence",
                    warn=True,
                    category="control",
                )
            if chunk:
                self._controller_chunk = int(chunk)
                return self._controller_chunk
        if self.checkpoint_wall_interval is None:
            return self.checkpoint_every
        return self._adaptive_chunk

    def _cadence_lengths(self) -> int:
        """Distinct segment lengths a run can capture under this runner's
        cadence: the powers of two from 2 to ``checkpoint_every``, the
        configured ``checkpoint_every`` itself, and a run's ragged tail (a
        one-generation segment is a plain step and captures nothing)."""
        return self.checkpoint_every.bit_length() + 1

    def _adapt_chunk(self, chunk: int, seconds: float) -> None:
        """Steer the chunk length toward ``checkpoint_wall_interval``
        seconds per segment (EMA-smoothed per-generation execution time,
        capture excluded), quantized to powers of two so at most
        ``log2(checkpoint_every)`` distinct segment graphs are captured."""
        if self.checkpoint_wall_interval is None:
            return
        per_gen = max(seconds / max(chunk, 1), 1e-9)
        self._per_gen_ema = per_gen if self._per_gen_ema is None else 0.5 * self._per_gen_ema + 0.5 * per_gen
        target = self.checkpoint_wall_interval / self._per_gen_ema
        quantized = 1
        while quantized * 2 <= target and quantized * 2 <= self.checkpoint_every:
            quantized *= 2
        self._adaptive_chunk = quantized

    # -- the supervisor loop -----------------------------------------------
    def run(self, state: State, n_steps: int, *, fresh: bool = False) -> State:
        """Run ``n_steps`` total generations (``init_step`` + ``n_steps - 1``
        ``step``s, as ``StdWorkflow.run``), surviving transient failures.

        :param state: the initial workflow state — also the *template* a
            checkpoint must validate against when resuming.
        :param n_steps: total generations for the whole run (not the
            remainder): a resumed run passes the same ``n_steps``.
        :param fresh: start from ``state`` instead of resuming; existing
            checkpoints in the directory are DELETED first (quarantined
            ``*.corrupt`` files included).
        :returns: the final state, equal bit for bit to
            ``workflow.run(state, n_steps)``.  Any async checkpoint write is
            barriered before control returns.
        :raises Preempted: the :class:`PreemptionGuard` tripped; the
            emergency checkpoint is published and rerunning resumes it.
        :raises NotImplementedError: ``cpu_fallback=True`` with a sharded
            evaluation on the card.
        """
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self._restore_card_workflow()
        if self.cpu_fallback and _state_device(state).type == "cuda":
            from ..parallel import find_sharded

            sharded = find_sharded(getattr(self.workflow, "problem", None))
            if sharded is not None:
                raise NotImplementedError(
                    "ResilientRunner(cpu_fallback=True) with a ShardedProblem on the card is refused: a CPU twin "
                    "cannot join the mesh's process group while its other ranks stay on their cards; run without "
                    "cpu_fallback (the fleet supervisor restarts a failed rank) or build the workflow with "
                    "device='cpu'"
                )
        self.stats = RunStats()
        self._metric_cursor = {}
        self._forced_cpu = False
        self._key_impl = None
        self._reset_base_algorithm()
        self._resumed_probed = False
        self._adaptive_chunk = 1
        self._per_gen_ema = None
        # Controller cadence restarts from the configured chunk each run;
        # the controller itself (decisions, latches, quiet windows)
        # persists, as its journal does.
        self._controller_chunk = self.checkpoint_every
        if self.controller is not None and self.controller.cadence_enabled:
            reserve = getattr(self.workflow, "reserve_graphs", None)
            if reserve is not None:
                reserve(self._cadence_lengths())
        if self.health is not None:
            self.health.reset()
        installed_guard = False
        if self.preemption is not None:
            if self._owns_guard:
                self.preemption.reset()
            if not self.preemption.installed:
                self.preemption.install()
                installed_guard = True
        try:
            with self._span("run", n_steps=n_steps):
                return self._run_supervised(state, n_steps, fresh)
        finally:
            # The newest submitted checkpoint must be durably on disk by
            # the time control leaves the supervisor, and no writer thread
            # outlives the run (a daemon thread left at interpreter exit
            # can abort the process while it tears down).
            t0 = time.perf_counter()
            if self._writer is not None:
                with self._span("checkpoint-barrier"):
                    self._writer.stop()
            self.stats.checkpoint_block_seconds += time.perf_counter() - t0
            self._publish_metrics()
            if installed_guard:
                self.preemption.uninstall()

    def _boundary(self, state: State, done: int, host: dict, stepped: int) -> None:
        """The bookkeeping of a completed segment: checkpoint, timing,
        metrics, introspection, heartbeat (a subclass's hook also takes
        the segment's :meth:`_boundary_reads` from ``host["reads"]``)."""
        self.stats.segments_run += 1
        self.stats.completed_generations = done
        blocked0 = self.stats.checkpoint_block_seconds
        self._write_checkpoint(state, done)
        self._record_segment_timing(done, blocked0)
        self._publish_metrics(host.get("monitor"))
        self._publish_introspection(_state_device(state), stepped)
        self._beat(done)

    def _run_supervised(self, state: State, n_steps: int, fresh: bool) -> State:
        done = 0
        probed = False
        if fresh and self.primary and self.checkpoint_dir.is_dir():
            # Clear the old lineage (quarantined files too); the primary
            # alone (a fresh run reads nothing, so no rank races it).
            self._barrier_writer()
            for _, path in _numbered_checkpoints(self.checkpoint_dir):
                try:
                    self.store.unlink(path)
                except OSError:  # pragma: no cover - racing cleaners
                    pass
            for path in self.checkpoint_dir.glob("ckpt_*.npz.corrupt*"):
                try:
                    self.store.unlink(path)
                except OSError:  # pragma: no cover - racing cleaners
                    pass
        if not fresh:
            resumed = self.resume(state)
            if resumed is not None:
                state, done = resumed
                if done > n_steps:
                    raise ValueError(
                        f"checkpoint at generation {done} is beyond "
                        f"n_steps={n_steps}; pass fresh=True to restart or "
                        f"point at a different checkpoint_dir"
                    )
                self.stats.resumed_from_generation = done
                self.stats.completed_generations = done
                probed = self._resumed_probed
                # A supervisor watching a relaunched worker sees it land on
                # its resume point at once, not after a first segment.
                self._beat(done)
        self._run_key_impl(state)
        if done == 0:
            profile_ctx = (
                self.obs.maybe_profile(self.stats.segments_run) if self.obs is not None else contextlib.nullcontext()
            )
            with profile_ctx:
                state, host = self._attempt("init", state, 0, "init_step (generation 1)")
            done = 1
            self._boundary(state, done, host, 1)
            probed = False
        while True:
            # Preemption is checked at every boundary, BEFORE more work is
            # queued; a trip with no work left is ignored.
            if done < n_steps and self.preemption is not None and self.preemption.triggered:
                self._handle_preemption(state, done, probed)
            if not probed:
                state, done = self._health_boundary(state, done, n_steps)
                probed = True
            if done >= n_steps:
                break
            chunk = min(self._next_chunk(), n_steps - done)
            profile_ctx = (
                self.obs.maybe_profile(self.stats.segments_run) if self.obs is not None else contextlib.nullcontext()
            )
            with profile_ctx:
                result, host = self._attempt(
                    "segment", state, done, f"segment (generations {done + 1}..{done + chunk})", chunk=chunk
                )
            if self._is_fused("segment", chunk):
                state, stepped = self._consume_telemetry(result, host, done, chunk)
            else:
                state, stepped = result, chunk
            self._adapt_chunk(stepped, self._last_exec_seconds)
            done += stepped
            self.stats.chunk_sizes.append(stepped)
            self._boundary(state, done, host, stepped)
            probed = False
        return state

    def _record_segment_timing(self, done: int, blocked_before: float) -> None:
        self.stats.segment_timings.append(
            SegmentTiming(
                generation=done,
                compile_seconds=self._last_compile_seconds,
                execute_seconds=self._last_exec_seconds,
                checkpoint_block_seconds=self.stats.checkpoint_block_seconds - blocked_before,
            )
        )

    def _consume_telemetry(self, result, host: dict, done: int, chunk: int) -> tuple[State, int]:
        """Boundary-side handling of a fused segment's ``(state, telemetry)``
        result, from the scalars its attempt already read: the monitor's
        history flush (only for *successful* segments, so retries never
        duplicate entries), the flight recorder's rows and the early-stop
        accounting.  Returns ``(state, generations_actually_executed)``."""
        state, telemetry = result
        executed = host["executed"]
        with self._span("telemetry-flush", generation=done):
            # The generations executed as a host tensor: the flush then
            # reads nothing more from the card.
            self.workflow.flush_telemetry(telemetry.replace(executed=torch.tensor(executed, dtype=torch.int32)))
        if self.obs is not None and self.obs.flight is not None and host["flight"]:
            self.obs.flight.record_rows(host["flight"], executed, start_generation=done)
        if host["stopped"] and executed < chunk:
            self.stats.early_stops += 1
            self._event(
                f"fused segment stopped early at generation "
                f"{done + executed}: unhealthy state detected in-scan; the "
                f"remaining {chunk - executed} generation(s) of the "
                f"segment were frozen no-ops",
                warn=True,
                category="health",
                generation=done + executed,
                kind="early_stop",
                frozen_generations=chunk - executed,
            )
        return state, executed
