"""Fleet supervisor: survive host death, stragglers and fleet resizing
(counterpart of ``evox_tpu/resilience/fleet.py``: the same launch, watch,
stop, relaunch and shrink policy, events and :class:`FleetStats`).

The per-process :class:`~evox_tpu_torch.resilience.ResilientRunner`
survives what happens *inside* a process.  What it cannot survive is a
**peer** dying: a collective is all-or-nothing, so when one rank is
SIGKILLed every survivor fails in (or waits on) its next all-gather.  The
elastic resume means the *surviving* ranks are a good fleet: the
checkpointed state is global and the streams do not depend on the mesh, so
the run continues bit for bit at any world size.  A sticky CUDA error,
which leaves a process's CUDA context unusable, is answered the same way:
the process goes, and the fleet relaunches.

:class:`FleetSupervisor` is the external actor — a plain-Python process
(not a fleet member; it joins no process group) that:

1. **launches** N worker processes with a fresh coordinator address and
   the ``EVOX_TPU_FLEET_*`` environment contract
   (:func:`~evox_tpu_torch.parallel.bootstrap_fleet` consumes it);
2. **watches** worker exit codes and the heartbeat plane
   (:class:`~evox_tpu_torch.parallel.FleetHealth`) and renders per-host
   verdicts: **dead** (exit, stale beat), **wedged** (alive, frozen
   progress) and **slow** (self-reported eval-deadline trips);
3. **stops the survivors** on any unhealthy verdict: SIGTERM first (the
   workers' :class:`~evox_tpu_torch.resilience.PreemptionGuard` turns it
   into a graceful boundary stop with an emergency checkpoint), SIGKILL
   after a grace window;
4. **relaunches** on the surviving process count; the workers' runners
   resume from the shared checkpoint directory on the smaller world.

The supervisor does not know *what* the workers compute: the ``command``
callable maps a :class:`WorkerSpec` to an argv.  Worker contract: exit
``0`` on completion; any other exit (or silence on the heartbeat plane) is
a failure verdict.  Exit code ``75`` (``EX_TEMPFAIL``, "preempted, resume
me") acknowledges a graceful stop; the supervisor expects it during a
shutdown it started, and counts it as a failure otherwise.
"""

from __future__ import annotations

import os
import socket
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping, Sequence, Union

from ..obs.aggregate import FleetAggregator
from ..obs.endpoint import IntrospectionEndpoint
from ..obs.plane import Observability, resolve_obs
from ..parallel.multihost import (
    FLEET_ENV_ATTEMPT,
    FLEET_ENV_COORDINATOR,
    FLEET_ENV_HEARTBEAT_DIR,
    FLEET_ENV_NUM_PROCESSES,
    FLEET_ENV_PROCESS_ID,
    FleetHealth,
    FleetReport,
)

__all__ = [
    "FleetSupervisor",
    "FleetError",
    "FleetStats",
    "WorkerSpec",
    "EX_PREEMPTED",
    "free_coordinator_port",
]

# The conventional "temporarily failed, try again" exit code (sysexits.h
# EX_TEMPFAIL): a worker that was asked to stop (SIGTERM -> Preempted ->
# emergency checkpoint) exits with this to say "resumable, not broken".
EX_PREEMPTED = 75


class FleetError(RuntimeError):
    """The fleet could not be driven to completion: the relaunch budget is
    spent, the world shrank below ``min_processes``, or an attempt blew its
    wall-clock timeout.  ``stats`` carries the full event history."""

    def __init__(self, message: str, stats: "FleetStats | None" = None):
        super().__init__(message)
        self.stats = stats


def free_coordinator_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port for the fleet coordinator.  Raises
    ``OSError`` where binding is impossible — callers (and the test lane)
    use that to skip cleanly on machines without loopback networking."""
    with socket.socket() as s:
        s.bind((host, 0))
        return int(s.getsockname()[1])


@dataclass(frozen=True)
class WorkerSpec:
    """Everything one worker process needs to join its fleet attempt."""

    process_id: int
    num_processes: int
    coordinator: str
    attempt: int
    heartbeat_dir: str
    checkpoint_dir: str

    def env(self) -> dict[str, str]:
        """The ``EVOX_TPU_FLEET_*`` environment contract
        :func:`~evox_tpu_torch.parallel.bootstrap_fleet` consumes."""
        return {
            FLEET_ENV_COORDINATOR: self.coordinator,
            FLEET_ENV_NUM_PROCESSES: str(self.num_processes),
            FLEET_ENV_PROCESS_ID: str(self.process_id),
            FLEET_ENV_HEARTBEAT_DIR: self.heartbeat_dir,
            FLEET_ENV_ATTEMPT: str(self.attempt),
        }


@dataclass
class FleetEvent:
    """One supervisor decision, for the post-mortem record."""

    attempt: int
    kind: str  # launch | host-death | wedged | straggler | relaunch | complete | stop
    detail: str


@dataclass
class FleetStats:
    """Observable record of what the supervisor did during :meth:`run`."""

    attempts: int = 0
    completed: bool = False
    world_sizes: list[int] = field(default_factory=list)
    removed_hosts: list[tuple[int, int, str]] = field(default_factory=list)
    host_deaths: int = 0
    hosts_quarantined: int = 0
    events: list[FleetEvent] = field(default_factory=list)
    exit_codes: list[dict[int, int | None]] = field(default_factory=list)
    last_report: FleetReport | None = None

    @property
    def final_world_size(self) -> int | None:
        return self.world_sizes[-1] if self.world_sizes else None


class _PopenWorker:
    """Default worker handle: a subprocess with its output teed to a log
    file under the heartbeat directory (the supervisor's flight recorder)."""

    def __init__(self, argv: Sequence[str], env: Mapping[str, str], log: Path):
        # A live subprocess stdout/stderr sink cannot be staged-and-renamed:
        # the OS writes into it for the worker's whole lifetime.  Loss past
        # the last flush on a crash is acceptable flight-recorder semantics.
        self._log = open(log, "wb")
        self.proc = subprocess.Popen(
            list(argv), env=dict(env), stdout=self._log, stderr=self._log
        )

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> int | None:
        rc = self.proc.poll()
        if rc is not None and not self._log.closed:
            self._log.close()
        return rc

    def terminate(self) -> None:
        try:
            self.proc.terminate()
        except OSError:  # pragma: no cover - already gone
            pass

    def kill(self) -> None:
        try:
            self.proc.kill()
        except OSError:  # pragma: no cover - already gone
            pass

    def wait(self, timeout: float | None = None) -> int | None:
        try:
            rc = self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None
        if not self._log.closed:
            self._log.close()
        return rc


def _default_spawn(
    argv: Sequence[str], env: Mapping[str, str], spec: WorkerSpec
) -> _PopenWorker:
    log = Path(spec.heartbeat_dir) / (
        f"worker_a{spec.attempt:02d}_p{spec.process_id:02d}.log"
    )
    log.parent.mkdir(parents=True, exist_ok=True)
    return _PopenWorker(argv, env, log)


class FleetSupervisor:
    """Launch, watch, shrink, and relaunch a ``torch.distributed`` fleet.

    Usage::

        def command(spec):                       # argv for one worker
            return [sys.executable, "worker.py"]

        sup = FleetSupervisor(
            command, num_processes=4,
            checkpoint_dir="ckpts/run1",
            dead_after=5.0, eval_deadline=2.0,
        )
        stats = sup.run()       # survives host death; FleetError when not

    The worker script calls ``bootstrap_fleet()`` (which reads the
    environment this supervisor publishes), runs its
    :class:`~evox_tpu_torch.resilience.ResilientRunner` against the shared
    ``checkpoint_dir`` with a
    :class:`~evox_tpu_torch.parallel.HostHeartbeat` pointed at
    ``heartbeat_dir``, and exits 0 — ``tests/test_torch_fleet_worker.py``
    is a complete worker.

    Degenerate path: ``num_processes=1`` supervises a single worker with
    no coordinator (``WorkerSpec.coordinator`` is empty, so
    ``bootstrap_fleet`` no-ops) — the same script runs fleet-less, and the
    supervisor still provides crash-relaunch supervision.
    """

    def __init__(
        self,
        command: Callable[[WorkerSpec], Sequence[str]],
        num_processes: int,
        *,
        checkpoint_dir: Union[str, Path],
        heartbeat_dir: Union[str, Path, None] = None,
        coordinator_host: str = "127.0.0.1",
        env: Mapping[str, str] | None = None,
        poll_interval: float = 0.2,
        dead_after: float = 5.0,
        stall_after: float | None = None,
        eval_deadline: float | None = None,
        start_grace: float = 120.0,
        grace_seconds: float = 10.0,
        min_processes: int = 1,
        max_relaunches: int = 4,
        attempt_timeout: float | None = None,
        on_event: Callable[[str], None] | None = None,
        spawn: Callable[..., Any] | None = None,
        obs: Union["Observability", bool, None] = None,
        endpoint: Union[int, bool, None] = None,
        endpoint_host: str = "127.0.0.1",
        healthz_url: str | None = None,
        healthz_timeout: float = 2.0,
    ):
        """
        :param command: maps a :class:`WorkerSpec` to the argv of one
            worker process.  The spec's environment contract is published
            *in addition* to ``env`` — most commands are therefore just
            ``lambda spec: [sys.executable, "worker.py"]``.
        :param num_processes: initial world size.
        :param checkpoint_dir: the fleet's shared checkpoint directory
            (single-writer: worker 0 publishes, everyone resumes from it).
        :param heartbeat_dir: where workers publish
            :class:`~evox_tpu_torch.parallel.HostHeartbeat` beats and the
            supervisor writes per-worker logs; defaults to
            ``<checkpoint_dir>/heartbeats``.
        :param coordinator_host: address workers rendezvous on; each
            attempt binds a fresh OS-assigned port.
        :param env: base environment for workers (default: inherit the
            supervisor's).  Per-worker fleet variables are layered on top.
        :param poll_interval: supervisor wake-up period.
        :param dead_after: heartbeat staleness (seconds) before a host is
            declared dead (see :class:`~evox_tpu_torch.parallel.FleetHealth`).
        :param stall_after: seconds of frozen generation progress before a
            host is declared wedged; ``None`` disables (exit codes still
            catch outright deaths).
        :param eval_deadline: per-host deadline verdict threshold —
            heartbeats reporting ``deadline_trips`` (or segment seconds
            above this) mark the host slow, and the supervisor quarantines
            it at the next stop: the relaunched world excludes it.
        :param start_grace: seconds a freshly-launched attempt may take to
            produce first heartbeats (bootstrap + first compile).
        :param grace_seconds: SIGTERM-to-SIGKILL escalation window when
            stopping survivors.  Workers reachable at a segment boundary
            stop gracefully (emergency checkpoint) inside it; workers
            wedged in a dead collective are SIGKILLed after it — their
            last boundary checkpoint is already durable.
        :param min_processes: smallest world the run may shrink to; going
            below raises :class:`FleetError`.
        :param max_relaunches: relaunch budget; exhausting it raises
            :class:`FleetError`.
        :param attempt_timeout: optional wall-clock budget per attempt —
            a deadlocked fleet becomes a loud :class:`FleetError`, never
            a silent hang.
        :param on_event: optional sink for one human-readable line per
            supervisor decision.
        :param spawn: worker factory ``(argv, env, spec) -> handle`` with
            ``poll/terminate/kill/wait/pid`` — injectable so the
            supervisor's decision logic is unit-testable without real
            subprocesses; defaults to ``subprocess.Popen`` with logs under
            ``heartbeat_dir``.
        :param obs: the :class:`~evox_tpu_torch.obs.Observability` plane: every
            supervisor decision (``launch``/``host-death``/``wedged``/
            ``straggler``/``fleet-stall``/``relaunch``/``complete``)
            publishes a structured ``fleet`` event alongside the legacy
            ``on_event`` string, and ``evox_fleet_*`` metrics (attempts,
            host deaths, quarantines, world size) feed the plane's
            registry.  ``None`` builds a default plane; ``False``
            disables instrumentation.
        :param endpoint: arm the supervisor's own introspection endpoint
            (:class:`~evox_tpu_torch.obs.IntrospectionEndpoint`, serving for
            the duration of :meth:`run`): an ``int`` binds that port,
            ``True`` an OS-assigned one.  ``/metrics`` is the
            fleet-aggregated view — every worker's heartbeat metrics
            merged by a :class:`~evox_tpu_torch.obs.FleetAggregator` into the
            supervisor's registry (counters summed relaunch-monotone,
            gauges per ``process_index``, dead hosts ``stale="true"``) —
            ``/healthz`` renders the live per-host verdicts (non-200 on
            dead/wedged/slow), ``/statusz`` the supervision record.
        :param endpoint_host: endpoint bind address (default loopback).
        :param healthz_url: optional external ``/healthz`` to CONSUME:
            each watch poll GETs it, and a non-200 response's
            ``dead``/``wedged``/``slow`` host lists merge into this
            supervisor's own verdicts — the seam that lets a daemon's
            (or any sidecar's) health view drive supervision.
            Unreachable endpoints warn once and are ignored: losing the
            health sidecar must never take down the fleet it watches.
        :param healthz_timeout: per-poll timeout for ``healthz_url``.
        """
        if num_processes < 1:
            raise ValueError(
                f"num_processes must be >= 1, got {num_processes}"
            )
        if min_processes < 1:
            raise ValueError(f"min_processes must be >= 1, got {min_processes}")
        if min_processes > num_processes:
            raise ValueError(
                f"min_processes ({min_processes}) cannot exceed "
                f"num_processes ({num_processes})"
            )
        if max_relaunches < 0:
            raise ValueError(
                f"max_relaunches must be >= 0, got {max_relaunches}"
            )
        self.command = command
        self.num_processes = int(num_processes)
        self.checkpoint_dir = Path(checkpoint_dir)
        self.heartbeat_dir = (
            Path(heartbeat_dir)
            if heartbeat_dir is not None
            else self.checkpoint_dir / "heartbeats"
        )
        self.coordinator_host = str(coordinator_host)
        self.env = dict(env) if env is not None else dict(os.environ)
        self.poll_interval = float(poll_interval)
        self.dead_after = float(dead_after)
        self.stall_after = None if stall_after is None else float(stall_after)
        self.eval_deadline = (
            None if eval_deadline is None else float(eval_deadline)
        )
        self.start_grace = float(start_grace)
        self.grace_seconds = float(grace_seconds)
        self.min_processes = int(min_processes)
        self.max_relaunches = int(max_relaunches)
        self.attempt_timeout = (
            None if attempt_timeout is None else float(attempt_timeout)
        )
        self.on_event = on_event
        self.spawn = spawn if spawn is not None else _default_spawn
        self.obs = resolve_obs(obs, run_id=Path(checkpoint_dir).name)
        self._metric_cursor: dict[str, float] = {}
        self.stats = FleetStats()
        self.healthz_url = healthz_url
        self.healthz_timeout = float(healthz_timeout)
        self._healthz_warned = False
        # Fleet aggregation merges INTO the supervisor's registry (one
        # scrape = supervisor series + every host's), safe because the
        # supervisor never publishes the host-side series names itself.
        self.aggregator = FleetAggregator(
            registry=self.obs.registry if self.obs is not None else None
        )
        self._health: FleetHealth | None = None
        self.endpoint: IntrospectionEndpoint | None = None
        if endpoint is not None and endpoint is not False:
            self.endpoint = IntrospectionEndpoint(
                metrics=self._metrics_text,
                healthz=self._healthz,
                statusz=self._statusz,
                instrument=(
                    self.obs.registry if self.obs is not None else None
                ),
                host=endpoint_host,
                port=0 if endpoint is True else int(endpoint),
            )

    # -- events --------------------------------------------------------------
    # Supervisor decisions that mean something broke vs routine lifecycle.
    _WARN_KINDS = (
        "host-death",
        "wedged",
        "straggler",
        "fleet-stall",
        "stop",
        "healthz-unreachable",
    )

    def _event(self, attempt: int, kind: str, detail: str) -> None:
        self.stats.events.append(FleetEvent(attempt, kind, detail))
        if self.obs is not None:
            self.obs.event(
                "fleet",
                f"[fleet attempt {attempt}] {kind}: {detail}",
                severity="warning" if kind in self._WARN_KINDS else "info",
                attempt=attempt,
                kind=kind,
            )
            self.obs.counter(
                "evox_fleet_events_total",
                "Fleet supervisor decisions by kind.",
                kind=kind,
            ).inc()
            self._publish_metrics()
        if self.on_event is not None:
            self.on_event(f"[fleet attempt {attempt}] {kind}: {detail}")

    def _publish_metrics(self) -> None:
        """Sync FleetStats into the registry (delta-published against a
        cursor that resets with the stats, like the runner's — one shared
        ``counter_sync`` definition)."""
        s = self.stats
        for name, value, help in (
            ("evox_fleet_attempts_total", s.attempts, "Fleet attempts launched."),
            ("evox_fleet_host_deaths_total", s.host_deaths, "Workers lost to exits or stale heartbeats."),
            (
                "evox_fleet_quarantines_total",
                s.hosts_quarantined,
                "Hosts quarantined as slow/wedged (culprit-less stalls included).",
            ),
            (
                "evox_fleet_removed_hosts_total",
                len(s.removed_hosts),
                "Hosts removed from the fleet across attempts.",
            ),
        ):
            self.obs.registry.counter_sync(
                self._metric_cursor, name, value, help
            )
        if s.world_sizes:
            self.obs.gauge(
                "evox_fleet_world_size",
                "Process count of the current fleet attempt.",
            ).set(s.world_sizes[-1])

    # -- introspection (read-only providers + the consumed sidecar) ----------
    def _metrics_text(self) -> str:
        """The fleet-aggregated Prometheus text: fold the current beats
        (with the live attempt's verdicts for staleness) into the
        aggregator, then export.  Endpoint handler thread only."""
        from ..parallel.multihost import read_heartbeats

        beats = read_heartbeats(self.heartbeat_dir)
        report = self._health.check() if self._health is not None else None
        self.aggregator.update(beats, report)
        return self.aggregator.to_prometheus()

    def _healthz(self) -> tuple[bool, dict[str, Any]]:
        payload: dict[str, Any] = {
            "attempt": max(0, self.stats.attempts - 1),
            "world_size": self.stats.final_world_size,
            "completed": self.stats.completed,
        }
        if self._health is None:
            return True, payload
        report = self._health.check()
        payload.update(report.to_json())
        return report.healthy, payload

    def _statusz(self) -> dict[str, Any]:
        s = self.stats
        return {
            "attempts": s.attempts,
            "completed": s.completed,
            "world_sizes": list(s.world_sizes),
            "host_deaths": s.host_deaths,
            "hosts_quarantined": s.hosts_quarantined,
            "removed_hosts": [list(r) for r in s.removed_hosts],
            "events": [
                {"attempt": e.attempt, "kind": e.kind, "detail": e.detail}
                for e in list(s.events)[-50:]
            ],
        }

    def _poll_healthz(self) -> dict[str, Any] | None:
        """GET the consumed ``healthz_url``; returns its JSON body (from
        a 200 or a 503 — the 503 body carries the verdicts) or ``None``
        when unreachable/unparseable (warned once: the sidecar dying must
        never fail the fleet)."""
        import urllib.error
        import urllib.request

        try:
            try:
                resp = urllib.request.urlopen(
                    self.healthz_url, timeout=self.healthz_timeout
                )
                body, status = resp.read(), resp.status
            except urllib.error.HTTPError as e:
                body, status = e.read(), e.code
            import json

            out = dict(json.loads(body))
            out["status"] = int(status)
            return out
        except Exception as e:  # noqa: BLE001 - observation must not kill
            if not self._healthz_warned:
                self._healthz_warned = True
                self._event(
                    max(0, self.stats.attempts - 1),
                    "healthz-unreachable",
                    f"consumed healthz {self.healthz_url} failed "
                    f"({type(e).__name__}: {e}); continuing on heartbeat "
                    f"verdicts alone",
                )
            return None

    def _remote_verdicts(self) -> dict[int, str]:
        """Hosts the consumed ``/healthz`` names unhealthy, as
        ``{process_index: verdict kind}`` — empty when the endpoint is
        healthy, unarmed, or unreachable."""
        if self.healthz_url is None:
            return {}
        body = self._poll_healthz()
        if body is None or body.get("status") == 200:
            return {}
        out: dict[int, str] = {}
        for key, kind in (
            ("dead", "host-death"),
            ("wedged", "wedged"),
            ("slow", "straggler"),
        ):
            for host in body.get(key, ()) or ():
                try:
                    out.setdefault(int(host), kind)
                except (TypeError, ValueError):
                    continue
        return out

    # -- world planning ------------------------------------------------------
    def plan_relaunch(self, world: int, removed: set[int]) -> int:
        """Next world size after removing ``removed`` hosts from a
        ``world``-sized attempt.  At least one host is always charged (a
        stop with no identified culprit still shrinks by one — *something*
        broke the attempt, and relaunching at the same size against a
        hardware fault loops forever).  Raises :class:`FleetError` when
        the survivors fall below ``min_processes``."""
        next_world = world - max(1, len(removed))
        if next_world < self.min_processes:
            raise FleetError(
                f"fleet shrank below min_processes={self.min_processes}: "
                f"{world} host(s) minus {max(1, len(removed))} removed",
                self.stats,
            )
        return next_world

    def _specs(self, world: int, attempt: int, port: int) -> list[WorkerSpec]:
        coordinator = (
            f"{self.coordinator_host}:{port}" if world > 1 else ""
        )
        return [
            WorkerSpec(
                process_id=i,
                num_processes=world,
                coordinator=coordinator,
                attempt=attempt,
                heartbeat_dir=str(self.heartbeat_dir),
                checkpoint_dir=str(self.checkpoint_dir),
            )
            for i in range(world)
        ]

    # -- attempt lifecycle ---------------------------------------------------
    def _clear_heartbeats(self) -> None:
        """Drop the previous attempt's beats: a stale fresh-looking beat
        from a removed host must not feed this attempt's verdicts."""
        if self.heartbeat_dir.is_dir():
            for path in self.heartbeat_dir.glob("host_*.json"):
                try:
                    path.unlink()
                except OSError:  # pragma: no cover - racing cleaners
                    pass
        self.heartbeat_dir.mkdir(parents=True, exist_ok=True)

    def _launch(self, world: int, attempt: int) -> tuple[list[Any], list[WorkerSpec]]:
        port = free_coordinator_port(self.coordinator_host) if world > 1 else 0
        self._clear_heartbeats()
        specs = self._specs(world, attempt, port)
        workers = []
        for spec in specs:
            env = dict(self.env)
            env.update(spec.env())
            workers.append(self.spawn(self.command(spec), env, spec))
        self._event(
            attempt,
            "launch",
            f"{world} worker(s), coordinator "
            f"{specs[0].coordinator or '(none: single process)'}",
        )
        return workers, specs

    def _stop_attempt(
        self, workers: list[Any], attempt: int
    ) -> dict[int, int | None]:
        """SIGTERM every live worker, escalate to SIGKILL after the grace
        window, reap everything; returns {process_id: exit code}."""
        live = [i for i, w in enumerate(workers) if w.poll() is None]
        if live:
            self._event(
                attempt,
                "stop",
                f"terminating worker(s) {live} (grace "
                f"{self.grace_seconds:.1f}s, then SIGKILL)",
            )
        for i in live:
            workers[i].terminate()
        deadline = time.monotonic() + self.grace_seconds
        for i in live:
            remaining = max(0.0, deadline - time.monotonic())
            if workers[i].wait(remaining) is None:
                workers[i].kill()
                workers[i].wait(self.grace_seconds)
        codes = {i: w.poll() for i, w in enumerate(workers)}
        self.stats.exit_codes.append(codes)
        return codes

    def _watch(
        self, workers: list[Any], health: FleetHealth, attempt: int
    ) -> set[int] | None:
        """Watch one attempt until it completes (returns ``None``) or a
        verdict fails it (returns the hosts to remove — possibly empty:
        a whole-fleet stall with no identifiable culprit, which
        :meth:`plan_relaunch` charges one host for).  Raises
        :class:`FleetError` on the attempt timeout."""
        deadline = (
            time.monotonic() + self.attempt_timeout
            if self.attempt_timeout is not None
            else None
        )
        while True:
            codes = {i: w.poll() for i, w in enumerate(workers)}
            failed = {
                i
                for i, rc in codes.items()
                if rc is not None and rc not in (0, EX_PREEMPTED)
            }
            if failed:
                self.stats.host_deaths += len(failed)
                detail = ", ".join(
                    f"worker {i} rc={codes[i]}" for i in sorted(failed)
                )
                self._event(attempt, "host-death", detail)
                for i in sorted(failed):
                    self.stats.removed_hosts.append(
                        (attempt, i, f"exited rc={codes[i]}")
                    )
                return failed
            spontaneous_preempt = {
                i for i, rc in codes.items() if rc == EX_PREEMPTED
            }
            if spontaneous_preempt:
                # A worker stopped "gracefully" without being asked (an
                # injected SIGTERM, an external scheduler): resumable, but
                # this attempt cannot complete — restart at the SAME world
                # size minus nothing... except plan_relaunch always charges
                # one host; treat the preempted worker as the removal so
                # the accounting stays honest.
                detail = ", ".join(
                    f"worker {i} preempted (rc={EX_PREEMPTED})"
                    for i in sorted(spontaneous_preempt)
                )
                self._event(attempt, "host-death", detail)
                for i in sorted(spontaneous_preempt):
                    self.stats.removed_hosts.append(
                        (attempt, i, "preempted externally")
                    )
                return spontaneous_preempt
            if all(rc == 0 for rc in codes.values()):
                # The finally-side _stop_attempt records the exit codes.
                return None
            report = health.check()
            self.stats.last_report = report
            bad = set(report.unhealthy_hosts)
            # Exit-code truth beats heartbeat inference: a worker that
            # already exited 0 is complete, not dead, however stale its
            # final beat looks by now.
            bad -= {i for i, rc in codes.items() if rc == 0}
            # The consumed /healthz sidecar's verdicts merge in under the
            # same exit-code rule (hosts outside this attempt's world are
            # ignored — a stale sidecar must not remove a host twice).
            remote = {
                h: k
                for h, k in self._remote_verdicts().items()
                if 0 <= h < len(workers) and codes.get(h) != 0 and h not in bad
            }
            bad |= set(remote)
            live = {i for i, rc in codes.items() if rc is None}
            if (
                bad
                and live
                and set(report.wedged_hosts) >= live
                and not report.dead_hosts
                and not report.slow_hosts
            ):
                # EVERY live host reads as wedged: one stuck host stalls
                # all its peers' collectives, so a whole-fleet wedge
                # cannot name its culprit from the outside.  Stop the
                # fleet and shrink by one (plan_relaunch charges a host
                # for culprit-less stops); precise removal is reserved
                # for the verdicts that ARE per-host attributable (exit
                # codes, stale beats, self-reported deadline trips).
                self._event(
                    attempt,
                    "fleet-stall",
                    f"all {len(live)} live host(s) wedged "
                    f"({'; '.join(report.reasons[:2])}); culprit ambiguous "
                    f"— relaunching one host smaller",
                )
                self.stats.hosts_quarantined += 1
                return set()
            if bad:
                for i in sorted(bad):
                    v = report.verdicts.get(i)
                    if i in remote:
                        kind = remote[i]
                        reason = (
                            f"consumed healthz {self.healthz_url} named "
                            f"host {i} {kind}"
                        )
                    else:
                        reason = (
                            "; ".join(v.reasons)
                            if v is not None
                            else "unhealthy"
                        )
                        kind = (
                            "straggler"
                            if v is not None
                            and v.slow
                            and not (v.dead or v.wedged)
                            else (
                                "wedged"
                                if v is not None and v.wedged
                                else "host-death"
                            )
                        )
                    if kind == "straggler":
                        self.stats.hosts_quarantined += 1
                    elif kind == "wedged":
                        self.stats.hosts_quarantined += 1
                    else:
                        self.stats.host_deaths += 1
                    self._event(attempt, kind, reason)
                    self.stats.removed_hosts.append((attempt, i, reason))
                return bad
            if deadline is not None and time.monotonic() > deadline:
                # run()'s finally tears the workers down.
                raise FleetError(
                    f"attempt {attempt} exceeded its "
                    f"{self.attempt_timeout:.1f}s wall-clock budget with no "
                    f"verdict — treating the fleet as deadlocked",
                    self.stats,
                )
            time.sleep(self.poll_interval)

    # -- the supervisor loop -------------------------------------------------
    def run(self) -> FleetStats:
        """Drive the fleet to completion, shrinking on failures.

        Returns the :class:`FleetStats` of the successful run; raises
        :class:`FleetError` when the relaunch budget or ``min_processes``
        floor is hit (the stats ride on the exception)."""
        self.stats = FleetStats()
        self._metric_cursor = {}
        world = self.num_processes
        attempt = 0
        if self.endpoint is not None and not self.endpoint.started:
            self.endpoint.start()
            self._event(
                0,
                "endpoint",
                f"introspection serving at {self.endpoint.url} "
                f"(/metrics /healthz /statusz)",
            )
        try:
            while True:
                self.stats.attempts = attempt + 1
                self.stats.world_sizes.append(world)
                health = FleetHealth(
                    self.heartbeat_dir,
                    world,
                    dead_after=self.dead_after,
                    stall_after=self.stall_after,
                    eval_deadline=self.eval_deadline,
                    start_grace=self.start_grace,
                )
                # The endpoint's /healthz and /metrics staleness render
                # through the live attempt's verdict configuration.
                self._health = health
                workers, _specs = self._launch(world, attempt)
                try:
                    removed = self._watch(workers, health, attempt)
                finally:
                    # Whatever happened, never leak live workers past the
                    # attempt: completion leaves nothing to stop, every
                    # other path must tear the fleet down before
                    # relaunch/raise.
                    self._stop_attempt(workers, attempt)
                if removed is None:
                    self._event(
                        attempt, "complete", f"all {world} worker(s) exited 0"
                    )
                    self.stats.completed = True
                    # One final fold WITHOUT a staleness report: the
                    # workers exited 0, so their last beats are final
                    # totals to absorb, not dead hosts to mark — a
                    # post-run scrape of the supervisor registry then
                    # holds the fleet's complete counters.
                    from ..parallel.multihost import read_heartbeats

                    self.aggregator.update(
                        read_heartbeats(self.heartbeat_dir)
                    )
                    return self.stats
                next_world = self.plan_relaunch(world, removed)
                if attempt + 1 > self.max_relaunches:
                    raise FleetError(
                        f"relaunch budget of {self.max_relaunches} spent "
                        f"after attempt {attempt} removed host(s) "
                        f"{sorted(removed)}",
                        self.stats,
                    )
                self._event(
                    attempt,
                    "relaunch",
                    f"resuming on {next_world} surviving host(s) "
                    f"(was {world}; removed {sorted(removed)})",
                )
                world = next_world
                attempt += 1
        finally:
            if self.endpoint is not None:
                self.endpoint.stop()
