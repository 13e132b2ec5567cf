"""Multi-host fleet infrastructure: bootstrap, topology, heartbeats, verdicts
(counterpart of ``evox_tpu/parallel/multihost.py``).

The reference's multi-host story is ``torchrun`` + ``init_process_group``
over a **fixed, healthy world**: the process count is baked in at launch,
no component asks whether a peer is still alive, and one dead rank aborts
the job.  This module supplies the host-level layer for fleets whose
processes die, straggle and get relaunched mid-run:

* :func:`bootstrap_fleet` — the one call a worker process makes before it
  builds a mesh: it reads its arguments from the ``EVOX_TPU_FLEET_*``
  environment contract a :class:`~evox_tpu_torch.resilience.FleetSupervisor`
  publishes, joins the process group through
  :func:`~evox_tpu_torch.parallel.init_multi_host`, and **no-ops for
  single-process runs**.
* :class:`FleetTopology` — :class:`~evox_tpu_torch.resilience.MeshTopology`
  extended with the process-level world: ``process_index`` (the
  ``torch.distributed`` rank), ``coordinator`` address and the relaunch
  ``attempt``; its manifest entries carry the JAX package's keys, so a
  manifest of either package loads in the other.
* :class:`HostHeartbeat` / :func:`read_heartbeats` — per-host liveness
  files (the JAX package's JSON beats, file names and keys): each worker
  publishes an atomically replaced beat (wall clock, generation, segment
  seconds, extra payload) that a supervisor on a shared file system reads
  without any collective — what is needed when the collective itself is
  what is stuck.
* :class:`FleetHealth` / :class:`HostVerdict` / :class:`FleetReport` — per
  host the verdict is **dead** (beat stale), **wedged** (beats fresh but
  generation frozen) or **slow** (self-reported eval-deadline trips, or a
  segment over the deadline).
* :func:`is_primary` — the fleet's **single-writer** rule: rank 0 owns
  every mutating checkpoint-directory operation; every other rank is
  read-only (:class:`~evox_tpu_torch.utils.ReadOnlyCheckpointStore`).
* :func:`fleet_barrier` — the collective the resilient runner needs
  where the primary's checkpoint directory is read fleet-wide;
  :func:`gather_replicated` keeps the JAX package's boundary gather, the
  identity in the port.

Determinism: none of this changes a computed value.  The heartbeat and
verdict plane is observational (files, wall clocks), and the only
collective is a barrier, so the elastic resume across mesh sizes
(:mod:`evox_tpu_torch.resilience.elastic`) holds across process counts.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping, Union

import torch
import torch.distributed as dist

from .. import resolve_device
from ..resilience.elastic import MeshTopology, _num_processes
from .mesh import init_multi_host

__all__ = [
    "FleetTopology",
    "bootstrap_fleet",
    "is_primary",
    "fleet_barrier",
    "gather_replicated",
    "HostHeartbeat",
    "read_heartbeats",
    "HostVerdict",
    "FleetReport",
    "FleetHealth",
    "FLEET_ENV_COORDINATOR",
    "FLEET_ENV_NUM_PROCESSES",
    "FLEET_ENV_PROCESS_ID",
    "FLEET_ENV_HEARTBEAT_DIR",
    "FLEET_ENV_ATTEMPT",
]

# The environment contract between a FleetSupervisor and its workers (the
# JAX package's names): the supervisor publishes these, bootstrap_fleet()
# consumes them.  Explicit arguments win over the environment.
FLEET_ENV_COORDINATOR = "EVOX_TPU_FLEET_COORDINATOR"
FLEET_ENV_NUM_PROCESSES = "EVOX_TPU_FLEET_NUM_PROCESSES"
FLEET_ENV_PROCESS_ID = "EVOX_TPU_FLEET_PROCESS_ID"
FLEET_ENV_HEARTBEAT_DIR = "EVOX_TPU_FLEET_HEARTBEAT_DIR"
FLEET_ENV_ATTEMPT = "EVOX_TPU_FLEET_ATTEMPT"

_HEARTBEAT_PREFIX = "host_"


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _joined() else 0


@dataclass(frozen=True)
class FleetTopology(MeshTopology):
    """The process-level world of a fleet run.

    Extends :class:`~evox_tpu_torch.resilience.MeshTopology` (whose
    ``num_processes`` it shares) with the identity of *this* process: its
    ``process_index`` (the ``torch.distributed`` rank), the
    ``coordinator`` address the fleet met on and the supervisor relaunch
    ``attempt`` it belongs to.  :meth:`from_manifest` on a plain
    :class:`MeshTopology` entry yields the single-process defaults, so
    pre-fleet checkpoints keep loading."""

    process_index: int = 0
    coordinator: str = ""
    attempt: int = 0

    # -- constructors --------------------------------------------------------
    @classmethod
    def current(
        cls, coordinator: str = "", attempt: int = 0, device: str | torch.device | None = None
    ) -> "FleetTopology":
        """The fleet topology of this (already joined) process: the
        ``torch.distributed`` rank and world size (0 and 1 without a
        group) and ``device``'s kind (default: the first card where CUDA
        is available, else the CPU)."""
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        dev = resolve_device(device)
        if dev.type == "cuda":
            kind, platform, count = torch.cuda.get_device_name(dev), "gpu", torch.cuda.device_count()
        else:
            kind, platform, count = "cpu", "cpu", 1
        return cls(
            axis_names=(),
            axis_sizes=(),
            device_kind=kind,
            platform=platform,
            num_devices=int(count),
            num_processes=_num_processes(),
            process_index=_rank(),
            coordinator=str(coordinator),
            attempt=int(attempt),
        )

    @classmethod
    def single_process(cls) -> "FleetTopology":
        """The degenerate world of a process that joined no fleet — what
        :func:`bootstrap_fleet` returns when there is no fleet to join.
        Touches no CUDA API: the no-op path is safe to call first."""
        return cls(
            axis_names=(),
            axis_sizes=(),
            device_kind="unknown",
            platform="unknown",
            num_devices=0,
            num_processes=1,
            process_index=0,
            coordinator="",
            attempt=0,
        )

    @classmethod
    def from_manifest(cls, entry: Mapping[str, Any]) -> "FleetTopology":
        base = MeshTopology.from_manifest(entry)
        return cls(
            **{k: getattr(base, k) for k in base.__dataclass_fields__},
            process_index=int(entry.get("process_index", 0)),
            coordinator=str(entry.get("coordinator", "")),
            attempt=int(entry.get("attempt", 0)),
        )

    # -- queries -------------------------------------------------------------
    @property
    def primary(self) -> bool:
        """Whether this process holds the fleet's single-writer role."""
        return self.process_index == 0

    def describe(self) -> str:
        base = super().describe()
        if self.num_processes <= 1:
            return base
        return f"{base}; process {self.process_index}/{self.num_processes}" + (
            f" via {self.coordinator}" if self.coordinator else ""
        )

    # -- manifest round trip -------------------------------------------------
    def to_manifest(self) -> dict[str, Any]:
        out = super().to_manifest()
        out.update(process_index=self.process_index, coordinator=self.coordinator, attempt=self.attempt)
        return out


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else None


def bootstrap_fleet(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    auto: bool = False,
    initialization_timeout: float | None = None,
    key_impl: str | None = None,
    device: str | torch.device | None = None,
) -> FleetTopology:
    """Join (or skip joining) the fleet's process group.  Call once per
    worker process, before building a mesh.

    Arguments default to the ``EVOX_TPU_FLEET_*`` environment contract a
    :class:`~evox_tpu_torch.resilience.FleetSupervisor` publishes, so a
    worker's whole bootstrap is ``topology = bootstrap_fleet()``.  With no
    supervisor, ``auto=True`` hands the rendezvous to the environment
    ``torchrun`` sets (``init_method="env://"``) — explicit, because
    silently reading "no cluster" as N independent one-process worlds would
    put N writers on one checkpoint directory.

    The degenerate path is a **no-op**: with no coordinator anywhere, a
    process count of 1 (or none) and ``auto=False``, no group is joined,
    no CUDA API is touched and the result is
    :meth:`FleetTopology.single_process`.  An empty coordinator string is
    how a supervisor spells its one-worker attempt.

    The group is joined through
    :func:`~evox_tpu_torch.parallel.init_multi_host` on ``device`` (the
    card by default, ``"cpu"`` for a CPU fleet): NCCL when each rank has a
    card of its own, gloo when ranks share one (their rows stay on the
    card) or compute on the CPU.

    Idempotent: a second call in a process that already joined returns
    the live topology.

    :param initialization_timeout: seconds the rendezvous and every later
        collective may wait for a peer (torch has one timeout for both): a
        survivor of a dead peer then fails within it instead of waiting
        out torch's default.
    :param key_impl: fleet-wide key implementation; it is published into
        the ``EVOX_TPU_KEY_IMPL`` contract the port's
        :func:`~evox_tpu_torch.precision.resolve_key_impl` reads (also when
        only the variable is set, which it then canonicalises), so every
        host derives the same streams.
    :returns: the :class:`FleetTopology` this process now belongs to.
    """
    if key_impl is not None or os.environ.get("EVOX_TPU_KEY_IMPL"):
        from ..precision.prng import resolve_key_impl

        os.environ["EVOX_TPU_KEY_IMPL"] = resolve_key_impl(key_impl)
    coordinator_address = coordinator_address or os.environ.get(FLEET_ENV_COORDINATOR) or None
    if num_processes is None:
        num_processes = _env_int(FLEET_ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(FLEET_ENV_PROCESS_ID)
    attempt = _env_int(FLEET_ENV_ATTEMPT) or 0

    if not auto and coordinator_address is None and num_processes in (None, 1):
        return FleetTopology.single_process()
    if _joined():
        return FleetTopology.current(coordinator_address or "", attempt, device)
    dev = init_multi_host(
        coordinator_address, num_processes, process_id, device=device, timeout=initialization_timeout
    )
    return FleetTopology.current(coordinator_address or "", attempt, dev)


def is_primary() -> bool:
    """Does this process hold the fleet's single-writer role?

    Rank 0 performs every mutating checkpoint-directory operation
    (publish, GC, corrupt-file quarantine); every other rank treats the
    directory as read-only.  A process in no group is primary."""
    return _rank() == 0


def fleet_barrier(tag: str = "evox_tpu_fleet") -> None:
    """Block until every process of the world reaches this barrier; no-op
    for one process.

    The resilience runner syncs here where the single writer's disk state
    is about to be read fleet-wide, so a non-primary process never races
    ahead of the primary's publish.  It waits at most the group's timeout
    (:func:`bootstrap_fleet`'s ``initialization_timeout``): under gloo it
    is ``monitored_barrier``, which names the ranks that did not arrive;
    under NCCL a ``barrier`` on the rank's card.  A failure is raised
    naming ``tag``."""
    if _num_processes() <= 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.monitored_barrier()
    except RuntimeError as e:
        raise RuntimeError(f"fleet barrier {tag!r} failed: {e}") from e


def gather_replicated(tree: Any) -> Any:
    """``tree`` with every tensor whole on this process: returned as it is.

    The JAX package gathers leaves a multi-process program left sharded
    across hosts.  In the port every tensor is local to its process, and
    the algorithm state is replicated by the parallel layer's contract
    (every rank steps the same state; only the fitness is split, and it
    is gathered inside the evaluation), so every leaf is already whole —
    the JAX package's case of fully addressable leaves."""
    return tree


# ---------------------------------------------------------------------------
# heartbeats: the observational liveness plane
# ---------------------------------------------------------------------------


def _heartbeat_path(directory: Union[str, Path], process_index: int) -> Path:
    return Path(directory) / f"{_HEARTBEAT_PREFIX}{int(process_index):04d}.json"


class HostHeartbeat:
    """Per-host liveness file, atomically republished (the JAX package's
    ``host_<index>.json`` beats, key for key).

    * :meth:`beat` — the *progress* beat: the runner calls it at segment
      boundaries with the completed generation and the segment's execution
      seconds (plus any extra payload fields).
    * :meth:`start` — the *liveness* beat: a daemon thread republishes the
      last payload with a fresh wall clock every ``interval`` seconds, so a
      host alive but stuck mid-segment keeps a fresh ``time`` while its
      ``generation`` freezes — the split :class:`FleetHealth` needs to tell
      **dead** from **wedged**.

    Writes are atomic (temp file + ``os.replace``), and a write failure is
    swallowed after a warning: losing one beat must never take down the run
    the beats exist to protect."""

    def __init__(
        self,
        directory: Union[str, Path],
        process_index: int | None = None,
        *,
        interval: float = 0.5,
        extra: Callable[[], Mapping[str, Any]] | None = None,
        metrics: Any | None = None,
    ):
        """
        :param directory: heartbeat directory (created if absent).
        :param process_index: this host's fleet index; defaults to the
            ``torch.distributed`` rank at first use.
        :param interval: liveness-republish period of the :meth:`start`
            thread.
        :param extra: optional callable returning extra JSON-serializable
            payload fields merged into every beat (how a worker reports its
            eval-deadline trips to the supervisor).
        :param metrics: optional :class:`~evox_tpu_torch.obs.MetricsRegistry`:
            every beat carries its typed ``fleet_payload()`` snapshot under
            ``"metrics"``, which a :class:`~evox_tpu_torch.obs.FleetAggregator`
            merges into one fleet-level registry.
        """
        self.directory = Path(directory)
        self._index = process_index
        self.interval = float(interval)
        self._extra = extra
        self._metrics = metrics
        self._lock = threading.Lock()
        self._payload: dict[str, Any] = {"generation": 0, "segment_seconds": None, "progress_at": time.time()}
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    @property
    def process_index(self) -> int:
        if self._index is None:
            self._index = _rank()
        return self._index

    @property
    def path(self) -> Path:
        return _heartbeat_path(self.directory, self.process_index)

    def _publish(self) -> None:
        with self._lock:
            payload = dict(self._payload)
        payload["process_index"] = self.process_index
        payload["pid"] = os.getpid()
        payload["time"] = time.time()
        if self._extra is not None:
            try:
                payload.update(self._extra())
            except Exception as e:  # noqa: BLE001 - a broken reporter must not stop the beat
                payload["extra_error"] = repr(e)
        if self._metrics is not None:
            try:
                fleet_payload = getattr(self._metrics, "fleet_payload", None)
                payload["metrics"] = (
                    fleet_payload() if fleet_payload is not None else self._metrics.heartbeat_payload()
                )
            except Exception as e:  # noqa: BLE001 - a broken registry must not stop the beat
                payload["metrics_error"] = repr(e)
        # Swallow everything, not just OSError: a TypeError from a payload
        # that is not JSON out of the daemon loop would kill the liveness
        # thread, and a stale beat gets a healthy host declared dead.
        tmp = None
        try:
            self.directory.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=self.path.name + ".tmp.")
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
            tmp = None
        except Exception as e:  # noqa: BLE001 - see above
            warnings.warn(f"heartbeat publish failed: {e!r}")
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def beat(self, generation: int | None = None, segment_seconds: float | None = None, **fields: Any) -> None:
        """Publish a progress beat.  ``generation`` advancing is what resets
        the wedged-host clock; extra ``fields`` ride in the payload."""
        with self._lock:
            if generation is not None:
                if generation != self._payload.get("generation"):
                    self._payload["progress_at"] = time.time()
                self._payload["generation"] = int(generation)
            if segment_seconds is not None:
                self._payload["segment_seconds"] = float(segment_seconds)
            self._payload.update(fields)
        self._publish()

    def start(self) -> "HostHeartbeat":
        """Start the background liveness thread (idempotent); returns self."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name="evox-tpu-torch-heartbeat", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._publish()

    def stop(self) -> None:
        """Stop the liveness thread (the file stays: a final fresh beat
        right before a clean exit is not a lie)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None


def read_heartbeats(directory: Union[str, Path]) -> dict[int, dict[str, Any]]:
    """All parseable heartbeats under ``directory``, keyed by process index.

    Torn or garbage files are skipped: the absence of a beat is itself the
    signal :class:`FleetHealth` interprets."""
    out: dict[int, dict[str, Any]] = {}
    directory = Path(directory)
    if not directory.is_dir():
        return out
    for path in sorted(directory.glob(f"{_HEARTBEAT_PREFIX}*.json")):
        try:
            payload = json.loads(path.read_text())
            out[int(payload["process_index"])] = payload
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


# ---------------------------------------------------------------------------
# per-host verdicts
# ---------------------------------------------------------------------------


@dataclass
class HostVerdict:
    """One host's health verdict, rendered from its heartbeat.
    ``reasons`` carries the human-readable lines; ``alive`` is false for a
    dead or wedged host.  ``beat_age`` / ``progress_age`` are ``None`` when
    the host never beat."""

    process_index: int
    alive: bool = True
    dead: bool = False
    wedged: bool = False
    slow: bool = False
    beat_age: float | None = None
    progress_age: float | None = None
    generation: int | None = None
    segment_seconds: float | None = None
    deadline_trips: int = 0
    reasons: list[str] = field(default_factory=list)


@dataclass
class FleetReport:
    """Structured verdict of one :meth:`FleetHealth.check` call."""

    healthy: bool
    verdicts: dict[int, HostVerdict]
    dead_hosts: list[int] = field(default_factory=list)
    wedged_hosts: list[int] = field(default_factory=list)
    slow_hosts: list[int] = field(default_factory=list)
    reasons: list[str] = field(default_factory=list)

    @property
    def unhealthy_hosts(self) -> list[int]:
        """Every host a supervisor should remove from the next world, in
        index order (dead + wedged + slow)."""
        return sorted(set(self.dead_hosts) | set(self.wedged_hosts) | set(self.slow_hosts))

    def to_json(self) -> dict[str, Any]:
        """The ``/healthz`` body: per-host verdicts and the dead, wedged and
        slow index lists (what ``FleetSupervisor(healthz_url=)`` reads)."""
        return {
            "healthy": self.healthy,
            "hosts": {
                str(i): {
                    "alive": v.alive,
                    "dead": v.dead,
                    "wedged": v.wedged,
                    "slow": v.slow,
                    "generation": v.generation,
                    "beat_age": v.beat_age,
                    "reasons": list(v.reasons),
                }
                for i, v in self.verdicts.items()
            },
            "dead": list(self.dead_hosts),
            "wedged": list(self.wedged_hosts),
            "slow": list(self.slow_hosts),
            "reasons": list(self.reasons),
        }


class FleetHealth:
    """Render per-host :class:`HostVerdict`\\ s from the heartbeat plane —
    the fleet-level analogue of
    :class:`~evox_tpu_torch.resilience.HealthProbe`.

    * **dead** — no beat file after ``start_grace`` seconds, or the newest
      beat older than ``dead_after``: the process stopped existing.
    * **wedged** — beats fresh but ``generation`` frozen for longer than
      ``stall_after``: alive but making no progress (a collective stuck on
      a lost peer, a partition).
    * **slow** — still progressing but self-reporting ``deadline_trips``,
      or a ``segment_seconds`` over ``eval_deadline``.
    """

    def __init__(
        self,
        directory: Union[str, Path],
        num_processes: int,
        *,
        dead_after: float = 5.0,
        stall_after: float | None = None,
        eval_deadline: float | None = None,
        start_grace: float = 30.0,
    ):
        """
        :param directory: the heartbeat directory the workers publish into.
        :param num_processes: world size — hosts expected to beat.
        :param dead_after: seconds without a fresh beat before a host is
            declared dead.
        :param stall_after: seconds without generation progress (beats
            fresh) before a host is declared wedged; ``None`` disables.
        :param eval_deadline: a host reporting ``segment_seconds`` above
            this, or any ``deadline_trips``, is declared slow; ``None``
            disables.
        :param start_grace: seconds after :meth:`reset` (or construction)
            during which a host that never beat is pending, not dead.
        """
        if num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {num_processes}")
        if dead_after <= 0:
            raise ValueError(f"dead_after must be > 0, got {dead_after}")
        self.directory = Path(directory)
        self.num_processes = int(num_processes)
        self.dead_after = float(dead_after)
        self.stall_after = None if stall_after is None else float(stall_after)
        self.eval_deadline = None if eval_deadline is None else float(eval_deadline)
        self.start_grace = float(start_grace)
        self._started_at = time.time()

    def reset(self, num_processes: int | None = None) -> None:
        """Re-arm the start grace window (and optionally adopt a new world
        size) — called by the supervisor at every relaunch."""
        if num_processes is not None:
            self.num_processes = int(num_processes)
        self._started_at = time.time()

    def check(self, now: float | None = None) -> FleetReport:
        """Read the heartbeat plane and render one verdict per expected
        host.  Pure observation: no collective, no CUDA API."""
        now = time.time() if now is None else float(now)
        beats = read_heartbeats(self.directory)
        verdicts: dict[int, HostVerdict] = {}
        reasons: list[str] = []
        dead: list[int] = []
        wedged: list[int] = []
        slow: list[int] = []
        in_grace = (now - self._started_at) < self.start_grace
        for idx in range(self.num_processes):
            beat = beats.get(idx)
            v = HostVerdict(process_index=idx)
            if beat is None:
                if not in_grace:
                    v.alive = False
                    v.dead = True
                    v.reasons.append(f"host {idx}: no heartbeat after the {self.start_grace:.1f}s start grace")
                verdicts[idx] = v
                if v.dead:
                    dead.append(idx)
                    reasons.extend(v.reasons)
                continue
            v.beat_age = now - float(beat.get("time", 0.0))
            v.progress_age = now - float(beat.get("progress_at", beat.get("time", 0.0)))
            gen = beat.get("generation")
            v.generation = None if gen is None else int(gen)
            seg = beat.get("segment_seconds")
            v.segment_seconds = None if seg is None else float(seg)
            v.deadline_trips = int(beat.get("deadline_trips", 0) or 0)
            if v.beat_age > self.dead_after:
                v.dead = True
                v.reasons.append(
                    f"host {idx}: heartbeat stale for {v.beat_age:.1f}s "
                    f"(> {self.dead_after:.1f}s) — process presumed dead"
                )
            elif self.stall_after is not None and v.progress_age > self.stall_after:
                v.wedged = True
                v.reasons.append(
                    f"host {idx}: alive but no generation progress for "
                    f"{v.progress_age:.1f}s (> {self.stall_after:.1f}s) — "
                    f"wedged collective or partitioned from the coordinator"
                )
            if self.eval_deadline is not None and not v.dead:
                if v.deadline_trips > 0:
                    v.slow = True
                    v.reasons.append(
                        f"host {idx}: self-reported {v.deadline_trips} eval-"
                        f"deadline trip(s) — straggling past the "
                        f"{self.eval_deadline:.2f}s per-host deadline"
                    )
                elif v.segment_seconds is not None and v.segment_seconds > self.eval_deadline:
                    v.slow = True
                    v.reasons.append(
                        f"host {idx}: segment took {v.segment_seconds:.2f}s (> {self.eval_deadline:.2f}s deadline)"
                    )
            v.alive = not (v.dead or v.wedged)
            verdicts[idx] = v
            if v.dead:
                dead.append(idx)
            if v.wedged:
                wedged.append(idx)
            if v.slow:
                slow.append(idx)
            reasons.extend(v.reasons)
        return FleetReport(
            healthy=not (dead or wedged or slow),
            verdicts=verdicts,
            dead_hosts=dead,
            wedged_hosts=wedged,
            slow_hosts=slow,
            reasons=reasons,
        )
