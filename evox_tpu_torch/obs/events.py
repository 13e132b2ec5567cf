"""Structured event bus: typed records, pluggable sinks (counterpart of
``evox_tpu/obs/events.py``: the same records, JSON lines and sinks).

An :class:`Event` carries monotonic *and* wall timestamps, a category, a
severity, the run/tenant/process identity, and a structured payload;
sinks subscribe to the :class:`EventBus` and see every event in publish
order.

Three sinks ship:

* :class:`RingBufferSink` — bounded in-memory tail for interactive
  debugging and tests;
* :class:`JsonlFileSink` — one JSON object per line, appended via a
  single ``write()`` of the full line (readers never see a torn record),
  with size-capped rotation (``events.jsonl`` → ``events.jsonl.1`` → …);
* :class:`CallbackSink` — the legacy adapter: renders each event back
  into the human-readable one-line string an ``on_event`` callback
  expects, so such consumers keep working while severity and structure
  survive on the bus.

Publishing is cheap (one lock, one dataclass) and **strictly host-side**:
nothing here may run inside a captured CUDA graph or a fused segment;
the runner publishes at segment boundaries only.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Mapping, Union

from .version import OBS_SCHEMA_VERSION

__all__ = [
    "Event",
    "EventBus",
    "RingBufferSink",
    "JsonlFileSink",
    "CallbackSink",
]

SEVERITIES = ("debug", "info", "warning", "error")


def _process_index() -> int:
    """This process's index in its fleet, without creating anything: the
    ``EVOX_TPU_FLEET_PROCESS_ID`` environment contract is authoritative
    when present, else the ``torch.distributed`` rank when a process group
    is already initialized; otherwise 0.  Publishing an event never
    initializes CUDA or a process group."""
    env = os.environ.get("EVOX_TPU_FLEET_PROCESS_ID")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


@dataclass(frozen=True)
class Event:
    """One structured observability record.

    ``t_mono`` (``time.monotonic()``) orders events within a process even
    across wall-clock adjustments; ``t_wall`` (``time.time()``) correlates
    them across hosts.  ``seq`` is the bus-assigned publish index —
    strictly increasing, so sinks and post-mortems can prove ordering."""

    seq: int
    t_wall: float
    t_mono: float
    category: str
    severity: str
    message: str
    run_id: str | None = None
    tenant_id: str | None = None
    process_index: int = 0
    payload: Mapping[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        """The JSONL record shape.  Serialize it with
        ``json.dumps(..., default=repr)`` (as :class:`JsonlFileSink`
        does): payload values that do not serialize natively are
        ``repr``-ed in one pass rather than probed value-by-value."""
        return {
            "schema": OBS_SCHEMA_VERSION,
            "seq": self.seq,
            "t_wall": self.t_wall,
            "t_mono": self.t_mono,
            "category": self.category,
            "severity": self.severity,
            "message": self.message,
            "run_id": self.run_id,
            "tenant_id": self.tenant_id,
            "process_index": self.process_index,
            "payload": dict(self.payload),
        }

    def legacy_line(self) -> str:
        """The pre-obs one-line string shape (what ``on_event`` callbacks
        have always received): the bare message."""
        return self.message


class EventBus:
    """Publish-ordered fan-out of :class:`Event` records to sinks.

    One lock serializes publishing, so ``seq`` is strictly increasing and
    every sink observes the same order — including events arriving from
    background threads (the async checkpoint writer, heartbeat
    republishers).  The lock is re-entrant: a sink whose ``emit`` itself
    publishes (a forwarding callback) produces a nested event instead of
    deadlocking the process.  A sink that raises is detached after a
    warning event is delivered to the surviving sinks: a broken log file
    must never take down the run it was recording."""

    def __init__(
        self,
        *,
        run_id: str | None = None,
        sinks: tuple = (),
    ):
        self.run_id = run_id
        self._sinks: list[Any] = list(sinks)
        self._lock = threading.RLock()
        self._seq = itertools.count()

    def add_sink(self, sink: Any) -> Any:
        """Attach a sink (any object with ``emit(event)``); returns it."""
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: Any) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def publish(
        self,
        category: str,
        message: str,
        *,
        severity: str = "info",
        run_id: str | None = None,
        tenant_id: str | None = None,
        **payload: Any,
    ) -> Event:
        """Build and fan out one event; returns it (tests assert on the
        return value without needing a sink)."""
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {severity!r}"
            )
        with self._lock:
            event = Event(
                seq=next(self._seq),
                t_wall=time.time(),
                t_mono=time.monotonic(),
                category=category,
                severity=severity,
                message=message,
                run_id=run_id if run_id is not None else self.run_id,
                tenant_id=tenant_id,
                process_index=_process_index(),
                payload=payload,
            )
            broken: list[tuple[Any, BaseException]] = []
            for sink in self._sinks:
                try:
                    sink.emit(event)
                except Exception as e:  # noqa: BLE001 - sink isolation
                    broken.append((sink, e))
            for sink, _ in broken:
                self._sinks.remove(sink)
        for sink, e in broken:
            # Outside the lock: the notice itself publishes like any event.
            self.publish(
                "obs",
                f"detached broken event sink {type(sink).__name__}: {e!r}",
                severity="warning",
            )
        return event


class RingBufferSink:
    """Bounded in-memory tail of the event stream."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._events: collections.deque[Event] = collections.deque(
            maxlen=capacity
        )

    def emit(self, event: Event) -> None:
        self._events.append(event)

    def events(self) -> list[Event]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)


class JsonlFileSink:
    """Append-only JSONL event log with size-capped rotation.

    Each event is one ``json.dumps`` line written with a single
    ``write()`` call on a line-buffered handle, so concurrent readers
    (and post-crash scans) see whole records or nothing.  When the live
    file exceeds ``max_bytes`` the sink rotates: ``path`` →
    ``path.1`` → … → ``path.<keep>`` (oldest dropped), checked *before*
    each write so the live file only exceeds the cap by one line."""

    def __init__(
        self,
        path: Union[str, Path],
        *,
        max_bytes: int = 16 * 1024 * 1024,
        keep: int = 3,
    ):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if keep < 0:
            raise ValueError(f"keep must be >= 0, got {keep}")
        self.path = Path(path)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self._lock = threading.Lock()
        self._file = None
        self._size = 0

    def _open(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # Advisory line-buffered JSONL event log with size-based rotation
        # and reopen-on-error: the service journal is the durable record;
        # a torn tail line here is skipped by readers, and append-mode has
        # no staged-publish equivalent.
        self._file = open(self.path, "a", buffering=1)
        self._size = self._file.tell()

    def _rotate(self) -> None:
        self._file.close()
        self._file = None
        if self.keep == 0:
            try:
                os.unlink(self.path)
            except OSError:
                pass
        else:
            for i in range(self.keep - 1, 0, -1):
                src = self.path.with_name(f"{self.path.name}.{i}")
                if src.exists():
                    os.replace(src, self.path.with_name(f"{self.path.name}.{i + 1}"))
            os.replace(self.path, self.path.with_name(f"{self.path.name}.1"))
        self._open()

    def emit(self, event: Event) -> None:
        # default=repr: unserializable payload values are repr-ed in this
        # single pass rather than dropped (or probed per value).
        line = json.dumps(event.to_json(), default=repr) + "\n"
        with self._lock:
            if self._file is None:
                self._open()
            if self._size and self._size + len(line) > self.max_bytes:
                self._rotate()
            self._file.write(line)
            self._size += len(line)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def files(self) -> list[Path]:
        """The live file plus rotated generations, newest first."""
        out = [self.path] if self.path.exists() else []
        for i in range(1, self.keep + 1):
            p = self.path.with_name(f"{self.path.name}.{i}")
            if p.exists():
                out.append(p)
        return out


class CallbackSink:
    """Legacy adapter: feed a pre-obs string callback from the bus.

    ``min_severity`` filters (default: everything); the callback receives
    exactly the one-line string shape ``on_event`` consumers have always
    parsed, so pointing an existing callback at the bus is a one-liner::

        bus.add_sink(CallbackSink(my_on_event))
    """

    def __init__(
        self,
        callback: Callable[[str], None],
        *,
        min_severity: str = "debug",
    ):
        if min_severity not in SEVERITIES:
            raise ValueError(
                f"min_severity must be one of {SEVERITIES}, got "
                f"{min_severity!r}"
            )
        self._callback = callback
        self._floor = SEVERITIES.index(min_severity)

    def emit(self, event: Event) -> None:
        if SEVERITIES.index(event.severity) >= self._floor:
            self._callback(event.legacy_line())
