"""Segment-level tracing: host-side spans, Chrome-trace/Perfetto export
(counterpart of ``evox_tpu/obs/trace.py``).

On the card a fused segment is one replay of a captured CUDA graph, and
``torch.profiler`` already covers device time.  What no existing tool
shows is *where the boundary goes*: per segment, how much wall clock went
to the first capture of a segment's graph (the ``aot-compile`` span, the
port's counterpart of the JAX package's AOT compile), to execution, to the
telemetry flush, to the checkpoint submit + writer barrier, to the health
probe.  :class:`Tracer` records exactly those as host-side spans —
strictly at segment boundaries, never inside a captured graph — and
exports them as Chrome-trace JSON that ``chrome://tracing`` or the
Perfetto UI loads directly.

Spans nest naturally by time (a segment's ``aot-compile`` and ``execute``
spans lie inside the run's ``run`` span): the Chrome trace viewer
reconstructs the nesting from thread id + time containment, so the
recorder stays a flat append-only list — one lock, two ``perf_counter``
calls per span.

An opt-in ``torch.profiler`` window can additionally capture the Nth
segment (``profile_segment=N, profile_dir=...``): one segment of full
device-level profiling, exported as a Chrome trace into ``profile_dir``,
without paying profiler overhead for the whole run.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator, Union

from .version import OBS_SCHEMA_VERSION

__all__ = ["CounterSample", "Span", "Tracer"]


@contextlib.contextmanager
def _profile_window(path: Path) -> Iterator[Any]:
    """``torch.profiler.profile`` over the with-block (the card's activity
    too when CUDA is available), its Chrome trace exported to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


@dataclass(frozen=True)
class Span:
    """One completed host-side span (microseconds, Chrome-trace ``ph:X``)."""

    name: str
    ts_us: float
    dur_us: float
    tid: int
    args: dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class CounterSample:
    """One point on a Chrome-trace counter track (``ph:"C"``): Perfetto
    renders each ``values`` series as a stacked area under the span
    timeline — the live memory / throughput tracks the runner feeds at
    segment boundaries."""

    name: str
    ts_us: float
    tid: int
    values: dict[str, float] = field(default_factory=dict)


class Tracer:
    """Append-only span recorder with Chrome-trace export.

    :param profile_segment: opt-in — the 0-based segment index around
        which the runner opens a ``torch.profiler`` window (one segment of
        device-level profiling; ``None`` disables).
    :param profile_dir: where the profiler window writes its trace
        (defaults to ``profile_trace`` under the working directory).
    :param process_index: the fleet process index stamped as the Chrome
        trace ``pid`` (and into ``otherData``).  Defaults to the OS pid
        — fine for one host, but two hosts' OS pids can collide, so
        fleet workers pass their rank here, one clean lane per host.
    """

    def __init__(
        self,
        *,
        profile_segment: int | None = None,
        profile_dir: Union[str, Path, None] = None,
        process_index: int | None = None,
    ):
        if profile_segment is not None and profile_segment < 0:
            raise ValueError(
                f"profile_segment must be >= 0, got {profile_segment}"
            )
        self.profile_segment = profile_segment
        self.process_index = (
            None if process_index is None else int(process_index)
        )
        self.profile_dir = Path(profile_dir) if profile_dir else Path("profile_trace")
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._counters: list[CounterSample] = []
        # Wall anchor: perf_counter gives monotonic high-resolution spans;
        # the anchor lets a reader line the trace up with event t_wall.
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self.profiled_segments: list[int] = []

    # -- recording ----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args: Any) -> Iterator[None]:
        """Record one complete span around the with-block."""
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self._append(name, start, end, args)

    def record(self, name: str, start: float, end: float, **args: Any) -> None:
        """Record a span from caller-measured ``perf_counter`` endpoints
        (the runner already times compile/execute for ``segment_timings``;
        re-measuring would double the clock calls)."""
        self._append(name, start, end, args)

    def _append(self, name: str, start: float, end: float, args: dict) -> None:
        span = Span(
            name=name,
            ts_us=(start - self._t0) * 1e6,
            dur_us=max(0.0, (end - start)) * 1e6,
            tid=threading.get_ident(),
            args=args,
        )
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def counter(self, name: str, **values: float) -> None:
        """Record one counter-track sample (``ph:"C"``) at "now": device
        memory in use, generations/sec — numeric series Perfetto draws as
        live tracks under the segment timeline.  Non-numeric/None values
        are dropped so call sites can pass optional stats verbatim."""
        clean = {}
        for key, value in values.items():
            try:
                if value is not None:
                    clean[key] = float(value)
            except (TypeError, ValueError):
                continue
        if not clean:
            return
        sample = CounterSample(
            name=name,
            ts_us=(time.perf_counter() - self._t0) * 1e6,
            tid=threading.get_ident(),
            values=clean,
        )
        with self._lock:
            self._counters.append(sample)

    def counters(self) -> list[CounterSample]:
        with self._lock:
            return list(self._counters)

    # -- the profiler window -------------------------------------------------
    def maybe_profile(self, segment_index: int):
        """A ``torch.profiler.profile`` context when ``segment_index`` is
        the opted-in segment (the JAX package opens ``jax.profiler.trace``
        there), else a no-op context.  The window records the host and, on
        a CUDA machine, the card, and exports a Chrome trace
        ``segment_<index>.trace.json`` into ``profile_dir`` when it
        closes.  The profiler is imported lazily, so a tracer never pulls
        profiler machinery into processes that only record spans."""
        if (
            self.profile_segment is None
            or segment_index != self.profile_segment
        ):
            return contextlib.nullcontext()
        self.profiled_segments.append(segment_index)
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        return _profile_window(
            self.profile_dir / f"segment_{segment_index:05d}.trace.json"
        )

    # -- export --------------------------------------------------------------
    def to_chrome_trace(self) -> dict[str, Any]:
        """The Chrome-trace (Perfetto-loadable) JSON object."""
        pid = (
            self.process_index
            if self.process_index is not None
            else os.getpid()
        )
        events = [
            {
                "name": span.name,
                "ph": "X",
                "ts": span.ts_us,
                "dur": span.dur_us,
                "pid": pid,
                "tid": span.tid,
                "args": span.args,
            }
            for span in self.spans()
        ]
        events += [
            {
                "name": sample.name,
                "ph": "C",
                "ts": sample.ts_us,
                "pid": pid,
                "tid": sample.tid,
                "args": sample.values,
            }
            for sample in self.counters()
        ]
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema": OBS_SCHEMA_VERSION,
                "wall_anchor": self._wall0,
                "producer": "evox_tpu_torch.obs",
                "process_index": self.process_index,
            },
        }

    def write(self, path: Union[str, Path]) -> Path:
        """Write :meth:`to_chrome_trace` as JSON (loadable by
        ``json.load`` and the Perfetto UI).  Published atomically: a
        crash mid-write never leaves a torn file Perfetto rejects."""
        from ..utils.checkpoint import atomic_write_text

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_text(path, json.dumps(self.to_chrome_trace()) + "\n")
        return path
