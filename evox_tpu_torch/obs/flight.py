"""Device-side flight recorder: per-generation signals, postmortem bundles
(counterpart of ``evox_tpu/obs/flight.py``).

When a health probe triggers a rollback, or a fused segment's early stop
freezes a poisoned state, the event stream says *that* it happened but not
*what the population was doing* in the generations before.  This module is
the black box.

Two halves:

* :func:`flight_signals` — a pure ``state -> {signal: 0-dim tensor}``
  extraction of the algorithm-internal per-generation signals (best/mean/
  worst fitness, population diversity, ES step size, velocity norms, the
  monitor's cumulative quarantine counters).  ``StdWorkflow``'s fused
  segment evaluates it on every generation's stepped state and stacks the
  values as additional telemetry (``segment_config(flight=True)``): tensor
  reductions only, no ``.item()``, no host sync, so it is captured into
  the segment's CUDA graph with the generations and never changes the
  state they compute.

* :class:`FlightRecorder` — a host-side bounded ring of the most recent
  generations' signal rows, fed once per segment at the telemetry flush.
  Attached to the :class:`~evox_tpu_torch.obs.EventBus` as a sink, it
  dumps a structured **postmortem bundle** (``manifest.json`` +
  ``flight.jsonl``, schema-stamped with :data:`OBS_SCHEMA_VERSION`)
  whenever a trigger event fires — a health restart, an unhealthy-state
  warning / early stop, a preemption — or when its own quarantine-storm
  detector sees the window's quarantine count jump.

torch is imported lazily inside :func:`flight_signals`.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from pathlib import Path
from typing import Any, Mapping, Union

from .version import OBS_SCHEMA_VERSION

__all__ = [
    "FlightRecorder",
    "finalize_row",
    "flight_signals",
    "last_n",
    "window_ema",
    "window_slope",
]

# Bus categories that can trip a postmortem dump.  "health" and "tenant"
# additionally require warning severity (routine tenant lifecycle lines —
# admission, completion — are info and must not dump).
TRIGGER_CATEGORIES = ("restart", "preemption", "health", "tenant", "invariant")

# The 2-D signals (pop_diversity, velocity_norm) leave the segment as RAW
# whole-tensor moment sums (``_pop_sum``/``_pop_sumsq``/``_pop_count``,
# ``_velocity_min``/``_velocity_max``) and are finished into semantic
# values on the host (:func:`finalize_row`), the JAX package's split: the
# rows a recorder holds are then the same function of the raw sums in
# both packages.  Per-dimension statistics are out — the flight series
# carries whole-tensor spread/RMS trajectories, and the health probe's
# gating scan keeps the per-dimension centered forms at segment
# boundaries.


def _floating(x: Any) -> bool:
    import torch

    return isinstance(x, torch.Tensor) and x.is_floating_point()


def flight_signals(state: Any, raw: bool = False) -> dict[str, Any]:
    """Pure ``state -> {signal: 0-dim tensor}`` per-generation signal
    extraction.

    All branching is on the *structure* of ``state``, so the emitted key
    set is stable per workflow configuration.  With ``raw=True`` — the
    form the fused segment stacks out — the 2-D signals are left as
    underscore-prefixed moment sums for :func:`finalize_row` to finish on
    the host.  Signals, each present only when the state supports it:

    * ``best_fitness`` / ``mean_fitness`` / ``worst_fitness`` — this
      generation's fitness extrema and mean (minimizing frame), from
      ``algorithm.fit`` or, for algorithms that keep no fitness leaf,
      the monitor's ``latest_fitness``;
    * ``pop_diversity`` — whole-tensor std of ``algorithm.pop`` (every
      element against the global mean): it vanishes exactly when the
      population contracts to a point.  Not the per-dimension max the
      health probe gates on
      (:func:`~evox_tpu_torch.resilience.health.scan_state` keeps that);
    * ``step_size_min`` / ``step_size_max`` — extrema of the ES ``sigma``
      leaf (a scalar CMA-ES step size reports min == max);
    * ``velocity_norm`` — the sup (L∞) norm of a PSO-family ``velocity``
      leaf: the swarm's largest velocity-component magnitude;
    * ``num_nonfinite`` / ``num_shard_quarantines`` — the monitor's
      cumulative quarantine counters (the storm detector's input).

    Evaluated *inside* the fused segment on each stepped state: tensor
    reductions only, never a host sync, so it is captured into the
    segment's graph.
    """
    import torch

    from ..resilience.health import _subtree

    out: dict[str, Any] = {}
    algo = _subtree(state, "algorithm")
    algo = algo if algo is not None else state
    fit = _subtree(algo, "fit")
    if fit is None:
        mon = _subtree(state, "monitor")
        fit = _subtree(mon, "latest_fitness") if mon is not None else None
    if _floating(fit) and fit.ndim == 1 and fit.numel() > 0:
        out["best_fitness"] = torch.amin(fit)
        out["mean_fitness"] = torch.mean(fit)
        out["worst_fitness"] = torch.amax(fit)
    pop = _subtree(algo, "pop")
    if _floating(pop) and pop.ndim == 2:
        # Whole-tensor E[x^2] - E[x]^2 from full-to-scalar sums — raw mode
        # ships the bare sums and finalize_row finishes them; the
        # standalone mode computes the value in place.  The shortcut
        # cancels catastrophically only at vanishing spreads, where a
        # diagnostic series clamped to 0 is still the right story.
        if raw:
            out["_pop_sum"] = torch.sum(pop)
            out["_pop_sumsq"] = torch.sum(pop * pop)
            out["_pop_count"] = torch.full((), float(pop.numel()), dtype=pop.dtype, device=pop.device)
        else:
            count = pop.numel()
            mean = torch.sum(pop) / count
            var = torch.clamp(torch.sum(pop * pop) / count - mean * mean, min=0.0)
            out["pop_diversity"] = torch.sqrt(var)
    sigma = _subtree(algo, "sigma")
    if _floating(sigma):
        out["step_size_min"] = torch.amin(sigma)
        out["step_size_max"] = torch.amax(sigma)
    velocity = _subtree(algo, "velocity")
    if _floating(velocity) and velocity.ndim == 2:
        # The sup norm from the two extrema; raw mode ships both and the
        # host takes the larger magnitude.
        if raw:
            out["_velocity_min"] = torch.amin(velocity)
            out["_velocity_max"] = torch.amax(velocity)
        else:
            out["velocity_norm"] = torch.maximum(-torch.amin(velocity), torch.amax(velocity))
    mon = _subtree(state, "monitor")
    if mon is not None:
        for key in ("num_nonfinite", "num_shard_quarantines"):
            if key in mon:
                out[key] = mon[key]
    return out


def finalize_row(row: dict[str, float]) -> dict[str, float]:
    """Finish one host-side signal row: derive the semantic 2-D signals
    (``pop_diversity``, ``velocity_norm``) from the raw moment sums the
    compiled segment ships (``flight_signals(raw=True)``), dropping the
    underscore-prefixed intermediates.  Pure float math — rows already
    holding the semantic keys pass through unchanged."""
    out = {k: v for k, v in row.items() if not k.startswith("_")}
    count = row.get("_pop_count", 0.0)
    if count and "_pop_sumsq" in row:
        mean = row["_pop_sum"] / count
        var = max(row["_pop_sumsq"] / count - mean * mean, 0.0)
        out["pop_diversity"] = var**0.5
    if "_velocity_min" in row and "_velocity_max" in row:
        out["velocity_norm"] = max(
            -row["_velocity_min"], row["_velocity_max"]
        )
    return out


# -- trend queries -----------------------------------------------------------
# ONE definition of the window math, shared by the control plane
# (evox_tpu_torch/control/) and ad-hoc
# postmortem analysis (a dumped bundle's ``flight.jsonl`` rows feed the
# same functions verbatim).  All three are NaN-robust: non-finite samples
# are *skipped*, never propagated — a NaN burst in a signal must degrade
# a trend estimate gracefully (fewer points), not poison it.  Pure float
# math, stdlib-only, deterministic for a given row sequence.


def _finite_pairs(
    rows: Any, signal: str, window: int | None
) -> list[tuple[float, float]]:
    """``(generation, value)`` pairs of the newest ``window`` rows that
    carry a *finite* value for ``signal`` (oldest first).  The window is
    cut over ROWS before the finite filter: a NaN burst in the newest
    rows must shrink the estimate to fewer points inside the window, not
    silently pull pre-burst history back in (a trend rendered from stale
    rows would describe the wrong regime).  Rows without a ``generation``
    key use their position index, so bundle rows and ad-hoc row lists
    work alike."""
    rows = list(rows)
    if window is not None and window > 0:
        rows = rows[-window:]
    pairs: list[tuple[float, float]] = []
    for i, row in enumerate(rows):
        if signal not in row:
            continue
        value = float(row[signal])
        if value != value or value in (float("inf"), float("-inf")):
            continue
        pairs.append((float(row.get("generation", i)), value))
    return pairs


def last_n(rows: Any, signal: str, n: int) -> list[float]:
    """The newest ``n`` values of ``signal`` among ``rows`` (oldest
    first).  Values are returned verbatim — non-finite included — so the
    caller sees exactly what the ring recorded; the trend estimators
    below are the NaN-robust consumers."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    values = [float(row[signal]) for row in rows if signal in row]
    return values[-n:]


def window_ema(
    rows: Any,
    signal: str,
    *,
    alpha: float = 0.3,
    window: int | None = None,
) -> float | None:
    """Exponential moving average of ``signal`` over the newest ``window``
    rows (all rows when ``None``), oldest-to-newest, skipping non-finite
    samples.  ``None`` when no finite sample exists.  ``alpha`` is the
    weight of each newer sample (0 < alpha <= 1)."""
    if not (0.0 < alpha <= 1.0):
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    pairs = _finite_pairs(rows, signal, window)
    if not pairs:
        return None
    ema = pairs[0][1]
    for _, value in pairs[1:]:
        ema = (1.0 - alpha) * ema + alpha * value
    return ema


def window_slope(
    rows: Any, signal: str, *, window: int | None = None
) -> float | None:
    """Least-squares slope of ``signal`` per *generation* over the newest
    ``window`` rows (all rows when ``None``), skipping non-finite
    samples.  ``None`` when fewer than two finite samples remain or every
    sample sits on one generation (a rollback replay can momentarily fold
    the window onto itself) — the caller must treat "no slope" as "no
    verdict", never as zero."""
    pairs = _finite_pairs(rows, signal, window)
    if len(pairs) < 2:
        return None
    n = float(len(pairs))
    mean_g = sum(g for g, _ in pairs) / n
    mean_v = sum(v for _, v in pairs) / n
    denom = sum((g - mean_g) ** 2 for g, _ in pairs)
    if denom <= 0.0:
        return None
    return sum((g - mean_g) * (v - mean_v) for g, v in pairs) / denom


class FlightRecorder:
    """Host-side ring buffer of per-generation flight rows + bundle dumper.

    Usage (supervised — the intended path)::

        recorder = FlightRecorder("postmortems", window=128)
        obs = Observability(flight=recorder)
        runner = ResilientRunner(wf, "ckpts/run", health=probe,
                                 restart=RollbackToCheckpoint(), obs=obs)
        runner.run(state, n_steps)   # a health rollback dumps a bundle
        recorder.bundles             # -> [Path(...)/postmortem_00000_restart]

    The recorder is fed once per fused segment (the runner's telemetry
    flush calls :meth:`record_rows` with the batched signal arrays) and
    subscribes to the event bus as a sink: trigger events — restart,
    preemption, health/tenant warnings — dump the current window as a
    postmortem bundle.  Rows never cross the host boundary more than once
    and nothing here runs in compiled scope.

    A bundle is a directory ``postmortem_<seq>_<kind>/`` under ``dir``::

        manifest.json   # schema, kind, run/tenant identity, generation
                        # span, signal names, the trigger event (when one
                        # fired), written LAST — its presence marks the
                        # bundle complete
        flight.jsonl    # one JSON object per generation row, ascending

    :param dir: directory bundles are dumped into (created on demand).
    :param window: ring capacity in generations (the "last K generations"
        a postmortem can explain).
    :param quarantine_storm: dump with ``kind="quarantine-storm"`` when
        the cumulative ``num_nonfinite`` counter grows by at least this
        many individuals within the window; ``None`` (default) disables
        the detector.
    :param tenant_id: filter — only trigger events carrying this
        ``tenant_id`` dump (service-wide preemptions always do).  ``None``
        accepts every trigger; :meth:`for_tenant` builds filtered clones.
    :param run_id: identity stamped into every manifest (an
        :class:`~evox_tpu_torch.obs.Observability` plane fills it in when the
        recorder is attached without one).
    """

    def __init__(
        self,
        dir: Union[str, Path],
        *,
        window: int = 256,
        quarantine_storm: int | None = None,
        tenant_id: str | None = None,
        run_id: str | None = None,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if quarantine_storm is not None and quarantine_storm < 1:
            raise ValueError(
                f"quarantine_storm must be >= 1 (or None to disable), got "
                f"{quarantine_storm}"
            )
        self.dir = Path(dir)
        self.window = int(window)
        self.quarantine_storm = (
            None if quarantine_storm is None else int(quarantine_storm)
        )
        self.tenant_id = tenant_id
        self.run_id = run_id
        self._lock = threading.Lock()
        self._rows: collections.deque[dict[str, float]] = collections.deque(
            maxlen=self.window
        )
        # Continue the bundle numbering past anything already on disk: a
        # readmitted tenant id (or a rerun over the same directory) must
        # never clobber an earlier incarnation's crash evidence.
        self._seq = self._next_seq()
        # Per-kind dedup cursor over the INGEST counter (not generation
        # numbers): a storm dump must not swallow the restart dump the
        # SAME boundary fires a moment later, and the same kind
        # re-triggering with no new rows adds nothing — but a rollback
        # REPLAYS earlier generations, so "newest generation didn't
        # advance" must not suppress the bundle of a second, divergent
        # failure (the replayed rows are new content).
        self._ingests = 0
        self._dumped: dict[str, int] = {}
        # Storm latch: a sustained burst keeps the window's quarantine
        # growth above the threshold for many segments — dump when the
        # storm STARTS, stay silent while it continues, re-arm once the
        # window shows it ended.
        self._storm_active = False
        self.bundles: list[Path] = []

    def _next_seq(self) -> int:
        """First unused bundle sequence number in ``dir`` (0 for a fresh
        directory): numbering always continues past existing bundles."""
        try:
            names = [
                p.name
                for p in self.dir.iterdir()
                if p.name.startswith("postmortem_")
            ]
        except OSError:
            return 0
        highest = -1
        for name in names:
            parts = name.split("_")
            if len(parts) >= 2 and parts[1].isdigit():
                highest = max(highest, int(parts[1]))
        return highest + 1

    def for_tenant(self, tenant_id: str) -> "FlightRecorder":
        """A per-tenant clone: same window/storm config, bundles under
        ``dir/<tenant_id>/``, trigger events filtered to the tenant.  The
        multi-tenant service builds one per admitted tenant so each lane's
        series dumps into its own namespace."""
        return FlightRecorder(
            self.dir / str(tenant_id),
            window=self.window,
            quarantine_storm=self.quarantine_storm,
            tenant_id=str(tenant_id),
            run_id=self.run_id,
        )

    # -- feeding ------------------------------------------------------------
    def record_rows(
        self,
        signals: Mapping[str, Any],
        executed: int,
        start_generation: int,
        lane: int | None = None,
    ) -> None:
        """Append one segment's batched signal rows to the ring.

        :param signals: ``{name: array}`` with a leading ``(n_steps,)``
            axis — or ``(n_lanes, n_steps, ...)`` for a vmapped pack, in
            which case ``lane`` selects the row to ingest (the per-tenant
            demux, mirroring ``EvalMonitor.ingest_sinks(lane=...)``).
        :param executed: generations that actually ran (rows past it are
            early-stop padding and are dropped).
        :param start_generation: generation count *before* the segment —
            row ``g`` is generation ``start_generation + 1 + g``.
        """
        executed = int(executed)
        with self._lock:
            if executed > 0:
                self._ingests += 1
            for g in range(executed):
                row: dict[str, float] = {}
                for name, arr in signals.items():
                    value = arr[lane][g] if lane is not None else arr[g]
                    row[str(name)] = float(value)
                # Raw moment sums -> semantic signals, on the host (the
                # compiled program must not combine them; module comment).
                row = finalize_row(row)
                row["generation"] = int(start_generation) + 1 + g
                self._rows.append(row)
        self._check_storm()

    def rows(self) -> list[dict[str, float]]:
        """Copy of the current ring contents (oldest first)."""
        with self._lock:
            return [dict(r) for r in self._rows]

    def latest_generation(self) -> int | None:
        with self._lock:
            return int(self._rows[-1]["generation"]) if self._rows else None

    # -- trend queries (the control plane's read surface) -------------------
    def last_n(self, signal: str, n: int) -> list[float]:
        """The newest ``n`` recorded values of ``signal`` (oldest first;
        non-finite values included) — see :func:`last_n`."""
        return last_n(self.rows(), signal, n)

    def window_ema(
        self, signal: str, *, alpha: float = 0.3, window: int | None = None
    ) -> float | None:
        """NaN-robust EMA of ``signal`` over the ring — see
        :func:`window_ema`."""
        return window_ema(self.rows(), signal, alpha=alpha, window=window)

    def window_slope(
        self, signal: str, *, window: int | None = None
    ) -> float | None:
        """NaN-robust per-generation slope of ``signal`` over the ring —
        see :func:`window_slope`."""
        return window_slope(self.rows(), signal, window=window)

    def _check_storm(self) -> None:
        if self.quarantine_storm is None:
            return
        with self._lock:
            counts = [
                r["num_nonfinite"] for r in self._rows if "num_nonfinite" in r
            ]
        if not counts:
            return
        # num_nonfinite is cumulative: growth across the window is the
        # storm size.  Latch while it stays above the threshold so one
        # sustained burst produces one bundle (the one that shows the
        # onset), re-arming once the window shows the storm over.
        grown = counts[-1] - counts[0]
        if grown >= self.quarantine_storm:
            if not self._storm_active:
                self._storm_active = True
                self.dump(
                    "quarantine-storm",
                    detail={
                        "quarantined_in_window": grown,
                        "threshold": self.quarantine_storm,
                    },
                )
        else:
            self._storm_active = False

    # -- the bus-sink trigger ------------------------------------------------
    def emit(self, event: Any) -> None:
        """EventBus sink protocol: dump on trigger events.

        * ``restart`` / ``preemption`` — always (a preemption is every
          tenant's trigger, so the tenant filter does not apply to it);
        * ``health`` / ``tenant`` — warning severity or worse only, and
          (for a tenant-filtered recorder) only the matching tenant.

        Runs under the bus's publish lock like every sink; the write is
        bounded by the ring (``window`` rows of a few floats — tens of
        KB), and a failed write degrades to ``None`` instead of raising
        (the bus detaches sinks that raise).
        """
        category = getattr(event, "category", None)
        if category not in TRIGGER_CATEGORIES:
            return
        severity = getattr(event, "severity", "info")
        if category in ("health", "tenant") and severity not in (
            "warning",
            "error",
        ):
            return
        if (
            self.tenant_id is not None
            and category != "preemption"
            and getattr(event, "tenant_id", None) != self.tenant_id
        ):
            return
        self.dump(category, event=event)

    # -- dumping ------------------------------------------------------------
    def dump(
        self,
        kind: str,
        *,
        event: Any = None,
        detail: Mapping[str, Any] | None = None,
        force: bool = False,
    ) -> Path | None:
        """Write the current window as one postmortem bundle; returns its
        directory, or ``None`` when there is nothing new to dump (empty
        ring, or no rows recorded since the same ``kind`` last dumped —
        replayed post-rollback rows count as new content;
        ``force=True`` overrides the dedup) — or when the write itself
        failed (``OSError``): a full disk must never raise out of a bus
        sink (the bus would detach the recorder for good), and the dedup
        cursor only commits on success, so the NEXT trigger retries."""
        with self._lock:
            rows = [dict(r) for r in self._rows]
            if not rows:
                return None
            newest = int(rows[-1]["generation"])
            if not force and self._dumped.get(kind) == self._ingests:
                return None
            # Reserve the sequence number up front (concurrent dumps must
            # never share a bundle name); a failed write leaves a gap in
            # the numbering, which is harmless.
            seq = self._seq
            self._seq += 1
        safe_kind = "".join(
            c if c.isalnum() or c in "._-" else "-" for c in str(kind)
        )
        bundle = self.dir / f"postmortem_{seq:05d}_{safe_kind}"
        signal_names = sorted(
            {name for row in rows for name in row if name != "generation"}
        )
        manifest: dict[str, Any] = {
            "schema": OBS_SCHEMA_VERSION,
            "kind": str(kind),
            "created_wall": time.time(),
            "run_id": self.run_id,
            "tenant_id": self.tenant_id,
            "window": self.window,
            "rows": len(rows),
            "first_generation": int(rows[0]["generation"]),
            "last_generation": newest,
            "signals": signal_names,
            "flight_file": "flight.jsonl",
            "trigger": (
                event.to_json() if hasattr(event, "to_json") else None
            ),
        }
        if detail:
            manifest["detail"] = dict(detail)
        from ..utils.checkpoint import atomic_write_text

        try:
            bundle.mkdir(parents=True, exist_ok=True)
            atomic_write_text(
                bundle / "flight.jsonl",
                "".join(json.dumps(row) + "\n" for row in rows),
            )
            # Manifest last: its presence marks the bundle complete, so a
            # reader never consumes a half-written dump — and the atomic
            # publish means the completeness marker itself can never tear.
            atomic_write_text(
                bundle / "manifest.json",
                json.dumps(manifest, indent=1, default=repr) + "\n",
            )
        except OSError:
            return None
        # Commit the dedup cursor only after a durable bundle exists —
        # a failed write must stay retryable.
        with self._lock:
            self._dumped[kind] = self._ingests
            self.bundles.append(bundle)
        return bundle
