"""Run-health diagnostics (counterpart of ``evox_tpu/resilience/health.py``).

:func:`scan_state` is a pure ``state -> {metric: 0-dim tensor}`` function:
every branch is on the structure of the state, every metric stays on the
state's device, so it reads nothing back to the host and runs inside a
captured CUDA graph.  Metric names and leaf-path names are the JAX
package's (``"algorithm/pop"``: the keys of the nested states, joined by
``/``).

:class:`HealthProbe` scans a workflow state **between** the supervisor's
segments and renders a structured :class:`HealthReport`:

* **non-finite state** — any NaN/±Inf in any floating leaf of the state
  (algorithm, problem, and monitor sub-states alike; key and integer
  leaves are skipped, and leaves whose path matches ``nonfinite_skip`` are
  exempt for algorithms that use ``inf`` as an in-band sentinel);
* **diversity collapse** — the largest per-dimension spread (std over the
  population axis) of ``state.algorithm.pop`` fell under
  ``diversity_floor``;
* **step-size out of range** — an ES ``sigma`` leaf left
  ``step_size_range``;
* **stagnation** — the best fitness (monitor top-k when available, else
  ``min(state.algorithm.fit)``) improved less than ``stagnation_tol`` over
  the last ``stagnation_window`` probes.

A probe is one :func:`scan_state` on the state's device and ONE copy of
all its scalars to the host.  The stagnation window is host-side state:
the :class:`~evox_tpu_torch.resilience.ResilientRunner` persists it in
each checkpoint's manifest so resumed runs replay probe decisions
bit-identically.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import torch

__all__ = ["HealthProbe", "HealthReport", "scan_state"]


def _is_prng(leaf: Any, name: str | None = None) -> bool:
    """Whether ``leaf`` is a PRNG key.  JAX's keys carry a key dtype; a port
    key is a plain int64 tensor whose last axis holds its two words, so it
    is told apart by where it sits: a leaf whose path (as
    :func:`_leaves_with_path` names it) ends in ``key``, the name every
    component of the port gives its key (``utils.convert.state_from_numpy``
    reads keys the same way).  Without a path nothing is one (a key is
    skipped as a non-floating leaf all the same)."""
    return (
        name is not None
        and name.rsplit("/", 1)[-1] == "key"
        and isinstance(leaf, torch.Tensor)
        and leaf.dtype == torch.int64
        and leaf.ndim >= 1
        and leaf.shape[-1] == 2
    )


def _subtree(state: Any, name: str) -> Any | None:
    """``state[name]`` when ``state`` is a mapping that has it, else None."""
    if isinstance(state, Mapping) and name in state:
        return state[name]
    return None


def _leaves_with_path(tree: Any, prefix: tuple = ()) -> Iterator[tuple[str, Any]]:
    """``(path, leaf)`` in the order the JAX package flattens a state: the
    keys of each mapping in order, the items of tuples and lists by index,
    joined with ``/``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves_with_path(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _floating(x: Any) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def scan_state(
    state: Any,
    *,
    check_nonfinite: bool = True,
    nonfinite_skip: Sequence[str] = (),
    diversity: bool = False,
    step_size: bool = False,
    shards: int | None = None,
) -> dict[str, Any]:
    """Pure ``state -> {metric: 0-dim tensor}`` health scan; keys are
    emitted only when the state supports them, so the dict is stable per
    state structure:

    * ``nonfinite`` — per-leaf-path counts (int32) of NaN/±Inf scalars
      (floating leaves only; ``nonfinite_skip`` matches excluded);
    * ``diversity`` — largest per-dimension std of ``algorithm.pop``;
    * ``step_size_min`` / ``step_size_max`` — extrema of ``algorithm.sigma``;
    * ``best_fitness`` — monitor top-k best (minimizing frame) when
      available, else ``min(algorithm.fit)``;
    * ``shard_nonfinite`` / ``shard_rows`` / ``shard_diversity`` — with
      ``shards=N > 1``, the non-finite rows of ``algorithm.fit`` and the
      rows of each shard (int32 ``(N,)``), and, with ``diversity``, the
      largest per-dimension spread of each shard's rows of
      ``algorithm.pop`` (``inf`` for a shard with no rows).  Shards are the
      contiguous row blocks of
      :func:`~evox_tpu_torch.parallel.shard_row_ids`, ragged tails
      included.
    """
    out: dict[str, Any] = {}
    if check_nonfinite:
        counts = {}
        for name, leaf in _leaves_with_path(state):
            if any(skip in name for skip in nonfinite_skip):
                continue
            if _is_prng(leaf) or not _floating(leaf):
                continue
            counts[name] = (~torch.isfinite(leaf)).sum(dtype=torch.int32)
        out["nonfinite"] = counts
    algo = _subtree(state, "algorithm")
    algo = algo if algo is not None else state
    pop = _subtree(algo, "pop")
    if diversity and _floating(pop) and pop.ndim == 2:
        # Largest per-dimension spread (population std, two passes, as
        # jnp.std): below a floor means EVERY dimension collapsed.
        centered = pop - pop.mean(dim=0)
        out["diversity"] = torch.amax(torch.sqrt((centered * centered).mean(dim=0)))
    fit = _subtree(algo, "fit")
    if shards and shards > 1 and _floating(fit) and fit.ndim in (1, 2):
        # Per shard: a shard whose count equals its rows is dead.
        from ..parallel import shard_row_ids

        ids = shard_row_ids(fit.shape[0], shards, fit.device)
        row_bad = ~torch.isfinite(fit)
        if fit.ndim == 2:
            row_bad = row_bad.any(dim=-1)
        zeros = torch.zeros((shards,), dtype=torch.int32, device=fit.device)
        out["shard_nonfinite"] = zeros.index_add(0, ids, row_bad.to(torch.int32))
        out["shard_rows"] = zeros.index_add(0, ids, torch.ones_like(ids, dtype=torch.int32))
    if diversity and shards and shards > 1 and _floating(pop) and pop.ndim == 2:
        from ..parallel import shard_row_ids

        ids = shard_row_ids(pop.shape[0], shards, pop.device)
        zeros = torch.zeros((shards,) + tuple(pop.shape[1:]), dtype=pop.dtype, device=pop.device)
        n_s = torch.zeros((shards,), dtype=pop.dtype, device=pop.device).index_add(
            0, ids, torch.ones((pop.shape[0],), dtype=pop.dtype, device=pop.device)
        )
        denom = torch.clamp(n_s, min=1.0)[:, None]
        mean = zeros.index_add(0, ids, pop) / denom
        # Two passes (centered), as the whole-population spread.
        centered = pop - mean[ids]
        var = zeros.index_add(0, ids, centered * centered) / denom
        spread = torch.amax(torch.sqrt(var), dim=-1)
        out["shard_diversity"] = torch.where(n_s > 0, spread, torch.full_like(spread, float("inf")))
    sigma = _subtree(algo, "sigma")
    if step_size and _floating(sigma):
        out["step_size_min"] = torch.amin(sigma)
        out["step_size_max"] = torch.amax(sigma)
    best = _best_fitness_expr(state, algo)
    if best is not None:
        out["best_fitness"] = best
    return out


def _best_fitness_expr(state: Any, algo: Any):
    """Best fitness in the minimizing frame: the monitor's running top-k
    when present (monotone best-so-far), else this generation's
    ``min(fit)``.  ``None`` when the state exposes neither (e.g.
    multi-objective states, which have no scalar best)."""
    mon = _subtree(state, "monitor")
    if mon is not None:
        topk = _subtree(mon, "topk_fitness")
        if _floating(topk) and topk.ndim == 1 and topk.numel() > 0:
            return topk[0]
    fit = _subtree(algo, "fit")
    if _floating(fit) and fit.ndim == 1 and fit.numel() > 0:
        return torch.amin(fit)
    return None


def _to_host(raw: Mapping[str, Any]) -> dict[str, Any]:
    """``raw`` (a :func:`scan_state` dict) with every tensor read back to
    the host in ONE copy: 0-dim metrics become Python floats (counts
    ints), per-shard metrics lists.  The values are converted to float64
    on the device first, which every int32 count and float32/bfloat16
    value survives exactly."""
    flat: list[tuple[tuple[str, ...], torch.Tensor]] = []

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                flat.append((path + (k,), v))

    walk(raw, ())
    if not flat:
        return {}
    device = flat[0][1].device
    values = torch.cat([t.detach().reshape(-1).to(device=device, dtype=torch.float64) for _, t in flat]).tolist()
    out: dict[str, Any] = {}
    pos = 0
    for path, t in flat:
        n = t.numel()
        chunk = values[pos : pos + n]
        pos += n
        if not t.is_floating_point():
            chunk = [int(v) for v in chunk]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = chunk if t.ndim else chunk[0]
    return out


def _lanes_to_host(raw: Mapping[str, Any], rows: Sequence[int]) -> list[dict[str, Any]]:
    """A lane-batched :func:`scan_state` dict (every metric with a leading
    lane axis) as one host dict per requested row, in :func:`_to_host`'s
    form, read back in ONE copy of every lane's scalars (float64 on the
    device first, which every int32 count and float32/bfloat16 value
    survives exactly)."""
    flat: list[tuple[tuple[str, ...], torch.Tensor]] = []

    def walk(node: Mapping[str, Any], path: tuple[str, ...]) -> None:
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                flat.append((path + (k,), v))

    walk(raw, ())
    out: list[dict[str, Any]] = [{} for _ in rows]
    if not flat or not rows:
        return out
    table = torch.cat([t.detach().reshape(t.shape[0], -1).to(torch.float64) for _, t in flat], dim=1).tolist()
    for values, node_out in zip((table[r] for r in rows), out):
        pos = 0
        for path, t in flat:
            n = t[0].numel()
            chunk = values[pos : pos + n]
            pos += n
            if not t.is_floating_point():
                chunk = [int(v) for v in chunk]
            node = node_out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = chunk if t.ndim > 1 else chunk[0]
    return out


@dataclass
class HealthReport:
    """Structured verdict of one :meth:`HealthProbe.check` call (the JAX
    package's fields).

    ``healthy`` is the conjunction of the individual detectors; ``reasons``
    carries one human-readable line per tripped detector (empty when
    healthy).  Metric fields are ``None`` when the corresponding detector
    did not apply to this state (no ``pop`` leaf, no ``sigma`` leaf, window
    not yet full, ...)."""

    generation: int
    healthy: bool
    reasons: list[str] = field(default_factory=list)
    nonfinite_leaves: dict[str, int] = field(default_factory=dict)
    diversity: float | None = None
    diversity_collapse: bool = False
    step_size_min: float | None = None
    step_size_max: float | None = None
    step_size_out_of_range: bool = False
    best_fitness: float | None = None
    stagnation_improvement: float | None = None
    stagnating: bool = False
    # Per-shard aggregation (``HealthProbe(shards=N)``; ``None`` when the
    # probe is shard-blind).
    shard_nonfinite: list[int] | None = None
    dead_shards: list[int] = field(default_factory=list)
    shard_diversity: list[float] | None = None
    collapsed_shards: list[int] = field(default_factory=list)
    # True when the unhealthy verdict came from a trend analysis rather
    # than the probe's threshold detectors — see :meth:`with_trend`.
    trend: bool = False

    def with_trend(self, reasons: Sequence[str]) -> "HealthReport":
        """A copy of this report rendered unhealthy by a trend verdict:
        ``healthy=False``, ``trend=True``, the trend reasons appended after
        any probe reasons; the metric fields are untouched."""
        return dataclasses.replace(self, healthy=False, trend=True, reasons=[*self.reasons, *reasons])


class HealthProbe:
    """Between-segment state scanner producing :class:`HealthReport`
    verdicts (the JAX package's detectors, thresholds and messages).

    Usage (standalone)::

        probe = HealthProbe(diversity_floor=1e-6, stagnation_window=5)
        report = probe.check(state, generation=120)
        if not report.healthy:
            print(report.reasons)

    Usage (supervised — the intended path)::

        runner = ResilientRunner(
            wf, "ckpts/run",
            health=HealthProbe(stagnation_window=5, stagnation_tol=1e-9),
            restart=RollbackToCheckpoint(),
        )

    Each ``check`` is one :func:`scan_state` on the state's device and one
    copy of its scalars to the host.  :meth:`check_lanes` scans a pack's
    stacked states under ``torch.func.vmap`` and copies every lane's
    scalars in one read, with a stagnation window per stable lane id (the
    service's tenant uids).  Determinism: ``check`` is a pure function of
    ``(state, the probe's stagnation window)``; the runner checkpoints the
    window, so a resumed run reaches identical verdicts.

    :param check_nonfinite: scan every floating leaf of the state for
        NaN/±Inf (key and integer/bool leaves are skipped).
    :param nonfinite_skip: path substrings (e.g. ``"archive_fit"``) whose
        leaves are exempt from the non-finite scan.
    :param diversity_floor: flag diversity collapse when the *largest*
        per-dimension std of ``state.algorithm.pop`` drops below this;
        ``None`` disables the detector.
    :param step_size_range: ``(lo, hi)`` bounds on the ``sigma`` leaf of
        the algorithm state; ``None`` disables.
    :param stagnation_window: flag stagnation when the best fitness
        improved by less than ``stagnation_tol`` over this many
        consecutive probes; ``0`` disables, and ``>= 2`` is required
        otherwise.  With a runner this counts segment boundaries.
    :param stagnation_tol: minimum improvement (in the minimizing fitness
        frame) the window must show to count as progress.
    :param shards: shard count of the distributed run this probe watches:
        adds per-shard non-finite counts and spreads, a **dead-shard**
        verdict when an entire shard's fitness is non-finite and, with
        ``diversity_floor``, a **collapsed-shard** verdict.  ``None``
        (default) disables.
    """

    def __init__(
        self,
        *,
        check_nonfinite: bool = True,
        nonfinite_skip: Sequence[str] = (),
        diversity_floor: float | None = None,
        step_size_range: tuple[float, float] | None = (1e-12, 1e6),
        stagnation_window: int = 0,
        stagnation_tol: float = 0.0,
        shards: int | None = None,
    ):
        if stagnation_window < 0 or stagnation_window == 1:
            # A window of 1 compares a value against itself: improvement is
            # identically 0 and every probe reads as stagnant.
            raise ValueError(
                f"stagnation_window must be 0 (disabled) or >= 2 (a window "
                f"of 1 cannot measure improvement), got {stagnation_window}"
            )
        if step_size_range is not None and not (step_size_range[0] <= step_size_range[1]):
            raise ValueError(f"step_size_range must be (lo, hi) with lo <= hi, got {step_size_range}")
        if shards is not None and shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.check_nonfinite = check_nonfinite
        self.nonfinite_skip = tuple(nonfinite_skip)
        self.diversity_floor = diversity_floor
        self.step_size_range = step_size_range
        self.stagnation_window = int(stagnation_window)
        self.stagnation_tol = float(stagnation_tol)
        self.shards = None if shards is None else int(shards)
        self._window: list[float] = []
        # Per-lane windows of a tenant pack, keyed by stable lane ids.
        self._lane_windows: dict[int, list[float]] = {}

    # -- host-side window (persisted via checkpoint manifests) --------------
    @property
    def window(self) -> tuple[float, ...]:
        """Best-fitness values of the most recent probes (newest last)."""
        return tuple(self._window)

    def reset(self) -> None:
        """Clear the stagnation window (a fresh run's probe history)."""
        self._window = []

    def restore(self, window: Sequence[float]) -> None:
        """Restore the stagnation window from a checkpoint manifest so a
        resumed run replays probe decisions identically."""
        self._window = [float(x) for x in window]
        if self.stagnation_window:
            del self._window[: -self.stagnation_window]

    # -- per-lane windows (multi-tenant packs) ------------------------------
    def lane_window(self, lane_id: int) -> tuple[float, ...]:
        """Best-fitness window of one pack lane (see :meth:`check_lanes`);
        empty for an unknown lane.  The service layer persists this in the
        tenant's checkpoint manifest, exactly like the runner persists
        :attr:`window`."""
        return tuple(self._lane_windows.get(int(lane_id), ()))

    def restore_lane(self, lane_id: int, window: Sequence[float]) -> None:
        """Restore one lane's stagnation window (tenant readmission), so
        the readmitted tenant replays probe decisions identically."""
        win = [float(x) for x in window]
        if self.stagnation_window:
            del win[: -self.stagnation_window]
        self._lane_windows[int(lane_id)] = win

    def reset_lane(self, lane_id: int) -> None:
        """Clear one lane's window (fresh tenant / post-restart grace —
        the per-lane analogue of :meth:`reset`)."""
        self._lane_windows.pop(int(lane_id), None)

    # -- the scan ------------------------------------------------------------
    def _scan_impl(self, state: Any) -> dict[str, Any]:
        return scan_state(
            state,
            check_nonfinite=self.check_nonfinite,
            nonfinite_skip=self.nonfinite_skip,
            diversity=self.diversity_floor is not None,
            step_size=self.step_size_range is not None,
            shards=self.shards,
        )

    def check(self, state: Any, generation: int = 0) -> HealthReport:
        """Scan ``state`` and return a :class:`HealthReport`.

        Appends to the stagnation window as a side effect — call exactly
        once per segment boundary (the runner does)."""
        return self._verdict(_to_host(self._scan_impl(state)), generation, self._window)

    def check_lanes(
        self,
        states: Any,
        generation: int = 0,
        lane_ids: Sequence[Any] | None = None,
    ) -> list[HealthReport]:
        """Per-lane verdicts for a tenant pack: ``states`` carries a
        leading lane axis (the stacked per-tenant states a ``TenantPack``
        steps), and each lane is thresholded independently — one
        :class:`HealthReport` per requested lane, in ``lane_ids`` order.

        ``lane_ids`` maps the rows to *stable* identities (the service
        passes tenant uids), so each lane's stagnation window follows its
        tenant across lane moves and eviction/readmission; ``None`` uses
        the row indices, and a sparse ``[(row, id), ...]`` probes only
        those rows.  One scan under ``torch.func.vmap`` serves every lane,
        and its scalars reach the host in ONE copy; appends to each
        requested lane's window — call once per segment boundary per
        lane."""
        from ..utils import graph

        raw = torch.func.vmap(self._scan_impl)(states)
        if lane_ids is None:
            n = graph.flatten(states)[0][0].shape[0]
            pairs = [(row, row) for row in range(n)]
        elif lane_ids and isinstance(lane_ids[0], tuple):
            pairs = [(int(r), int(i)) for r, i in lane_ids]
        else:
            pairs = list(enumerate(int(i) for i in lane_ids))
        rows = _lanes_to_host(raw, [row for row, _ in pairs])
        reports = []
        for lane_raw, (_, lane_id) in zip(rows, pairs):
            window = self._lane_windows.setdefault(lane_id, [])
            reports.append(self._verdict(lane_raw, generation, window))
        return reports

    def _verdict(self, raw: Mapping[str, Any], generation: int, window: list[float]) -> HealthReport:
        """Threshold one (host-side) metric dict into a report, advancing
        the given stagnation window in place."""
        reasons: list[str] = []

        nonfinite = {name: int(n) for name, n in raw.get("nonfinite", {}).items() if int(n) > 0}
        if nonfinite:
            listed = ", ".join(f"{k} ({v})" for k, v in sorted(nonfinite.items()))
            reasons.append(f"non-finite values in state leaves: {listed}")

        diversity = raw.get("diversity")
        diversity = None if diversity is None else float(diversity)
        diversity_collapse = (
            self.diversity_floor is not None and diversity is not None and diversity < self.diversity_floor
        )
        if diversity_collapse:
            reasons.append(
                f"population diversity collapsed: max per-dimension spread "
                f"{diversity:.3e} < floor {self.diversity_floor:.3e}"
            )

        shard_nonfinite = raw.get("shard_nonfinite")
        dead_shards: list[int] = []
        if shard_nonfinite is not None:
            shard_nonfinite = [int(n) for n in shard_nonfinite]
            shard_rows = [int(r) for r in raw["shard_rows"]]
            # A shard is dead when EVERY row it owns is non-finite; shards
            # owning zero rows (ragged tails) have nothing to be dead about.
            dead_shards = [
                s for s, (n, rows) in enumerate(zip(shard_nonfinite, shard_rows)) if rows > 0 and n == rows
            ]
            if dead_shards:
                reasons.append(f"dead shard(s) {dead_shards}: every fitness row of the shard is non-finite")
        shard_diversity = raw.get("shard_diversity")
        collapsed_shards: list[int] = []
        if shard_diversity is not None:
            shard_diversity = [float(d) for d in shard_diversity]
            if self.diversity_floor is not None:
                collapsed_shards = [s for s, d in enumerate(shard_diversity) if d < self.diversity_floor]
            if collapsed_shards:
                reasons.append(
                    f"collapsed shard(s) {collapsed_shards}: per-shard "
                    f"population spread under the "
                    f"{self.diversity_floor:.3e} floor"
                )

        ss_min = raw.get("step_size_min")
        ss_min = None if ss_min is None else float(ss_min)
        ss_max = raw.get("step_size_max")
        ss_max = None if ss_max is None else float(ss_max)
        step_size_out_of_range = False
        if self.step_size_range is not None and ss_min is not None:
            lo, hi = self.step_size_range
            # A NaN sigma is out of range too (comparisons are False, so
            # test the healthy band and negate).
            inside = (ss_min >= lo) and (ss_max <= hi)
            step_size_out_of_range = not inside
            if step_size_out_of_range:
                reasons.append(
                    f"step size out of range: sigma in [{ss_min:.3e}, "
                    f"{ss_max:.3e}], allowed [{lo:.3e}, {hi:.3e}]"
                )

        best = raw.get("best_fitness")
        best = None if best is None else float(best)
        stagnating = False
        improvement = None
        if self.stagnation_window > 0 and best is not None:
            window.append(best)
            del window[: -self.stagnation_window]
            if len(window) == self.stagnation_window:
                improvement = window[0] - window[-1]
                # NaN improvement compares False -> not flagged here; the
                # non-finite detector owns that failure mode.
                stagnating = improvement <= self.stagnation_tol
                if stagnating:
                    reasons.append(
                        f"best fitness stagnating: improvement "
                        f"{improvement:.3e} <= tol {self.stagnation_tol:.3e} "
                        f"over the last {self.stagnation_window} probes"
                    )

        return HealthReport(
            generation=int(generation),
            healthy=not reasons,
            reasons=reasons,
            nonfinite_leaves=nonfinite,
            diversity=diversity,
            diversity_collapse=diversity_collapse,
            step_size_min=ss_min,
            step_size_max=ss_max,
            step_size_out_of_range=step_size_out_of_range,
            best_fitness=best,
            stagnation_improvement=improvement,
            stagnating=stagnating,
            shard_nonfinite=shard_nonfinite,
            dead_shards=dead_shards,
            shard_diversity=shard_diversity,
            collapsed_shards=collapsed_shards,
        )
