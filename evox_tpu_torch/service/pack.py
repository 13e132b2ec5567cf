"""Tenant-packed execution: many independent runs, one program (counterpart
of ``evox_tpu/service/pack.py``).

A :class:`TenantPack` owns a fixed number of **lanes** and one bucket
template :class:`~evox_tpu_torch.workflows.StdWorkflow`.  Every occupied
lane holds one tenant's full workflow state, stacked along a leading lane
axis, and a segment advances ALL lanes together: ``n_steps`` generations,
each ``torch.func.vmap`` of the workflow's segment generation
(``StdWorkflow._generation`` with ``SegmentConfig(lane_freeze=True)``:
quarantine, monitor counters, captured history and the per-lane early stop)
over the stacked carry ``(states, frozen, executed)``.  On the card the
``n_steps`` generations are ONE captured CUDA graph (``utils/graph.py``),
replayed once a segment; on the CPU they run eagerly.  The segment's
telemetry reaches the host in one copy for the whole pack.

**The bulkhead.**  Lanes are vmap batch members: the program holds no
cross-lane operation, so one tenant's NaN burst, plateau, or frozen lane
cannot perturb a cotenant's *values* — and because every lane runs the same
select body, a tenant's trajectory is the same bits whether its neighbours
are healthy, faulty, frozen, or empty padding.  Three freeze channels share
one mechanism:

* **in-segment early stop** — a lane whose state turns unhealthy freezes
  itself (its later generations are selected away), per lane;
* **eviction/quarantine** — the boundary writes the lane's entry of the
  ``frozen`` mask, a leaf of the segment's carry that the graph's replay
  copies into its static buffers: freezing or thawing a lane never
  recaptures anything;
* **empty lanes** — unoccupied slots are frozen copies of an occupied state
  (``parallel.pad_population`` over the lane axis), so a ragged bucket runs
  the full-width program.

A frozen lane's generations still launch (a graph cannot skip work): their
values, keys included, are selected away.

**Packs of nests.**  An HPO tenant's problem is a
:class:`~evox_tpu_torch.hpo.NestedProblem`, whose evaluation is itself one
or two levels of ``torch.func.vmap`` over inner runs.  In a pack it runs
inline at every level (no nest captures a graph of its own: the segment's
generations run under the lane vmap, and a capture's warm-up runs its
nests inline), and the kernels' batching rules merge the lanes' and the
candidates' instances into one launch a call.

Admission and eviction are **indexed writes at segment boundaries**: a
tenant's state is written into / read out of its lane, with the one
single-lane ``init_step`` program (captured once per bucket) covering fresh
admissions.  No admission, retirement or freeze changes the segment
program.  A bucket whose problem calls the host (a lane delay) cannot be
captured: its segments step eagerly on the card, and the pack says so.
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Any, Sequence

import numpy as np
import torch

from ..core import State
from ..parallel import pad_population
from ..resilience.restart import _map_with_path
from ..utils import graph
from ..workflows.std_workflow import _stack

__all__ = ["TenantPack", "assign_fault_lane"]

def assign_fault_lane(state: State, uid: int) -> State:
    """Stamp a tenant's stable uid into every ``fault_lane`` leaf of its
    state (the :class:`~evox_tpu_torch.resilience.FaultyProblem`
    tenant-keyed chaos hook).  A state without such leaves passes through
    unchanged."""

    def stamp(path, leaf):
        if path.rsplit("/", 1)[-1] == "fault_lane" and isinstance(leaf, torch.Tensor):
            # A fill, not a copy from the host; full_like keeps any leading
            # axis of a nested state.
            return torch.full_like(leaf, int(uid))
        return leaf

    return _map_with_path(state, stamp)


def _device_of(state: Any) -> torch.device:
    leaves, _ = graph.flatten(state)
    if not leaves:
        raise ValueError("a tenant state needs tensors")
    device = leaves[0].device
    for t in leaves:
        if t.device != device:
            raise ValueError(f"a tenant state must lie on one device; found {t.device} beside {device}")
    return device


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor copied to the host in ONE copy (their
    bytes concatenated on the device); a tree already on the host comes
    back as it is."""
    leaves, spec = graph.flatten(tree)
    if not leaves or all(t.device.type == "cpu" for t in leaves):
        return tree
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in leaves if t.numel()]
    buf = torch.cat(flat).cpu() if flat else None
    out, pos = [], 0
    for t in leaves:
        if not t.numel():
            out.append(torch.empty(t.shape, dtype=t.dtype))
            continue
        nbytes = t.numel() * t.element_size()
        out.append(buf[pos : pos + nbytes].clone().view(t.dtype).reshape(t.shape))
        pos += nbytes
    return graph.unflatten(spec, out)


class TenantPack:
    """A fixed-width pack of fault-isolated tenant lanes over one bucket
    template workflow.

    The pack is a *device-side* structure: it owns the stacked lane states,
    the frozen mask, and the captured programs (one
    :class:`~evox_tpu_torch.utils.graph.Cache`, one memory pool).
    Scheduling — which tenant sits in which lane, verdicts, checkpoints —
    belongs to :class:`~evox_tpu_torch.service.OptimizationService`.

    :param workflow: the bucket template
        :class:`~evox_tpu_torch.workflows.StdWorkflow` (one program for
        every lane; per-tenant values live in lane state).
    :param lanes: pack width, fixed at construction.
    :param health: optional probe-config object
        (:class:`~evox_tpu_torch.resilience.HealthProbe`), wired into the
        segment config so the in-segment early-stop thresholds mirror the
        boundary verdicts.
    :param early_stop: carry the per-lane unhealthy-state early stop in the
        segment (default True).
    :param flight: batch the flight recorder's per-generation signals out
        of the segment as ``telemetry["flight"]`` with a leading lane axis.
    """

    def __init__(
        self,
        workflow: Any,
        lanes: int,
        *,
        health: Any | None = None,
        early_stop: bool = True,
        flight: bool = False,
    ):
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if not hasattr(workflow, "_generation"):
            raise ValueError(
                f"TenantPack needs a workflow exposing the segment generation "
                f"(_generation); got {type(workflow).__name__}"
            )
        self.workflow = workflow
        self.lanes = int(lanes)
        self.health = health
        self.cfg = workflow.segment_config(
            health=health,
            metrics=False,
            stop_on_unhealthy=bool(early_stop),
            barrier=False,
            lane_freeze=True,
            flight=bool(flight),
        )
        self._states: State | None = None
        self._frozen = np.ones((self.lanes,), dtype=bool)
        self._frozen_dev: torch.Tensor | None = None
        self.device: torch.device | None = None
        self.occupants: list[int | None] = [None] * self.lanes
        # Sink sites of the single-lane init program, fixed by its first run.
        self._init_meta: list = []
        self._graphs = graph.Cache()
        # Captures made, by program ("init", "segment").
        self.captures = {"init": 0, "segment": 0}
        # Provenance of each prewarmed program ("init", or a segment
        # length): True when its capture record came from the persistent
        # cache.  A re-prewarm reports where a program ACTUALLY came from.
        self._from_cache: dict[Any, bool] = {}
        self._warned_eager = False
        self._init_program = self._make_init_program()
        self._segment_program = self._make_segment_program()

    # -- programs -------------------------------------------------------------
    def _make_init_program(self):
        wf = self.workflow

        def program(carry: tuple, n: int):
            meta: list = []
            new_state, ys = wf._capture_step(carry[0], meta, True, which="init_step")
            # Length-1 batches, as a segment's sinks.
            return (new_state,), {"sinks": tuple(tuple(x.unsqueeze(0) for x in site) for site in ys)}, meta

        return program

    def _make_segment_program(self):
        generation = self.workflow._generation(self.cfg)

        def program(carry: tuple, n: int):
            meta: list = []
            step = torch.func.vmap(lambda c: generation(c, meta))
            outs = []
            for _ in range(n):
                carry, out = step(carry)
                outs.append(out)
            # (lanes, n, ...), as JAX's vmapped scan.
            return carry, _stack(outs, 1), list(meta)

        return program

    @property
    def capturable(self) -> bool:
        """Whether the pack's programs can be captured in a CUDA graph: not
        when the problem calls the host (a lane delay, a host fault) or the
        history is recorded generation by generation."""
        return bool(getattr(self.workflow.problem, "capturable", True)) and self.cfg.capture_history

    def _replays(self, device: torch.device) -> bool:
        if device.type != "cuda":
            return False
        if not self.capturable:
            if not self._warned_eager:
                self._warned_eager = True
                warnings.warn(
                    f"TenantPack over {type(self.workflow.problem).__name__}: the evaluation calls the host, "
                    f"so this bucket's segments step eagerly on the card (no CUDA graph)"
                )
            return False
        return True

    def _run(self, kind: str, program, carry: tuple, n: int):
        device = _device_of(carry)
        if not self._replays(device):
            return program(carry, n)
        before = self._graphs.captures
        out = graph.run(self._graphs, ("pack_" + kind, self.cfg), program, carry, n)
        self.captures[kind] += self._graphs.captures - before
        return out

    # -- zero cold-start ----------------------------------------------------
    def prewarm(
        self,
        example_state: State,
        n_steps: int | Sequence[int],
        *,
        cache: Any | None = None,
        label: str = "bucket",
    ) -> dict[str, bool]:
        """Capture the pack's programs ahead of the first admission: the
        single-lane init program on ``example_state`` (one *pre-init*
        tenant-shaped workflow state; values are irrelevant, only
        structure, shapes and dtypes key the programs), then the segment of
        each length in ``n_steps`` over the init's result stacked to the
        pack's width.  The counterpart of JAX's ahead-of-time compile; on
        the CPU nothing is captured and only the init's sink sites are
        recorded.  The pack's graph cache is sized to keep every program
        prewarmed, so a change of cadence never captures mid-run.

        :param cache: an :class:`~evox_tpu_torch.utils.ExecutableCache`.
            A program whose capture record it holds is a hit (its kernel
            libraries come from the cache, so no ``nvcc`` runs) and is
            captured; a program it lacks is captured and its record saved.
            The labels are salted with the segment config, as the JAX
            package's.

        Returns ``{program_label: loaded_from_cache}`` — on a rerun, where
        each program came from when it was first prewarmed.
        """
        from ..utils.exec_cache import abstract_signature

        lengths = [int(n_steps)] if isinstance(n_steps, int) else sorted({int(n) for n in n_steps})
        for n in lengths:
            if n < 1:
                raise ValueError(f"n_steps must be >= 1, got {n}")
        prewarmed = {k for k in self._from_cache if k != "init"}
        self._graphs.max_graphs = max(self._graphs.max_graphs, len(prewarmed | set(lengths)) + 1)
        # The segment config changes the program (flight telemetry adds
        # outputs) but not the input signature: part of the label.
        cfg_tag = hashlib.sha256(repr(self.cfg).encode()).hexdigest()[:8]
        init_label = f"pack_init[{label}][lanes={self.lanes}][cfg={cfg_tag}]"
        leaves, spec = graph.flatten(example_state)
        held: dict = {}

        def init() -> None:
            held["post"], _, _ = self.init_tenant(graph.unflatten(spec, [t.clone() for t in leaves]))

        results = {init_label: self._prewarmed("init", cache, init_label, abstract_signature(example_state), init)}
        post = held["post"]
        device = _device_of(post)
        post_leaves, post_spec = graph.flatten(post)
        stacked = graph.unflatten(post_spec, [torch.stack([t] * self.lanes) for t in post_leaves])
        carry = (
            stacked,
            torch.ones((self.lanes,), dtype=torch.bool, device=device),
            torch.zeros((self.lanes,), dtype=torch.int32, device=device),
        )
        for n in lengths:

            def segment(n=n) -> None:
                if self._replays(device):
                    before = self._graphs.captures
                    graph.prepare(self._graphs, ("pack_segment", self.cfg), self._segment_program, carry, n)
                    self.captures["segment"] += self._graphs.captures - before

            seg_label = f"pack_segment[{label}][lanes={self.lanes}][cfg={cfg_tag}][n={n}]"
            results[seg_label] = self._prewarmed(n, cache, seg_label, abstract_signature(carry), segment)
        return results

    def _prewarmed(self, key: Any, cache: Any | None, label: str, signature: tuple, prepare) -> bool:
        """Prewarm one program through the persistent cache: look its
        capture record up, ``prepare()`` it (the capture, a no-op once
        made), and save the record of a miss.  A program prewarmed before
        keeps its first provenance and is not looked up again.  Returns
        whether the record came from the cache."""
        if key in self._from_cache:
            prepare()
            return self._from_cache[key]
        hit = cache is not None and cache.load(label, signature) is not None
        prepare()
        if cache is not None and not hit:
            from ..utils.exec_cache import capture_record

            cache.save(label, signature, capture_record())
        self._from_cache[key] = hit
        return hit

    # -- occupancy ----------------------------------------------------------
    @property
    def frozen_mask(self) -> np.ndarray:
        """Copy of the per-lane frozen mask (True = no-op generations)."""
        return self._frozen.copy()

    def free_lanes(self) -> list[int]:
        """Unoccupied lane indices, lowest first."""
        return [i for i, uid in enumerate(self.occupants) if uid is None]

    def occupied_lanes(self) -> list[tuple[int, int]]:
        """``[(lane, uid), ...]`` for every occupied lane."""
        return [(i, uid) for i, uid in enumerate(self.occupants) if uid is not None]

    def active_lanes(self) -> list[tuple[int, int]]:
        """Occupied lanes that are not frozen (will actually step)."""
        return [(i, uid) for i, uid in self.occupied_lanes() if not self._frozen[i]]

    # -- lane surgery -------------------------------------------------------
    def _check_device(self, state: Any) -> torch.device:
        device = _device_of(state)
        if self.device is not None and device != self.device:
            raise ValueError(
                f"TenantPack lanes share one device: this pack's tenants are on {self.device}, the state is on "
                f"{device} (a pack of mixed devices is refused; nothing is moved)"
            )
        return device

    def init_tenant(self, state: State) -> tuple[State, list, list]:
        """Run the single-lane ``init_step`` program on a freshly set-up
        tenant state (generation 1) — the same program for every admission
        into this bucket (one capture on the card), so a tenant's first
        generation is identical however full the pack is.

        Returns ``(state, sink_meta, sinks)``: the init generation's
        captured history payloads as length-1 batches on the host, ready
        for ``EvalMonitor.ingest_sinks`` (the caller routes them to the
        admitted tenant's monitor)."""
        self._check_device(state)
        carry, outs, meta = self._run("init", self._init_program, (state,), 1)
        self._init_meta = list(meta)
        sinks = [tuple(site) for site in to_host(outs["sinks"])]
        return carry[0], list(meta), sinks

    def admit(self, state: State, uid: int, *, frozen: bool = False) -> int:
        """Write a tenant's (post-init or checkpoint-restored) state into
        the first free lane; returns the lane index.  Raises when full, or
        when the state lies on another device than the pack's tenants."""
        free = self.free_lanes()
        if not free:
            raise RuntimeError(f"pack is full ({self.lanes} lanes); retire or evict a tenant before admitting")
        device = self._check_device(state)
        lane = free[0]
        if self._states is None:
            # First admission builds the stacked axis: one real row, padded
            # to the pack width with frozen copies (pad_population repeats
            # the last row — valid values for any program, never stepped).
            leaves, spec = graph.flatten(state)
            stacked = graph.unflatten(spec, [torch.stack([t]) for t in leaves])
            self._states, _ = pad_population(stacked, self.lanes)
            self.device = device
            self._frozen_dev = torch.ones((self.lanes,), dtype=torch.bool, device=device)
            if lane != 0:  # pragma: no cover - the first free lane is 0 here
                raise AssertionError("first admission must land in lane 0")
        else:
            self._write_lane(lane, state)
        self.occupants[lane] = int(uid)
        self.set_frozen(lane, frozen)
        return lane

    def _write_lane(self, lane: int, state: State) -> None:
        packed, spec = graph.flatten(self._states)
        rows, row_spec = graph.flatten(state)
        if row_spec != spec or len(rows) != len(packed):
            raise ValueError("the tenant state's structure differs from the pack's lanes")
        for p, r in zip(packed, rows):
            if tuple(p.shape[1:]) != tuple(r.shape) or p.dtype != r.dtype:
                raise ValueError(
                    f"a lane holds {p.dtype}{list(p.shape[1:])}; the tenant state gives {r.dtype}{list(r.shape)}"
                )
            p[lane] = r

    def lane_state(self, lane: int) -> State:
        """The full workflow state of one lane (a copy)."""
        if self._states is None:
            raise RuntimeError("pack has no admitted tenants")
        leaves, spec = graph.flatten(self._states)
        return graph.unflatten(spec, [t[lane].clone() for t in leaves])

    def write_lane(self, lane: int, state: State) -> None:
        """Overwrite one lane's state in place (restarts, restores)."""
        if self._states is None:
            raise RuntimeError("pack has no admitted tenants")
        self._check_device(state)
        self._write_lane(lane, state)

    def release(self, lane: int) -> None:
        """Free a lane (retirement/eviction): it freezes and its slot can
        be re-admitted into.  The stale state stays as inert padding."""
        self.occupants[lane] = None
        self.set_frozen(lane, True)

    def set_frozen(self, lane: int, frozen: bool) -> None:
        """Freeze or thaw one lane — mask data (a fill on the card), never
        a recapture."""
        self._frozen[lane] = bool(frozen)
        if self._frozen_dev is not None:
            self._frozen_dev[lane] = bool(frozen)

    # -- stepping -----------------------------------------------------------
    def run_segment(self, n_steps: int) -> State:
        """Advance every non-frozen lane ``n_steps`` generations as ONE
        vmapped segment (one replay of its captured graph on the card);
        frozen lanes ride along as no-ops.  Returns the telemetry on the
        host, read in one copy for the whole pack: ``executed``/``stopped``
        per lane, the captured history batches (demux with
        ``EvalMonitor.ingest_sinks(..., lane=i)``), ``best_fitness``,
        ``flight`` when on, and ``sink_meta``."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        if self._states is None:
            raise RuntimeError("pack has no admitted tenants")
        carry = (
            self._states,
            self._frozen_dev,
            torch.zeros((self.lanes,), dtype=torch.int32, device=self.device),
        )
        (states, stopped, executed), outs, meta = self._run("segment", self._segment_program, carry, int(n_steps))
        self._states = states
        telemetry: dict[str, Any] = {"stopped": stopped, "executed": executed, "sinks": outs["sinks"]}
        for k in ("best_fitness", "flight"):
            if k in outs:
                telemetry[k] = outs[k]
        telemetry = to_host(telemetry)
        telemetry["sink_meta"] = torch.tensor(meta, dtype=torch.int32).reshape(len(meta), 2)
        return State(**telemetry)

    def check_lanes(self, probe: Any, generation: int = 0, lanes: Sequence[int] | None = None) -> dict[int, Any]:
        """Boundary health verdicts — ``{lane: HealthReport}`` via the
        probe's lane-aware scan (one read of every lane's scalars), windows
        keyed on tenant uid (stable across lane moves).  ``lanes``
        restricts which occupied lanes are probed: a frozen lane's
        unchanged state must not keep feeding its stagnation window."""
        pairs = self.occupied_lanes()
        if lanes is not None:
            allowed = set(lanes)
            pairs = [(l, u) for l, u in pairs if l in allowed]
        if not pairs:
            return {}
        reports = probe.check_lanes(self._states, generation=generation, lane_ids=pairs)
        return {lane: rep for (lane, _), rep in zip(pairs, reports)}
