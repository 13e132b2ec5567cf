"""CUDA graphs over fused multi-generation segments (the port's counterpart
of running generations inside one compiled ``lax.scan`` / ``fori_loop``).

:func:`run` executes ``n`` generations of a segment program as one replay
of a captured CUDA graph of all ``n`` generations:

* the program first runs one generation on a *clone* of the carry, on a
  side stream (warm-up): kernels are built, ``ctypes`` entry points looked
  up, kernel attributes and occupancy queried, all before any capture;
* the ``n`` generations are captured reading the carry from static input
  buffers;
* the caller's carry is copied into the static buffers on entry and fresh
  tensors are handed back on exit, so the caller's state is never aliased.

A graph is replayed once a segment.  A graph replayed several times would
have to copy its final carry back into its input buffers after every
replay, since a generation's outputs are fresh allocations; at the PSO
headline that copy costs most of a generation, while a graph of all ``n``
generations copies the state in and out once a segment.

A segment makes no host sync: the copies in, the replay and the copies out
are all enqueued on the current stream.  Python's cycle collector is off
while a capture is open (it could destroy a dead graph, which invalidates
the capture).  The captures of one :class:`Cache`
share one memory pool (a capture reuses the blocks its earlier generations
freed, so its pool does not grow with ``n``), and the cache keeps the
``max_graphs`` captures used last (:data:`MAX_GRAPHS` unless its owner
reserves more: a runner under self-tuning cadence keeps every length its
cadence can pick).  Sharing the pool is safe because
the replays are ordered on one stream and each replay's outputs are copied
out before the next replay.  A capture that CUDA refuses raises its error:
there is no fallback to eager execution.
"""

from __future__ import annotations

import gc
from collections import OrderedDict
from typing import Any, Callable, Mapping

import torch

from ..core import State

__all__ = ["Cache", "flatten", "unflatten", "structure", "replays", "prepare", "run"]

# Captures a cache keeps by default (each holds its outputs, one state's
# worth, in the shared pool); the least recently used one is dropped beyond
# it.
MAX_GRAPHS = 4


# -- pytrees of tensors --------------------------------------------------------
# Plain recursive functions, not closures over the leaf list: a recursive
# closure is a reference cycle that would keep every tensor it saw alive
# until Python's cycle collector runs (inside a capture, every generation's
# state).


def _flatten(t: Any, leaves: list) -> Any:
    if isinstance(t, torch.Tensor):
        leaves.append(t)
        return ("T",)
    if isinstance(t, State):
        return ("S", tuple(t.keys()), t.param_keys, tuple(_flatten(v, leaves) for v in t.values()))
    if isinstance(t, Mapping):
        return ("D", tuple(t.keys()), tuple(_flatten(v, leaves) for v in t.values()))
    if isinstance(t, tuple) and hasattr(t, "_fields"):  # a NamedTuple keeps its type
        return ("N", type(t), tuple(_flatten(v, leaves) for v in t))
    if isinstance(t, (tuple, list)):
        return ("t" if isinstance(t, tuple) else "l", tuple(_flatten(v, leaves) for v in t))
    return ("C", t)


def flatten(tree: Any) -> tuple[list[torch.Tensor], Any]:
    """The tensor leaves of a nest of ``State``/dict/NamedTuple/tuple/list,
    in order, and a hashable description of everything else."""
    leaves: list[torch.Tensor] = []
    return leaves, _flatten(tree, leaves)


def _unflatten(s: Any, it) -> Any:
    kind = s[0]
    if kind == "T":
        return next(it)
    if kind == "S":
        return State(_param_keys=s[2], **dict(zip(s[1], (_unflatten(c, it) for c in s[3]))))
    if kind == "D":
        return dict(zip(s[1], (_unflatten(c, it) for c in s[2])))
    if kind == "N":
        return s[1](*(_unflatten(c, it) for c in s[2]))
    if kind in ("t", "l"):
        items = [_unflatten(c, it) for c in s[1]]
        return tuple(items) if kind == "t" else items
    return s[1]


def unflatten(spec: Any, leaves) -> Any:
    """The inverse of :func:`flatten`."""
    return _unflatten(spec, iter(leaves))


def structure(tree: Any) -> tuple:
    """What a captured graph depends on: the nest and each leaf's shape,
    dtype and device."""
    leaves, spec = flatten(tree)
    return spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


# -- captured segments ---------------------------------------------------------


def replays(device: torch.device) -> bool:
    """Whether work on ``device`` that keeps a graph of its own (a rollout's
    loop, an HPO nest's batch) replays it: on the card, outside a capture
    (where the enclosing capture takes the work inline) and outside
    functorch transforms (whose batched tensors a graph's static buffers
    cannot hold; the work runs eagerly there)."""
    return (
        device.type == "cuda"
        and not torch.cuda.is_current_stream_capturing()
        and torch._C._functorch.peek_interpreter_stack() is None
    )


class _Captured:
    """One captured graph and its output leaves (tensors of the pool,
    rewritten by every replay)."""

    def __init__(self, graph, struct, carry_leaves, carry_spec, out_leaves, out_spec, static):
        self.graph = graph
        self.struct = struct
        self.carry_leaves = carry_leaves
        self.carry_spec = carry_spec
        self.out_leaves = out_leaves
        self.out_spec = out_spec
        self.static = static


class Cache:
    """A workflow's captured segments: at most ``max_graphs`` graphs, keyed
    by what the program depends on and the number of generations, in one
    memory pool; and the static input buffers of each carry structure,
    shared by the graphs captured for it.  ``captures`` counts the graphs
    this cache has captured."""

    def __init__(self, max_graphs: int = MAX_GRAPHS):
        self.graphs: OrderedDict[tuple, _Captured] = OrderedDict()
        self.inputs: dict[tuple, list[torch.Tensor]] = {}
        self.pool = None
        self.stream = None
        self.max_graphs = int(max_graphs)
        self.captures = 0

    def __len__(self) -> int:
        return len(self.graphs)

    def _add(self, ident: tuple, cap: _Captured) -> None:
        self.graphs[ident] = cap
        self.captures += 1
        while len(self.graphs) > self.max_graphs:
            self.graphs.popitem(last=False)
        self._prune()

    def _prune(self) -> None:
        """Drop the static buffers that no kept graph reads."""
        used = {c.struct for c in self.graphs.values()}
        for struct in [s for s in self.inputs if s not in used]:
            del self.inputs[struct]


def _capture(program: Callable, inputs, spec, leaves, struct, n: int, pool) -> _Captured:
    device = leaves[0].device
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        program(unflatten(spec, [t.clone() for t in leaves]), 1)
    current.wait_stream(side)
    torch.cuda.synchronize(device)

    # A CUDA graph destroyed while a capture is open invalidates the capture
    # (its destructor calls the driver), and a dead graph held in a
    # reference cycle (a finished runner and its workflow) is destroyed
    # whenever the cycle collector runs: keep the collector from running
    # until the capture ends.
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool):
            carry, outs, static = program(unflatten(spec, inputs), n)
    finally:
        if collecting:
            gc.enable()
    carry_leaves, carry_spec = flatten(carry)
    out_leaves, out_spec = flatten(outs)
    return _Captured(graph, struct, carry_leaves, carry_spec, out_leaves, out_spec, static)


def _captured(
    cache: Cache, key: Any, program: Callable, carry: Any, n: int, before: Callable[[], None] | None = None
) -> tuple[_Captured, list, list, bool]:
    """The capture of ``program`` for ``key``, the carry's structure and
    ``n`` (made now when the cache has none, after calling ``before``), its
    static input buffers, the carry's leaves, and whether it was captured
    by this call."""
    leaves, spec = flatten(carry)
    if not leaves:
        raise ValueError("a fused segment needs a state with tensors")
    device = leaves[0].device
    for t in leaves:
        if t.device != device or device.type != "cuda":
            raise ValueError(
                f"a fused segment on the card needs every state tensor on one CUDA device; "
                f"found {t.device} beside {device}"
            )
    struct = structure(carry)
    ident = (key, struct, n)
    inputs = cache.inputs.get(struct)
    if inputs is None:
        inputs = cache.inputs[struct] = [t.clone() for t in leaves]
    cap = cache.graphs.get(ident)
    if cap is not None:
        cache.graphs.move_to_end(ident)
        return cap, inputs, leaves, False
    if before is not None:
        before()
    if cache.pool is None:
        cache.pool = torch.cuda.graph_pool_handle()
    try:
        cap = _capture(program, inputs, spec, leaves, struct, n, cache.pool)
    except BaseException:
        cache._prune()  # a failed capture keeps no static buffers
        raise
    cache._add(ident, cap)
    return cap, inputs, leaves, True


def prepare(
    cache: Cache,
    key: Any,
    program: Callable[[Any, int], tuple[Any, Any, Any]],
    carry: Any,
    n: int,
    before: Callable[[], None] | None = None,
) -> bool:
    """Capture the graph :func:`run` would replay for these arguments,
    without replaying it; returns whether a capture was made (``False``
    when the cache already holds it).  ``before`` is called just before a
    capture (a caller quiets its other threads' CUDA work there: a capture
    refuses some of it).  The capture's warm-up generation runs on a clone
    of ``carry``, which is left as it is."""
    return _captured(cache, key, program, carry, n, before)[3]


def run(
    cache: Cache,
    key: Any,
    program: Callable[[Any, int], tuple[Any, Any, Any]],
    carry: Any,
    n: int,
) -> tuple[Any, Any, Any]:
    """``n`` generations of ``program`` as one replay of a captured CUDA
    graph (captured on the first call for ``key``, the carry's structure
    and ``n``).

    :param cache: the caller's :class:`Cache`.
    :param key: what else the captured program depends on (hashable).
    :param program: ``program(carry, n) -> (carry, outs, static)`` runs
        ``n`` generations eagerly; ``outs`` is a nest of tensors stacked
        along a leading axis of ``n``, ``static`` any Python value fixed at
        capture (returned as captured).
    :param carry: the nest of CUDA tensors that the generations evolve.
    :returns: ``(carry, outs, static)`` with fresh tensors.
    """
    cap, inputs, leaves, _ = _captured(cache, key, program, carry, n)
    device = leaves[0].device
    current = torch.cuda.current_stream(device)
    if cache.stream is not None and cache.stream != current:
        # The static buffers and the pool are shared by every call: order
        # this one after the last, made on another stream.
        current.wait_stream(cache.stream)
    cache.stream = current
    for s, t in zip(inputs, leaves):
        s.copy_(t)
    cap.graph.replay()
    carry_out = unflatten(cap.carry_spec, [t.clone() for t in cap.carry_leaves])
    return carry_out, unflatten(cap.out_spec, [t.clone() for t in cap.out_leaves]), cap.static
