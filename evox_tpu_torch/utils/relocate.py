"""A component graph rebuilt on another device.

The port's components are bound to their device when they are built: an
algorithm keeps ``device``, ``lb`` and ``ub`` there, a problem its shift
or data, a workflow and a nest their captured graphs.  JAX moves a program
to another backend by ``jax.device_put`` of its state and a re-lowering;
here the objects themselves have to move.  :func:`relocate` makes that
move as a *twin*: every object from which a tensor or a ``torch.device`` not
already on the target, or a captured graph (a ``utils.graph.Cache`` that
holds one), can be reached is copied, and in the copy

* a tensor not on the target is a copy on the target (a
  ``torch.nn.Parameter`` stays one, with its ``requires_grad``);
* a ``torch.device`` other than the target is the target;
* a graph cache that holds captures is a fresh empty one (the twin holds
  no captured graph; an empty cache is shared like any host object).

Everything else is *shared* with the original, not copied: host-side state
such as a fault injector's attempt counts, a lock, a function or a config
tuple is the same object in both.  Objects named in ``share`` are shared
whole (a monitor whose host-side history must stay one history).  Nothing
of the original changes, and an object that reaches nothing to move is
returned as it is, so relocating a twin onto its own device returns the
twin itself.

What it walks: dicts, lists, tuples and NamedTuples, bound methods,
``functools.partial`` objects and the attributes (``__dict__`` and
``__slots__``) of instances.  Functions, classes, modules and objects
without attributes are leaves: a closure over a card tensor keeps it.
"""

from __future__ import annotations

import copy
import functools
import types
from collections import defaultdict
from typing import Any, Iterable

import torch

from . import graph

__all__ = ["relocate"]

_LEAF_TYPES = (
    type(None), bool, int, float, complex, str, bytes, bytearray, range, slice, type, frozenset, set,
    types.FunctionType, types.BuiltinFunctionType, types.ModuleType, types.CodeType, torch.dtype,
    torch.Size, torch.memory_format, torch.layout,
)


def _moves(x: Any, device: torch.device) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device != device
    if isinstance(x, torch.device):
        return x != device
    return isinstance(x, graph.Cache) and bool(x.graphs or x.inputs or x.pool is not None)


def _slots(cls: type) -> list[str]:
    names = []
    for c in cls.__mro__:
        for name in getattr(c, "__slots__", ()):
            if name not in ("__dict__", "__weakref__") and name not in names:
                names.append(name)
    return names


def _children(x: Any) -> list[Any]:
    """The objects ``x`` holds that the walk visits (empty for a leaf)."""
    if isinstance(x, _LEAF_TYPES) or isinstance(x, torch.Tensor):
        return []
    if isinstance(x, dict):
        return list(x.values())
    if isinstance(x, (list, tuple)):
        if isinstance(x, tuple) and type(x) is not tuple and not hasattr(x, "_fields"):
            return []
        return list(x)
    if isinstance(x, types.MethodType):
        return [x.__self__]
    if isinstance(x, functools.partial):
        return [x.func, *x.args, *x.keywords.values()]
    out = list(vars(x).values()) if hasattr(x, "__dict__") else []
    for name in _slots(type(x)):
        try:
            out.append(getattr(x, name))
        except AttributeError:
            pass
    return out


def relocate(obj: Any, device: str | torch.device, *, share: Iterable[Any] = ()) -> Any:
    """The twin of ``obj`` on ``device`` (see the module docstring): the
    objects that hold what must move are copied, the rest is shared.

    :param obj: a component (a workflow, an algorithm, a problem chain) or
        a state.
    :param device: the twin's device.
    :param share: objects shared whole with the twin, never copied or
        walked (a monitor's history).
    """
    device = torch.device(device)
    shared = {id(o) for o in share}
    seen: dict[int, Any] = {}
    parents: dict[int, list[int]] = defaultdict(list)
    moving: list[int] = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if id(x) in seen:
            continue
        seen[id(x)] = x
        if _moves(x, device):
            moving.append(id(x))
            continue
        if id(x) in shared:
            continue
        for child in _children(x):
            parents[id(child)].append(id(x))
            stack.append(child)
    need = set(moving)
    frontier = list(moving)
    while frontier:
        for p in parents[frontier.pop()]:
            if p not in need:
                need.add(p)
                frontier.append(p)
    memo: dict[int, Any] = {}

    def build(x: Any) -> Any:
        key = id(x)
        if key not in need:
            return x
        if key in memo:
            return memo[key]
        if isinstance(x, torch.Tensor):
            moved = x.detach().to(device)
            if isinstance(x, torch.nn.Parameter):
                moved = torch.nn.Parameter(moved, requires_grad=x.requires_grad)
            elif x.requires_grad:
                moved.requires_grad_(True)
            out = moved
        elif isinstance(x, torch.device):
            out = device
        elif isinstance(x, graph.Cache):
            out = graph.Cache(x.max_graphs)
        elif isinstance(x, dict):
            out = memo[key] = copy.copy(x)
            for k, v in x.items():
                dict.__setitem__(out, k, build(v))
        elif isinstance(x, list):
            out = memo[key] = type(x).__new__(type(x))
            list.extend(out, [build(v) for v in x])
        elif isinstance(x, tuple):
            items = [build(v) for v in x]
            out = type(x)._make(items) if hasattr(x, "_fields") else tuple(items)
        elif isinstance(x, types.MethodType):
            out = types.MethodType(x.__func__, build(x.__self__))
        elif isinstance(x, functools.partial):
            out = functools.partial(build(x.func), *[build(a) for a in x.args],
                                    **{k: build(v) for k, v in x.keywords.items()})
        else:
            cls = type(x)
            out = memo[key] = object.__new__(cls) if cls.__new__ is object.__new__ else cls.__new__(cls)
            if hasattr(x, "__dict__"):
                out.__dict__.update({k: build(v) for k, v in vars(x).items()})
            for name in _slots(cls):
                try:
                    value = getattr(x, name)
                except AttributeError:
                    continue
                object.__setattr__(out, name, build(value))
        memo[key] = out
        return out

    return build(obj)
