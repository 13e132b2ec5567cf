"""Immutable state containers (counterpart of ``evox_tpu/core/state.py``).

Evolving values live in an immutable :class:`State` mapping and every
component method is a function ``state -> state``.  Leaves are tensors.

* :class:`Parameter` labels an HPO-tunable hyperparameter; the label is
  recorded in the ``State`` so :func:`get_params`/:func:`set_params` can
  expose exactly the tunable subtree.
* :class:`Mutable` labels evolving state; every non-``Parameter`` leaf is
  mutable, so the wrapper is accepted for parity and adds no behaviour.

A ``State`` is a ``torch.utils._pytree`` node (its values are the children,
its keys and hyperparameter labels the context), so ``torch.func.vmap``
maps over stacked states as ``jax.vmap`` maps over JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Mapping

import torch
import torch.utils._pytree as pytree

__all__ = [
    "Parameter",
    "Mutable",
    "State",
    "get_params",
    "set_params",
    "use_state",
]


class Parameter:
    """Marks a value as an HPO-visible hyperparameter when building a State."""

    __slots__ = ("value",)

    def __init__(self, value: Any, dtype=None, device=None):
        self.value = torch.as_tensor(value, dtype=dtype, device=device)


class Mutable:
    """Marks a value as evolving state (accepted for API parity; all
    non-Parameter State leaves are mutable by construction)."""

    __slots__ = ("value",)

    def __init__(self, value: Any, dtype=None, device=None):
        self.value = torch.as_tensor(value, dtype=dtype, device=device)


def _convert(v: Any) -> Any:
    if isinstance(v, (Parameter, Mutable)):
        return v.value
    return v


class State(Mapping):
    """An immutable, ordered, attribute-accessible mapping.

    ``State(w=Parameter(0.6), pop=pop)`` records ``{"w"}`` as the set of
    hyperparameter keys.  Values may be tensors, other values, or nested
    ``State`` objects (a workflow state holds algorithm/problem/monitor
    sub-states)."""

    __slots__ = ("_data", "_param_keys")

    def __init__(self, _param_keys: frozenset[str] | None = None, **kwargs: Any):
        params = set(_param_keys or ())
        data = {}
        for k, v in kwargs.items():
            if isinstance(v, Parameter):
                params.add(k)
            data[k] = _convert(v)
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_param_keys", frozenset(params))

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __getattr__(self, key: str) -> Any:
        # Never resolve dunder/slot names through _data: during unpickling
        # the _data slot is not yet set and lookups fall through to here.
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any):
        raise AttributeError("State is immutable; use .replace(**updates)")

    def __getstate__(self):
        return (self._data, self._param_keys)

    def __setstate__(self, state):
        data, params = state
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_param_keys", params)

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}{'*' if k in self._param_keys else ''}={_short(v)}"
            for k, v in self._data.items()
        )
        return f"State({inner})"

    # -- functional update --------------------------------------------------
    def replace(self, **updates: Any) -> "State":
        """Return a new State with the given fields replaced (new Parameter
        wrappers extend the param-key set)."""
        data = dict(self._data)
        params = set(self._param_keys)
        for k, v in updates.items():
            if isinstance(v, Parameter):
                params.add(k)
            data[k] = _convert(v)
        new = object.__new__(State)
        object.__setattr__(new, "_data", data)
        object.__setattr__(new, "_param_keys", frozenset(params))
        return new

    @property
    def param_keys(self) -> frozenset[str]:
        """Names of the fields labeled as HPO-tunable ``Parameter``s."""
        return self._param_keys


def _flatten(state: State) -> tuple[list, tuple]:
    return list(state._data.values()), (tuple(state._data), state._param_keys)


def _unflatten(values, context: tuple) -> State:
    keys, params = context
    return State(_param_keys=params, **dict(zip(keys, values)))


pytree.register_pytree_node(
    State,
    _flatten,
    _unflatten,
    serialized_type_name="evox_tpu_torch.core.state.State",
    flatten_with_keys_fn=lambda s: ([(pytree.MappingKey(k), v) for k, v in s._data.items()],
                                    (tuple(s._data), s._param_keys)),
)


def _short(v: Any) -> str:
    if isinstance(v, torch.Tensor):
        return f"{v.dtype}{list(v.shape)}@{v.device}"
    return repr(v)


def get_params(state: State, prefix: str = "") -> dict[str, Any]:
    """Collect all Parameter-labeled leaves of a (nested) State as a flat
    ``{"path.to.param": value}`` dict."""
    out: dict[str, Any] = {}
    for k, v in state.items():
        path = f"{prefix}{k}"
        if isinstance(v, State):
            out.update(get_params(v, path + "."))
        elif k in state.param_keys:
            out[path] = v
    return out


def set_params(state: State, params: Mapping[str, Any]) -> State:
    """Return a new State with the given ``{"path.to.param": value}`` entries
    replaced. Unknown paths raise ``KeyError``."""
    updates: dict[str, Any] = {}
    nested: dict[str, dict[str, Any]] = {}
    for path, v in params.items():
        head, _, rest = path.partition(".")
        if rest:
            nested.setdefault(head, {})[rest] = v
        else:
            if head not in state.param_keys:
                raise KeyError(f"{head!r} is not a Parameter of {state!r}")
            updates[head] = v
    for head, sub in nested.items():
        child = state[head]
        if not isinstance(child, State):
            raise KeyError(f"{head!r} is not a nested State")
        updates[head] = set_params(child, sub)
    return state.replace(**updates)


def use_state(fn: Callable, /) -> Callable:
    """API-parity shim: every component method is already a function
    ``(state, ...) -> state``, so this is the identity."""
    return fn
