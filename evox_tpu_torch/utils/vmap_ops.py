"""Operators with batching rules (counterpart of ``evox_tpu/utils/vmap_ops.py``).

JAX gives a function a batching rule with ``jax.custom_batching`` and runs
host code inside a program with ``pure_callback``/``io_callback``.  Here
both are ``torch.library`` custom operators, which ``torch.func.vmap``
treats as opaque and hands to the rule registered for them:

* :func:`register_vmap_op` makes a function an operator
  ``evox_tpu_torch::<name>``.  With no rule it is mapped sequentially, one
  call per instance, as ``jax.custom_batching.sequential_vmap`` does; a rule
  ``vmap_fn(info, in_dims, *args) -> (out, out_dims)`` takes
  ``torch.library.register_vmap``'s signature (``info.batch_size``,
  ``info.randomness``: the facts JAX's ``VmapInfo`` carries).  Nested vmap
  composes: inside a rule, a call of an operator whose arguments are still
  batched at an outer level goes through that level's rule.
* :func:`host_op` wraps a host-side function (a history sink, a log) as
  one operator call that vmap maps sequentially, so no batched tensor
  escapes into host code.

Every kernel entry point of :mod:`evox_tpu_torch.ops` is such an operator:
the PSO move and the Philox draws with batched rules (one launch for the
whole instance batch), the others with the sequential one.
"""

from __future__ import annotations

import itertools
import re
import weakref
from typing import Any, Callable, NamedTuple, Sequence

import torch

__all__ = ["register_vmap_op", "sequential_rule", "host_op", "VmapInfo"]


class VmapInfo(NamedTuple):
    """Batching metadata of a rule: the fields of the ``info`` that
    ``torch.library.register_vmap`` hands a rule (torch's own
    ``VmapInfo``), with the JAX package's default ``randomness``."""

    batch_size: int
    randomness: str = "different"


NAMESPACE = "evox_tpu_torch"

_names = itertools.count()


def _slice(arg: Any, dim: Any, b: int) -> Any:
    """Instance ``b`` of one operator argument batched along ``dim``."""
    if dim is None:
        return arg
    if isinstance(arg, (list, tuple)):
        return type(arg)(_slice(a, d, b) for a, d in zip(arg, dim))
    # Contiguous: the kernels behind the operators take contiguous operands.
    return arg.select(dim, b).contiguous()


def _stacked(outs: list) -> tuple[Any, Any]:
    """Per-instance outputs stacked along a new leading axis, with their
    ``out_dims``."""
    first = outs[0]
    if first is None:
        return None, None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs), 0
    cols = [torch.stack([o[i] for o in outs]) for i in range(len(first))]
    return type(first)(cols), type(first)(0 for _ in cols)


def sequential_rule(op: Callable) -> Callable:
    """The default batching rule of :func:`register_vmap_op`: ``op`` once
    per instance, the outputs stacked."""

    def rule(info, in_dims, *args):
        return _stacked([op(*(_slice(a, d, b) for a, d in zip(args, in_dims))) for b in range(info.batch_size)])

    return rule


def _op_name(name: str | None, fn: Callable) -> str:
    if name is not None:
        return name
    # A unique name: two functions of one name may both be registered.
    return f"{re.sub(r'[^0-9A-Za-z_]', '_', fn.__name__)}_{next(_names)}"


def register_vmap_op(vmap_fn: Callable | None = None, *, name: str | None = None):
    """Decorator: make ``fn`` (type-annotated, as ``torch.library.
    custom_op`` asks) the operator ``evox_tpu_torch::<name>`` with the
    batching rule ``vmap_fn`` — ``vmap_fn(info, in_dims, *args) -> (out,
    out_dims)`` — or, without one, :func:`sequential_rule`.  Returns the
    operator; called outside vmap it runs ``fn``."""

    def decorator(fn: Callable) -> Callable:
        op = torch.library.custom_op(f"{NAMESPACE}::{_op_name(name, fn)}", mutates_args=())(fn)
        torch.library.register_vmap(op, vmap_fn if vmap_fn is not None else sequential_rule(op))
        return op

    return decorator


# -- host functions --------------------------------------------------------------


class _HostFn:
    """A host function behind :func:`host_op`, and what its last call
    returned (a tensor, a tuple of them, or None)."""

    def __init__(self, fn: Callable, ordered: bool, result_shape_dtypes: Any):
        self.fn = fn
        self.ordered = ordered
        self.result_shape_dtypes = result_shape_dtypes
        self.kind = None

    def __call__(self, args: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a host op cannot run inside a CUDA graph capture: it would run once at capture, "
                "never at replay (a fused segment hands the monitor's history over as telemetry)"
            )
        out = self.fn(*args)
        if out is None:
            self.kind, outs = None, []
        elif isinstance(out, torch.Tensor):
            self.kind, outs = "tensor", [out]
        else:
            self.kind, outs = "tuple", list(out)
        if self.result_shape_dtypes is not None:
            want = self.result_shape_dtypes
            single = len(want) == 2 and isinstance(want[1], torch.dtype)
            want = [want] if single else list(want)
            got = [(tuple(o.shape), o.dtype) for o in outs]
            if got != [(tuple(s), d) for s, d in want]:
                raise ValueError(f"host op returned {got}, declared {want}")
        # An operator's output may not alias its input.
        inputs = {a.data_ptr() for a in args if a.numel()}
        return [o.clone() if o.numel() and o.data_ptr() in inputs else o for o in outs]


# Handle -> _HostFn; the callable that host_op returns holds its _HostFn.
_HOST_FNS: "weakref.WeakValueDictionary[int, _HostFn]" = weakref.WeakValueDictionary()


@torch.library.custom_op(f"{NAMESPACE}::host_call", mutates_args=())
def _host_call(handle: int, args: list[torch.Tensor]) -> list[torch.Tensor]:
    return _HOST_FNS[handle](args)


def _host_call_rule(info, in_dims, handle, args):
    if _HOST_FNS[handle].ordered:
        raise ValueError(
            "an ordered host op cannot be vmapped (as jax's ordered io_callback); use ordered=False "
            "(EvalMonitor(ordered=False, num_instances=N) under a vmapped workflow)"
        )
    (arg_dims,) = in_dims[1:]
    outs = [_host_call(handle, _slice(args, arg_dims, b)) for b in range(info.batch_size)]
    if not outs[0]:
        return [], []
    cols = [torch.stack([o[i] for o in outs]) for i in range(len(outs[0]))]
    return cols, [0] * len(cols)


torch.library.register_vmap(_host_call, _host_call_rule)


def host_op(fn: Callable, result_shape_dtypes: Any = None, *, ordered: bool = False) -> Callable:
    """Wrap the host function ``fn(*tensors)`` (returning None, a tensor or a
    tuple of tensors) as one operator call.  ``fn`` receives the tensors as
    they are, on their device: it may keep them without a copy or a wait
    for the card.  Under ``torch.func.vmap`` it is called once per
    instance with that instance's slices, and its outputs are stacked.

    :param result_shape_dtypes: optional ``(shape, dtype)`` or a list of
        them: the outputs ``fn`` must return (checked on every call).
    :param ordered: the counterpart of JAX's ordered ``io_callback``: calls
        run in program order (PyTorch runs eagerly, so they always do), and
        such an op refuses vmap, as JAX's does.

    A host op refuses a CUDA graph capture: it would run once at capture
    and never at replay."""
    host = _HostFn(fn, ordered, result_shape_dtypes)
    handle = id(host)
    _HOST_FNS[handle] = host

    def call(*args: torch.Tensor):
        outs = _host_call(handle, list(args))
        if host.kind is None:
            return None
        return outs[0] if host.kind == "tensor" else tuple(outs)

    call.host = host  # keeps the _HostFn (and its handle) alive with the callable
    return call
