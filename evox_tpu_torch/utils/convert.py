"""Carry a state or model parameters across from numpy.

:func:`state_from_numpy` turns a nested dict of numpy arrays (for example
one written out from a JAX package ``State``) into the port's
:class:`~evox_tpu_torch.core.State`; :func:`params_from_numpy` turns a
parameter tree (for example the JAX package's ``MLPPolicy.init`` output,
``{"w0": ..., "b0": ...}``) into the same tree of tensors.  The port never
sees JAX: a caller that holds JAX arrays converts them to numpy first.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..core import Parameter, State
from . import rng

__all__ = ["params_from_numpy", "state_from_numpy"]


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # numpy has no native bfloat16: carry the bits through int16
        # (``ascontiguousarray`` makes a 0-dim array 1-dim: keep the shape).
        bits = np.ascontiguousarray(a).view(np.int16).reshape(a.shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(
    tree: Mapping[str, Any],
    device: str | torch.device | None = None,
    seed: int = 0,
    params: Iterable[str] = (),
) -> State:
    """Build a port ``State`` from a nested dict of numpy arrays.

    :param tree: ``{name: array | nested dict}``.  A leaf named ``key`` is a
        random-stream key of the other framework, of any shape (a JAX
        ``rbg`` key's data is (4,) uint32), and is replaced by a port key
        made from ``seed`` on ``device`` (the two frameworks' streams
        differ anyway).
    :param device: where the leaves go (``None`` means the CUDA card).
    :param seed: seed of the replacement keys.
    :param params: dotted paths of the leaves to label as ``Parameter``
        (e.g. ``"algorithm.w"``), so ``get_params`` sees them.
    """
    device = resolve_device(device)
    params = set(params)

    def build(node: Mapping[str, Any], prefix: str) -> State:
        fields = {}
        for name, value in node.items():
            path = f"{prefix}{name}"
            if isinstance(value, Mapping):
                fields[name] = build(value, path + ".")
            elif name == "key":
                fields[name] = rng.key(seed, device=device)
            else:
                t = _tensor(value, device)
                fields[name] = Parameter(t) if path in params else t
        return State(**fields)

    return build(tree, "")


def params_from_numpy(tree: Any, device: str | torch.device | None = None) -> Any:
    """A parameter tree of numpy arrays (nested dicts, lists and tuples) as
    the same tree of tensors on ``device`` (``None`` means the CUDA card),
    values and dtypes unchanged."""
    device = resolve_device(device)

    def build(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return _tensor(node, device)

    return build(tree)
