"""Carry a state or model parameters across from numpy.

:func:`state_from_numpy` turns a nested dict of numpy arrays (for example
one written out from a JAX package ``State``, typed keys as their key
data) into the port's :class:`~evox_tpu_torch.core.State`, a
meta-optimization outer state included (the nest's stacked instances, its
uids and telemetry); :func:`params_from_numpy` turns a parameter tree (for
example the JAX package's ``MLPPolicy.init`` output, ``{"w0": ...,
"b0": ...}``) into the same tree of tensors.  The port never sees JAX: a
caller that holds JAX arrays converts them to numpy first.
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

    :param tree: ``{name: array | nested dict}``.  A leaf named ``key`` is
        the key data of the other framework's random-stream key (a JAX
        ``threefry2x32`` key's data is (2,) uint32, an ``rbg`` key's (4,)),
        and is replaced by a port key made from ``seed`` on ``device`` (the
        two frameworks' streams differ anyway).  A stack of keys (leading
        batch axes, as a vmapped or nested state carries) becomes a stack
        of distinct port keys, lane ``i`` ``rng.fold_in(key(seed), i)``;
        under a nest's state (a node holding ``instances`` and ``uids``)
        the instances' lanes are keyed by their uid instead, as
        :class:`~evox_tpu_torch.hpo.NestedProblem` keys them
        (``fold_in(key(seed), uid)``, and ``fold_in`` of the repeat index
        under it).  A leaf named ``uids`` becomes int64, the port's uid
        type.
    :param device: where the leaves go (``None`` means the CUDA card).
    :param seed: seed of the replacement keys.
    :param params: dotted paths of the leaves to label as ``Parameter``
        (e.g. ``"algorithm.w"``), so ``get_params`` sees them.
    """
    device = resolve_device(device)
    params = set(params)
    root = rng.key(seed, device=device)

    def lane_keys(shape: tuple, uids: Any) -> torch.Tensor:
        """Port keys of batch ``shape``: lane ``i`` of the leading axis
        ``fold_in(key(seed), uids[i])`` (the flat index when ``uids`` is
        ``None``), each further axis folding its index in again."""
        if not shape:
            return root
        first = range(shape[0]) if uids is None else [int(u) for u in np.asarray(uids).reshape(-1)]
        keys = [rng.fold_in(root, torch.tensor(u, dtype=torch.int64, device=device)) for u in first]
        for n in shape[1:]:
            keys = [rng.fold_in(k, torch.tensor(j, dtype=torch.int64, device=device)) for k in keys for j in range(n)]
        return torch.stack(keys).reshape(tuple(shape) + (2,))

    def build(node: Mapping[str, Any], prefix: str, uids: Any) -> State:
        fields = {}
        nest_uids = node.get("uids") if "instances" in node else None
        for name, value in node.items():
            path = f"{prefix}{name}"
            if isinstance(value, Mapping):
                fields[name] = build(value, path + ".", nest_uids if name == "instances" else uids)
            elif name == "key":
                fields[name] = lane_keys(tuple(np.shape(value))[:-1], uids)
            else:
                t = _tensor(value, device)
                if name == "uids":
                    t = t.to(torch.int64)
                fields[name] = Parameter(t) if path in params else t
        return State(**fields)

    return build(tree, "", None)


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
