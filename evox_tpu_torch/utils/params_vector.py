"""Parameters <-> flat vector adapter (counterpart of
``evox_tpu/utils/params_vector.py``): a population of network weights
evolved as one (pop, n) matrix.

The leaves are laid out in ``jax.flatten_util.ravel_pytree``'s order: a
mapping's keys sorted, a list's or tuple's items in order, depth first.  So
a vector built from parameters carried over from the JAX package is the
same vector that ``ravel_pytree`` makes there.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = ["ParamsAndVector"]


def _leaves(tree: Any, out: list) -> Any:
    """Append the tensor leaves of ``tree`` to ``out`` in ``ravel_pytree``'s
    order; return the structure with the leaves' shapes and dtypes."""
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return ("D", type(tree), tuple(keys), tuple(_leaves(tree[k], out) for k in keys))
    if isinstance(tree, (list, tuple)):
        return ("L", type(tree), tuple(_leaves(v, out) for v in tree))
    t = torch.as_tensor(tree)
    out.append(t)
    return ("T", tuple(t.shape), t.dtype)


def _build(spec: Any, it) -> Any:
    kind = spec[0]
    if kind == "D":
        return spec[1](zip(spec[2], (_build(s, it) for s in spec[3])))
    if kind == "L":
        return spec[1](_build(s, it) for s in spec[2])
    return next(it)


def _specs(spec: Any, out: list) -> list:
    if spec[0] == "T":
        out.append(spec[1:])
    else:
        for s in spec[-1]:
            _specs(s, out)
    return out


class ParamsAndVector:
    """Bidirectional adapter between a parameter tree (nested mappings,
    lists and tuples of tensors) and a flat vector.

    ``to_vector``/``to_params`` handle one model; ``batched_to_vector``/
    ``batched_to_params`` a population (leading batch axis).  Calling the
    adapter applies ``batched_to_params``, so it plugs into ``StdWorkflow``
    as a ``solution_transform``."""

    def __init__(self, dummy_model: Any):
        """``dummy_model``: an example parameter tree fixing structure,
        shapes and dtypes (a ``torch.nn.Module`` gives its
        ``named_parameters()``)."""
        if isinstance(dummy_model, torch.nn.Module):
            dummy_model = {k: v.detach() for k, v in dummy_model.named_parameters()}
        leaves: list = []
        self._spec = _leaves(dummy_model, leaves)
        self._shapes = _specs(self._spec, [])
        self._sizes = [t.numel() for t in leaves]
        self._dtype = torch.cat([t.reshape(-1) for t in leaves]).dtype if leaves else torch.float32

    @property
    def vector_size(self) -> int:
        """Length of the flat vector (total parameter count)."""
        return sum(self._sizes)

    def to_vector(self, params: Any) -> torch.Tensor:
        """Flatten one parameter tree to a flat vector (leaves promoted to
        one dtype, as ``ravel_pytree`` does)."""
        leaves: list = []
        _leaves(params, leaves)
        return torch.cat([t.reshape(-1).to(self._dtype) for t in leaves])

    def to_params(self, vector: torch.Tensor) -> Any:
        """Rebuild the parameter tree from one flat vector (each leaf back in
        its own dtype)."""
        parts = torch.split(vector, self._sizes)
        leaves = [p.reshape(shape).to(dtype) for p, (shape, dtype) in zip(parts, self._shapes)]
        return _build(self._spec, iter(leaves))

    def batched_to_vector(self, batched_params: Any) -> torch.Tensor:
        """Flatten a population of parameter trees (leading pop axis) to a
        (pop, vector_size) matrix."""
        return torch.func.vmap(self.to_vector)(batched_params)

    def batched_to_params(self, vectors: torch.Tensor) -> Any:
        """Rebuild a population of parameter trees from (pop, vector_size)
        rows — the workflow ``solution_transform`` direction."""
        return torch.func.vmap(self.to_params)(vectors)

    def __call__(self, vectors: torch.Tensor) -> Any:
        return self.batched_to_params(vectors)

    # The reference library's name (its ``nn.Module.forward``).
    forward = batched_to_params
