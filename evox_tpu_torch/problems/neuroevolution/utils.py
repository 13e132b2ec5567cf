"""Neuroevolution helpers (counterpart of
``evox_tpu/problems/neuroevolution/utils.py``): a small MLP policy as
``(params, apply)``, population stacking and the vendored-engine alias.

A "model" is a parameter dict of tensors and a pure ``apply(params, x)``,
so a population is one ``torch.func.vmap`` of the initializer over child
keys.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ...utils import rng

__all__ = ["MLPPolicy", "alias_vendored", "stack_model_params"]


class MLPPolicy:
    """A minimal tanh MLP: ``init(key) -> params``, ``apply(params, x) ->
    out``.  Output activation ``tanh`` keeps actions bounded in [-1, 1]."""

    def __init__(
        self,
        layer_sizes: Sequence[int],
        output_activation: Callable | None = torch.tanh,
        dtype: torch.dtype = torch.float32,
    ):
        if len(layer_sizes) < 2:
            raise ValueError(f"an MLP needs at least 2 layer sizes, got {tuple(layer_sizes)}")
        self.layer_sizes = tuple(layer_sizes)
        self.output_activation = output_activation
        self.dtype = dtype

    def init(self, key: torch.Tensor) -> dict:
        """Random layer weights (He-scaled normals) and zero biases, on the
        key's device: ``{"w0": (in, out), "b0": (out,), ...}``."""
        params = {}
        for i, (fan_in, fan_out) in enumerate(zip(self.layer_sizes[:-1], self.layer_sizes[1:])):
            key, w_key = rng.split_keys(key, 2)
            # sqrt(2 / fan_in) rounded to the dtype, as the JAX package
            # computes it, then a Python float (exact in the dtype).
            scale = float(torch.tensor(2.0 / fan_in, dtype=self.dtype).sqrt())
            w = rng.normal(rng.child(w_key), (fan_in, fan_out), self.dtype, w_key.device)
            params[f"w{i}"] = w * scale
            params[f"b{i}"] = torch.zeros((fan_out,), dtype=self.dtype, device=w_key.device)
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Forward pass: ``x`` through the MLP under ``params``."""
        n_layers = len(self.layer_sizes) - 1
        h = x.to(self.dtype)
        for i in range(n_layers):
            h = h @ params[f"w{i}"] + params[f"b{i}"]
            if i < n_layers - 1:
                h = torch.tanh(h)
        if self.output_activation is not None:
            h = self.output_activation(h)
        return h

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)


def stack_model_params(init_fn: Callable[[torch.Tensor], Any], key: torch.Tensor, pop_size: int) -> Any:
    """A population of model parameters: ``init_fn`` mapped over
    ``pop_size`` child keys of ``key`` (``torch.func.vmap``), each leaf
    with a leading ``pop_size`` axis.  The draws of all individuals are one
    batched launch of the draw kernel on the card."""
    keys = torch.stack(rng.split_keys(key, pop_size))
    return torch.func.vmap(init_fn)(keys)


def alias_vendored(real_name: str, module, submodules: dict | None = None):
    """Install a vendored stand-in package as ``real_name`` in
    ``sys.modules``, only when the real package is absent; returns
    whichever module will answer ``import <real_name>`` afterwards.

    Shared by ``minibrax.activate()`` and ``miniplayground.activate()``.
    The alias lasts for the process: a test that must leave
    ``sys.modules`` as it found it installs the engines with
    ``monkeypatch.setitem`` instead."""
    import importlib
    import sys

    try:
        importlib.import_module(real_name)
        return sys.modules[real_name]
    except ImportError:
        pass
    sys.modules[real_name] = module
    for suffix, sub in (submodules or {}).items():
        sys.modules[f"{real_name}.{suffix}"] = sub
    return module
