"""Core runtime: state containers and component protocols (counterpart of
``evox_tpu/core``).

``compile``, ``jit`` and ``vmap`` are the reference EvoX's names: here
``torch.compile`` (both of the first two) and ``torch.func.vmap``, as the
JAX package's are ``jax.jit`` and ``jax.vmap``."""

import torch
from torch.func import vmap

from .components import Algorithm, EvalFn, Monitor, Problem, Workflow
from .components import _Component as ModuleBase
from .state import Mutable, Parameter, State, get_params, set_params, use_state

compile = jit = torch.compile

__all__ = [
    "Algorithm",
    "Problem",
    "Workflow",
    "Monitor",
    "ModuleBase",
    "EvalFn",
    "State",
    "Parameter",
    "Mutable",
    "get_params",
    "set_params",
    "use_state",
    "compile",
    "jit",
    "vmap",
]
