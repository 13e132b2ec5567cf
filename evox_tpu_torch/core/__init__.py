"""Core runtime: state containers and component protocols (counterpart of
``evox_tpu/core``)."""

from .components import Algorithm, EvalFn, Monitor, Problem, Workflow
from .components import _Component as ModuleBase
from .state import Mutable, Parameter, State, get_params, set_params, use_state

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
]
