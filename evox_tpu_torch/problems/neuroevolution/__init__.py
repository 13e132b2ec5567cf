"""Neuroevolution problems (counterpart of
``evox_tpu/problems/neuroevolution``): rollouts of policy populations in
environments, supervised-learning losses of model populations, and the
port's vendored physics engines.

``BraxProblem``/``MujocoProblem`` import ``brax``/``mujoco_playground``
when built; the port's vendored ``minibrax``/``miniplayground`` answer
them (their ``activate()``), and a JAX engine is refused.
"""

__all__ = [
    "BraxProblem",
    "Env",
    "MLPPolicy",
    "MujocoProblem",
    "RolloutProblem",
    "SupervisedLearningProblem",
    "cartpole",
    "minibrax",
    "miniplayground",
    "pendulum",
    "stack_model_params",
]

from . import minibrax, miniplayground
from .brax import BraxProblem
from .envs import Env, cartpole, pendulum
from .mujoco_playground import MujocoProblem
from .rollout import RolloutProblem
from .supervised_learning import SupervisedLearningProblem
from .utils import MLPPolicy, stack_model_params
