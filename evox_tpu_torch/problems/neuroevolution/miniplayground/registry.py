"""The ``mujoco_playground.registry`` surface (counterpart of
``evox_tpu/problems/neuroevolution/miniplayground/registry.py``):
``load(name)`` plus the environment name listing (``ALL_ENVS``)."""

from __future__ import annotations

import torch

from ..minibrax import envs as _menvs

ALL_ENVS = ("Hopper", "PointMass")

_NAME_MAP = {"Hopper": "hopper", "PointMass": "pointmass"}


def load(env_name: str, config=None, config_overrides=None, device: str | torch.device | None = None):
    """Instantiate a registered environment (playground's signature; the
    planar backend takes no config) on ``device`` (``None`` means the CUDA
    card)."""
    del config, config_overrides
    from . import MiniPlaygroundEnv

    if env_name not in _NAME_MAP:
        raise ValueError(f"unknown miniplayground env {env_name!r}; available: {ALL_ENVS}")
    return MiniPlaygroundEnv(_menvs.get_environment(env_name=_NAME_MAP[env_name], device=device))
