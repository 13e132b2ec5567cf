"""miniplayground: a vendored, minimal, mujoco_playground-API-compatible
environment suite over the :mod:`..minibrax` engine (counterpart of
``evox_tpu/problems/neuroevolution/miniplayground``).

It exposes the API slice that
:class:`~evox_tpu_torch.problems.neuroevolution.MujocoProblem` consumes:
``registry.load(name, device=...)`` → an environment with pure
``reset``/``step`` (dict observations ``{"state": ..., "privileged":
...}``, float ``done``, a per-frame ``data`` field), ``observation_size``
(dict form), ``action_size``, ``dt``, and ``render(trajectory, ...)``
returning RGB frames.

:func:`activate` aliases this package as ``mujoco_playground`` in
``sys.modules`` when none is importable, for the rest of the process; a
test that must leave ``sys.modules`` as it found it installs it under
``mujoco_playground`` and ``mujoco_playground.registry`` with
``monkeypatch.setitem`` (see :mod:`..minibrax`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import minibrax
from ..minibrax.envs import State as _BraxState

__all__ = ["State", "MiniPlaygroundEnv", "registry", "activate"]


class State(NamedTuple):
    """Playground-style env state: ``data`` is the physics state collected
    per frame for rendering; ``obs`` is a dict."""

    data: minibrax.PipelineState
    obs: dict
    reward: torch.Tensor
    done: torch.Tensor  # float32, like MJX; consumers cast to bool


class MiniPlaygroundEnv:
    """Wraps a minibrax env behind the mujoco_playground env surface."""

    def __init__(self, backend_env):
        self._env = backend_env

    @property
    def dt(self) -> float:
        return self._env.dt

    @property
    def action_size(self) -> int:
        return self._env.action_size

    @property
    def observation_size(self) -> dict:
        # Playground reports dict observation sizes for dict observations;
        # the adapter must pick out the "state" entry.
        return {"state": self._env.observation_size, "privileged": 3}

    def _obs(self, s: _BraxState) -> dict:
        # "state" is what policies consume; "privileged" (reward, done, 0)
        # exists so adapters provably handle extra entries.
        return {
            "state": s.obs,
            "privileged": torch.stack([s.reward, s.done, torch.zeros_like(s.reward)], dim=-1),
        }

    def reset(self, key: torch.Tensor) -> State:
        s = self._env.reset(key)
        return State(data=s.pipeline_state, obs=self._obs(s), reward=s.reward, done=s.done)

    def step(self, state: State, action: torch.Tensor) -> State:
        inner = _BraxState(
            pipeline_state=state.data,
            obs=torch.zeros_like(state.reward),  # unused by minibrax env steps
            reward=state.reward,
            done=state.done,
        )
        s = self._env.step(inner, action)
        return State(data=s.pipeline_state, obs=self._obs(s), reward=s.reward, done=s.done)

    def render(self, trajectory, height: int = 240, width: int = 320, camera=None, **kw):
        """RGB frames (a list of (H, W, 3) uint8 arrays) for a list of
        per-step ``data`` values."""
        del camera, kw
        frames = minibrax.io.image.render_array(self._env.sys, trajectory, height=height, width=width)
        return list(frames)


from . import registry  # noqa: E402  (imports MiniPlaygroundEnv)


def activate():
    """Install miniplayground as ``mujoco_playground`` if it is absent.

    Returns whichever module will answer ``import mujoco_playground``."""
    import sys as _sys

    from ..utils import alias_vendored

    return alias_vendored("mujoco_playground", _sys.modules[__name__], {"registry": registry})
