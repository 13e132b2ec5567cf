"""Mujoco-Playground RL problem (counterpart of
``evox_tpu/problems/neuroevolution/mujoco_playground.py``): the same
architecture as :class:`~.brax.BraxProblem`, with the observation dict
reduced to its ``"state"`` entry.

``mujoco_playground`` is imported when the problem is built: the port's
own :mod:`.miniplayground` answers it (``miniplayground.activate()``, or
installed in ``sys.modules`` by a test).  The real package (MJX) is JAX
and is refused with a :class:`TypeError` (bridging is not ported).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ... import resolve_device
from ...utils import rng
from .brax import torch_env
from .envs import Env
from .rollout import RolloutProblem

__all__ = ["MujocoProblem"]


def _obs_of(raw):
    # A dict observation: the policy consumes obs["state"].
    return raw["state"] if isinstance(raw, dict) else raw


class MujocoProblem(RolloutProblem):
    """Population policy evaluation in a Mujoco-Playground-API env."""

    def __init__(
        self,
        policy: Callable[[Any, torch.Tensor], torch.Tensor],
        env_name: str,
        max_episode_length: int,
        num_episodes: int = 1,
        rotate_key: bool = True,
        reduce_fn: Callable[[torch.Tensor], torch.Tensor] = torch.mean,
        maximize_reward: bool = True,
        device: str | torch.device | None = None,
    ):
        """
        :param policy: pure ``(params, obs) -> action`` of one individual.
        :param env_name: Mujoco-Playground registry name.
        :param max_episode_length: maximum time steps per episode.
        :param num_episodes: episodes per individual.
        :param device: where the environment's tensors live (``None``
            means the CUDA card).
        """
        # Imported lazily (not at module load) so the adapter runs against
        # whatever answers ``import mujoco_playground`` when it is built.
        try:
            from mujoco_playground import registry as _mjx_registry
        except ImportError as e:
            raise ImportError(
                "MujocoProblem requires a `mujoco_playground` module: the port's vendored suite "
                "(evox_tpu_torch.problems.neuroevolution.miniplayground.activate())"
            ) from e
        device = resolve_device(device)
        env = torch_env("MujocoProblem", lambda: _mjx_registry.load(env_name, device=device), device)

        def reset(key):
            s = env.reset(key)
            return s, _obs_of(s.obs)

        def step(s, action):
            s = env.step(s, action)
            return s, _obs_of(s.obs), s.reward, s.done.to(torch.bool)

        obs_size = env.observation_size
        if isinstance(obs_size, dict):
            obs_size = obs_size["state"]
        self._mjx_env = env
        super().__init__(
            policy=policy,
            env=Env(reset, step, obs_size, env.action_size),
            max_episode_length=max_episode_length,
            num_episodes=num_episodes,
            rotate_key=rotate_key,
            reduce_fn=reduce_fn,
            maximize_reward=maximize_reward,
        )

    def visualize(
        self,
        state,
        params: Any,
        seed: int | None = None,
        output_type: str = "mp4",
        output_path: str = "output_video",
        camera: str | None = None,
        **kwargs,
    ) -> str:
        """Render one episode of a single policy to a video file (needs
        ``imageio``).

        :param state: the problem State (supplies the episode key when
            ``seed`` is None).
        :param params: one individual's policy parameters (unstacked).
        :param output_type: ``"mp4"`` or ``"gif"``.
        :return: path of the written file.
        """
        import imageio

        if output_type not in ("mp4", "gif"):
            raise ValueError(f"output_type must be mp4 or gif, got {output_type!r}")
        key = state.key if seed is None else rng.key(seed, state.key.device)
        env_state, obs = self.env.reset(key)
        trajectory = [env_state.data]
        for _ in range(self.max_episode_length):
            action = self.policy(params, obs)
            env_state, obs, _, done = self.env.step(env_state, action)
            trajectory.append(env_state.data)
            if bool(done):
                break
        fps = kwargs.pop("fps", 1.0 / self._mjx_env.dt)
        render_opts = dict(kwargs)
        render_opts.setdefault("height", 480)
        render_opts.setdefault("width", 640)
        render_opts.setdefault("camera", camera)
        frames = self._mjx_env.render(trajectory, **render_opts)
        out = f"{output_path}.{output_type}"
        if output_type == "mp4":
            save_opts = {"fps": fps, "codec": "libx264", "format": "mp4"}
        else:
            save_opts = {"format": "gif"}
        imageio.mimsave(out, frames, **save_opts)
        return out
