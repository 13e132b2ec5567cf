"""Brax RL problem (counterpart of
``evox_tpu/problems/neuroevolution/brax.py``): a population of policies
evaluated in a Brax-API environment, as a :class:`RolloutProblem`.

The ``brax`` module is imported when the problem is built, not when this
module is, so the adapter runs against whatever answers ``import brax``:
the port's own :mod:`.minibrax` (``minibrax.activate()``, or installed in
``sys.modules`` by a test).  The environment must compute in torch
tensors: the real ``brax`` package is JAX, which the port does not import,
and a JAX environment is refused with a :class:`TypeError` (bridging one
through DLPack is not ported).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ... import resolve_device
from ...core import State
from ...utils import rng
from .envs import Env
from .rollout import RolloutProblem

__all__ = ["BraxProblem"]


def torch_env(adapter: str, build: Callable[[], Any], device: torch.device) -> Any:
    """The environment ``build()`` makes, after one ``reset`` on ``device``
    showed that it computes in torch tensors.  Raises :class:`TypeError`
    for a foreign engine (such as the real ``brax`` or MJX, which are
    JAX): its environments refuse ``device=`` when built, or return
    observations that are not torch tensors.  Any other error of
    ``build()`` or ``reset`` propagates as it is."""
    refused = (
        f"{adapter} needs an environment that computes in torch tensors and takes device=, such as "
        "the port's vendored engines (minibrax.activate() / miniplayground.activate()); the real "
        "brax and mujoco_playground packages are JAX, and bridging them is not ported"
    )
    try:
        env = build()
    except TypeError as e:
        raise TypeError(refused) from e
    obs = env.reset(rng.key(0, device)).obs
    leaves = obs.values() if isinstance(obs, dict) else [obs]
    if not all(isinstance(x, torch.Tensor) for x in leaves):
        raise TypeError(refused)
    return env


class BraxProblem(RolloutProblem):
    """Population policy evaluation in a Brax-API environment."""

    def __init__(
        self,
        policy: Callable[[Any, torch.Tensor], torch.Tensor],
        env_name: str,
        max_episode_length: int,
        num_episodes: int = 1,
        rotate_key: bool = True,
        reduce_fn: Callable[[torch.Tensor], torch.Tensor] = torch.mean,
        backend: str | None = None,
        maximize_reward: bool = True,
        device: str | torch.device | None = None,
    ):
        """
        :param policy: pure ``(params, obs) -> action`` of one individual.
        :param env_name: environment name (the ``brax.envs`` registry).
        :param max_episode_length: maximum time steps per episode.
        :param num_episodes: episodes per individual (keys shared across
            the population).
        :param rotate_key: fresh evaluation keys each generation.
        :param reduce_fn: per-individual episode-return reduction.
        :param backend: physics backend, passed to ``get_environment``.
        :param device: where the environment's tensors live (``None``
            means the CUDA card).
        """
        # Imported lazily (not at module load) so the adapter runs against
        # whatever engine answers ``import brax`` when it is built.
        try:
            from brax import envs as brax_envs
        except ImportError as e:
            raise ImportError(
                "BraxProblem requires a `brax` module: the port's vendored engine "
                "(evox_tpu_torch.problems.neuroevolution.minibrax.activate())"
            ) from e
        device = resolve_device(device)
        kwargs = {} if backend is None else {"backend": backend}
        env = torch_env(
            "BraxProblem", lambda: brax_envs.get_environment(env_name=env_name, device=device, **kwargs), device
        )
        self._brax_env = env

        def reset(key):
            s = env.reset(key)
            return s, s.obs

        def step(s, action):
            s = env.step(s, action)
            return s, s.obs, s.reward, s.done.to(torch.bool)

        super().__init__(
            policy=policy,
            env=Env(reset, step, env.observation_size, env.action_size),
            max_episode_length=max_episode_length,
            num_episodes=num_episodes,
            rotate_key=rotate_key,
            reduce_fn=reduce_fn,
            maximize_reward=maximize_reward,
        )

    def visualize(self, state: State, params: Any, output_type: str = "HTML"):
        """Render one episode of a single policy (``params`` unstacked), from
        the problem state's key: an HTML document or an RGB array."""
        if output_type not in ("HTML", "rgb_array"):
            raise ValueError(f"output_type must be 'HTML' or 'rgb_array', got {output_type!r}")
        env_state, obs = self.env.reset(state.key)
        trajectory = [env_state.pipeline_state]
        for _ in range(self.max_episode_length):
            action = self.policy(params, obs)
            env_state, obs, _, done = self.env.step(env_state, action)
            trajectory.append(env_state.pipeline_state)
            if bool(done):
                break
        if output_type == "HTML":
            from brax.io import html

            return html.render(self._brax_env.sys, trajectory)
        from brax.io import image

        return image.render_array(self._brax_env.sys, trajectory)
