"""Built-in control environments for neuroevolution (counterpart of
``evox_tpu/problems/neuroevolution/envs.py``): pendulum and cart-pole,
written in tensor operations so the rollout machinery
(:class:`~evox_tpu_torch.problems.neuroevolution.RolloutProblem`) runs and
is tested with no external engine.

Each factory returns an :class:`Env` of pure functions on ONE episode;
``RolloutProblem`` maps them over the population and the episodes with
``torch.func.vmap``.  ``step`` also takes batch-shaped state (leading axes
on every state tensor, the action's size on its last axis), since it only
indexes the last axis.  The functions hold no tensor: they run on the
device of the key and the state they are given.  The arithmetic keeps the
JAX package's order, operation by operation.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ...utils import rng

__all__ = ["Env", "pendulum", "cartpole"]


class Env(NamedTuple):
    """An environment: pure ``reset``/``step`` plus static sizes.

    * ``reset(key) -> (env_state, obs)``
    * ``step(env_state, action) -> (env_state, obs, reward, done)``
    """

    reset: Callable[[torch.Tensor], tuple[Any, torch.Tensor]]
    step: Callable[[Any, torch.Tensor], tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]
    obs_size: int
    action_size: int


def scaled(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """U[0, 1) values mapped onto [minval, maxval) as ``jax.random.uniform``
    maps its bits: ``max(minval, u * (maxval - minval) + minval)``, the
    bounds and their difference in float32."""
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    return torch.clamp(u * span + float(lo), min=float(lo))


def draw(key: torch.Tensor, shape) -> torch.Tensor:
    """U[0, 1) float32 of ``shape`` from child 0 of ``key``, on the key's
    device: one launch of the draw kernel, and under ``torch.func.vmap``
    over keys one batched launch for all of them."""
    return rng.uniform(rng.child(key), shape, torch.float32, key.device)


def pendulum(max_torque: float = 2.0, dt: float = 0.05) -> Env:
    """Torque-controlled pendulum swing-up (reward = -(θ² + 0.1·θ̇² +
    0.001·u²)); observation = (cos θ, sin θ, θ̇)."""

    g, m, length = 10.0, 1.0, 1.0

    def _obs(state):
        th, thdot = state
        return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)

    def reset(key):
        # One draw for both values (the JAX package splits the key in two).
        u = draw(key, (2,))
        state = (scaled(u[..., 0], -math.pi, math.pi), scaled(u[..., 1], -1.0, 1.0))
        return state, _obs(state)

    def step(state, action):
        th, thdot = state
        u = torch.clamp(action[..., 0], -max_torque, max_torque)
        # torch.remainder follows Python's sign rule, as jnp's `%`.
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (3 * g / (2 * length) * torch.sin(th) + 3.0 / (m * length**2) * u) * dt
        thdot = torch.clamp(thdot, -8.0, 8.0)
        th = th + thdot * dt
        state = (th, thdot)
        return state, _obs(state), -cost, torch.zeros_like(th, dtype=torch.bool)

    return Env(reset, step, obs_size=3, action_size=1)


def cartpole(dt: float = 0.02) -> Env:
    """Cart-pole balancing with a continuous force in [-10, 10]; reward 1 per
    step alive; done when |x| > 2.4 or |θ| > 12°."""

    gravity, m_cart, m_pole, length = 9.8, 1.0, 0.1, 0.5
    total_mass = m_cart + m_pole
    polemass_length = m_pole * length

    def _obs(state):
        return torch.stack(state, dim=-1)

    def reset(key):
        vals = scaled(draw(key, (4,)), -0.05, 0.05)
        state = tuple(vals.unbind(-1))
        return state, _obs(state)

    def step(state, action):
        x, x_dot, th, th_dot = state
        force = torch.clamp(action[..., 0], -1.0, 1.0) * 10.0
        cos_th, sin_th = torch.cos(th), torch.sin(th)
        temp = (force + polemass_length * th_dot**2 * sin_th) / total_mass
        th_acc = (gravity * sin_th - cos_th * temp) / (
            length * (4.0 / 3.0 - m_pole * cos_th**2 / total_mass)
        )
        x_acc = temp - polemass_length * th_acc * cos_th / total_mass
        x = x + dt * x_dot
        x_dot = x_dot + dt * x_acc
        th = th + dt * th_dot
        th_dot = th_dot + dt * th_acc
        state = (x, x_dot, th, th_dot)
        done = (torch.abs(x) > 2.4) | (torch.abs(th) > 12 * math.pi / 180)
        return state, _obs(state), torch.ones_like(x), done

    return Env(reset, step, obs_size=4, action_size=1)
