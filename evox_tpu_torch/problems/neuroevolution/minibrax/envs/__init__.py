"""minibrax environments (counterpart of
``evox_tpu/problems/neuroevolution/minibrax/envs/__init__.py``): the
``brax.envs`` API surface on the planar pipeline (``State`` with
pipeline_state/obs/reward/done, ``Env`` with ``reset``/``step``/
``observation_size``/``action_size``/``sys``, and a ``get_environment``
registry).  An environment's system tensors live on one device (``None``
means the CUDA card); ``reset``/``step`` take one episode, or batch-shaped
state with leading axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..... import resolve_device
from ...envs import draw, scaled
from ..physics import PipelineState, System, pipeline_init, pipeline_step

__all__ = ["State", "Env", "Hopper", "PointMass", "get_environment", "register_environment"]


class State(NamedTuple):
    """Environment state, structurally like ``brax.envs.base.State``: the
    fields the rollout adapter and the renderers consume (a NamedTuple, so
    ``torch.func.vmap`` maps it, with a brax-style ``replace``)."""

    pipeline_state: PipelineState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor  # float32, like brax; consumers cast to bool
    metrics: dict = {}
    info: dict = {}

    def replace(self, **updates) -> "State":
        return self._replace(**updates)


class Env:
    """Base class: subclasses set ``sys`` and implement pure ``reset``/``step``."""

    sys: System

    def reset(self, key: torch.Tensor) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError

    @property
    def dt(self) -> float:
        return self.sys.dt


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


class Hopper(Env):
    """One-legged vertical hopper: a torso and a foot coupled by an actuated
    leg spring, hopping on penalty ground contact.  The single action
    modulates the leg's rest length (thrust).  Reward = alive bonus +
    torso height + upward-velocity shaping − control cost; the episode
    ends when the torso collapses below 0.35 m."""

    def __init__(self, device: str | torch.device | None = None):
        device = resolve_device(device)
        self.sys = System(
            dt=0.02,
            n_substeps=4,
            gravity=9.8,
            mass=_f32([1.0, 0.2], device),
            radius=_f32([0.15, 0.08], device),
            link_idx=torch.tensor([[0, 1]], dtype=torch.int64, device=device),
            link_length=_f32([0.6], device),
            link_stiffness=_f32([400.0], device),
            link_damping=_f32([8.0], device),
            actuator_gain=_f32([0.5], device),
        )
        self._q0 = _f32([[0.0, 0.75], [0.0, 0.1]], device)

    def _obs(self, ps: PipelineState) -> torch.Tensor:
        leg = ps.q[..., 0, :] - ps.q[..., 1, :]
        return torch.cat(
            [ps.q[..., 1], ps.qd[..., 1], torch.linalg.vector_norm(leg, dim=-1, keepdim=True)], dim=-1
        )

    def reset(self, key: torch.Tensor) -> State:
        jitter = 0.05 * scaled(draw(key, (2,)), -1.0, 1.0)
        q = torch.stack([self._q0[:, 0] + torch.zeros_like(jitter), self._q0[:, 1] + jitter], dim=-1)
        ps = pipeline_init(self.sys, q, torch.zeros_like(q))
        zero = torch.zeros_like(jitter[..., 0])
        return State(pipeline_state=ps, obs=self._obs(ps), reward=zero, done=zero)

    def step(self, state: State, action: torch.Tensor) -> State:
        u = torch.clamp(action[..., 0], -1.0, 1.0)
        ps = pipeline_step(self.sys, state.pipeline_state, u)
        torso_z, torso_zd = ps.q[..., 0, 1], ps.qd[..., 0, 1]
        reward = 1.0 + torso_z + 0.1 * torch.clamp(torso_zd, min=0.0) - 0.01 * u**2
        done = (torso_z < 0.35).to(torch.float32)
        return state.replace(pipeline_state=ps, obs=self._obs(ps), reward=reward, done=done)

    @property
    def observation_size(self) -> int:
        return 5

    @property
    def action_size(self) -> int:
        return 1


class PointMass(Env):
    """Force-controlled point mass homing to the origin in the x-z plane
    (no gravity); reward = −distance, done when it escapes the 4 m box."""

    def __init__(self, device: str | torch.device | None = None):
        device = resolve_device(device)
        empty = torch.zeros((0,), dtype=torch.float32, device=device)
        self.sys = System(
            dt=0.05,
            n_substeps=1,
            gravity=0.0,
            mass=_f32([1.0], device),
            radius=_f32([0.1], device),
            link_idx=torch.zeros((0, 2), dtype=torch.int64, device=device),
            link_length=empty,
            link_stiffness=empty,
            link_damping=empty,
            actuator_gain=empty,
            contact_stiffness=0.0,
            contact_damping=0.0,
            friction=0.0,
        )

    def reset(self, key: torch.Tensor) -> State:
        q = scaled(draw(key, (1, 2)), -1.0, 1.0)
        ps = pipeline_init(self.sys, q, torch.zeros_like(q))
        zero = torch.zeros_like(q[..., 0, 0])
        return State(
            pipeline_state=ps, obs=torch.cat([ps.q[..., 0, :], ps.qd[..., 0, :]], dim=-1), reward=zero, done=zero
        )

    def step(self, state: State, action: torch.Tensor) -> State:
        ps = state.pipeline_state
        f = torch.clamp(action, -1.0, 1.0)
        qd = 0.95 * ps.qd + self.sys.dt * f[..., None, :]
        q = ps.q + self.sys.dt * qd
        ps = PipelineState(q=q, qd=qd)
        dist = torch.linalg.vector_norm(q[..., 0, :], dim=-1)
        return state.replace(
            pipeline_state=ps,
            obs=torch.cat([q[..., 0, :], qd[..., 0, :]], dim=-1),
            reward=-dist,
            done=(dist > 4.0).to(torch.float32),
        )

    @property
    def observation_size(self) -> int:
        return 4

    @property
    def action_size(self) -> int:
        return 2


_registry = {"hopper": Hopper, "pointmass": PointMass}


def register_environment(name: str, cls) -> None:
    _registry[name] = cls


def get_environment(env_name: str, backend: str | None = None, **kwargs) -> Env:
    """Instantiate a registered environment (brax's signature; the planar
    pipeline has one backend, so ``backend`` is accepted and ignored;
    ``device=`` goes to the environment)."""
    del backend
    if env_name not in _registry:
        raise ValueError(f"unknown minibrax env {env_name!r}; available: {sorted(_registry)}")
    return _registry[env_name](**kwargs)
