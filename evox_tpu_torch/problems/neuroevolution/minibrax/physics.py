"""minibrax physics (counterpart of
``evox_tpu/problems/neuroevolution/minibrax/physics.py``): a tiny planar
rigid-body pipeline in tensor operations.

Bodies are point masses in the x-z plane integrated by semi-implicit Euler
under gravity, coupled by actuated spring-damper links, with penalty
ground contact (a normal spring-damper while a body's collision sphere
penetrates the z=0 plane).  It is the engine behind the port's
``BraxProblem``/``MujocoProblem`` tests and examples.

The state may carry leading batch axes (``q`` of shape (..., n_bodies, 2),
the action of shape (...)): every operation indexes from the right, and
the link forces are scattered with an out-of-place ``index_add``, which
``torch.func.vmap`` batches (an in-place one would take functorch's
per-instance fallback).  A system of zero links (``link_idx`` of shape (0,
2)) adds no link force.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["System", "PipelineState", "pipeline_init", "pipeline_step"]


class System(NamedTuple):
    """Static description of a minibrax scene, its tensors on one device.

    ``link_idx`` is an (n_links, 2) int64 tensor of body-index pairs
    coupled by actuated spring-damper links; per-link tensors give rest
    length, stiffness, damping and actuator gain (an action scales a link's
    rest length, a linear actuator in series with the spring)."""

    dt: float
    n_substeps: int
    gravity: float
    mass: torch.Tensor  # (n_bodies,)
    radius: torch.Tensor  # (n_bodies,) collision-sphere radii
    link_idx: torch.Tensor  # (n_links, 2) int64
    link_length: torch.Tensor  # (n_links,)
    link_stiffness: torch.Tensor  # (n_links,)
    link_damping: torch.Tensor  # (n_links,)
    actuator_gain: torch.Tensor  # (n_links,) rest-length modulation per unit action
    contact_stiffness: float = 4000.0
    contact_damping: float = 40.0
    friction: float = 1.0


class PipelineState(NamedTuple):
    """Dynamic state: positions ``q`` and velocities ``qd``, (...,
    n_bodies, 2) tensors over the (x, z) plane."""

    q: torch.Tensor
    qd: torch.Tensor


def pipeline_init(sys: System, q: torch.Tensor, qd: torch.Tensor) -> PipelineState:
    return PipelineState(q=q.to(torch.float32), qd=qd.to(torch.float32))


def _forces(sys: System, q: torch.Tensor, qd: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """Net force on every body: gravity + links + ground contact."""
    gravity = torch.stack([torch.zeros_like(sys.mass), -sys.gravity * sys.mass], dim=-1)
    f = torch.zeros_like(q) + gravity

    # Actuated spring-damper links.  An action u modulates the rest length:
    # rest = length * (1 + gain * u), clipped to stay positive.
    a, b = sys.link_idx[:, 0], sys.link_idx[:, 1]
    delta = q[..., b, :] - q[..., a, :]  # (..., n_links, 2)
    dist = torch.linalg.vector_norm(delta, dim=-1)
    direction = delta / torch.clamp(dist, min=1e-6)[..., None]
    rest = sys.link_length * torch.clamp(1.0 + sys.actuator_gain * act[..., None], 0.2, 1.8)
    rel_vel = torch.sum((qd[..., b, :] - qd[..., a, :]) * direction, dim=-1)
    mag = sys.link_stiffness * (dist - rest) + sys.link_damping * rel_vel
    link_f = mag[..., None] * direction  # pulls a toward b when stretched
    f = f.index_add(-2, a, link_f).index_add(-2, b, -link_f)

    # Ground contact: penalty normal force + simple viscous friction while
    # a body's sphere penetrates the z=0 plane.
    penetration = torch.clamp(sys.radius - q[..., 1], min=0.0)
    in_contact = penetration > 0.0
    normal = sys.contact_stiffness * penetration - sys.contact_damping * torch.clamp(
        qd[..., 1], max=0.0
    ) * (penetration > 0.0)
    fz = torch.where(in_contact, torch.clamp(normal, min=0.0), 0.0)
    fx = torch.where(in_contact, -sys.friction * qd[..., 0] * sys.mass, 0.0)
    return f + torch.stack([fx, fz], dim=-1)


def pipeline_step(sys: System, state: PipelineState, act: torch.Tensor) -> PipelineState:
    """Advance one control step (``n_substeps`` semi-implicit Euler steps)."""
    h = sys.dt / sys.n_substeps
    q, qd = state.q, state.qd
    for _ in range(sys.n_substeps):
        f = _forces(sys, q, qd, act)
        qd = qd + h * f / sys.mass[:, None]
        q = q + h * qd
    return PipelineState(q=q, qd=qd)
