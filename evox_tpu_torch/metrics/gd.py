"""Generational Distance (counterpart of ``evox_tpu/metrics/gd.py``)."""

from __future__ import annotations

import torch

__all__ = ["gd"]


def gd(objs: torch.Tensor, pf: torch.Tensor) -> torch.Tensor:
    """GD between a solution set ``objs`` (n, m) and the true Pareto front
    ``pf`` (k, m): L2 norm of per-solution nearest-front distances divided by
    the solution count.  Lower is better.  Broadcast distances, as in
    :func:`~evox_tpu_torch.metrics.igd`."""
    dist = torch.linalg.vector_norm(objs[:, None, :] - pf[None, :, :], dim=-1)
    min_dis = torch.amin(dist, dim=1)
    return torch.linalg.vector_norm(min_dis) / min_dis.shape[0]
