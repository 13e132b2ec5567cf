"""Inverted Generational Distance (counterpart of
``evox_tpu/metrics/igd.py``)."""

from __future__ import annotations

import torch

__all__ = ["igd"]


def igd(objs: torch.Tensor, pf: torch.Tensor, p: int = 1) -> torch.Tensor:
    """IGD between a solution set ``objs`` (n, m) and the true Pareto front
    ``pf`` (k, m): mean L^p-aggregated distance from each front point to its
    nearest solution.  Lower is better.

    Distances use the broadcast difference, as the JAX package does (not
    ``torch.cdist``, whose matrix-product route rounds differently)."""
    dist = torch.linalg.vector_norm(pf[:, None, :] - objs[None, :, :], dim=-1)
    min_dis = torch.amin(dist, dim=1)
    return torch.mean(min_dis**p) ** (1.0 / p)
