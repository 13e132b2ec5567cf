"""Monte-Carlo hypervolume (counterpart of ``evox_tpu/metrics/hv.py``)."""

from __future__ import annotations

import torch

from ..utils import rng

__all__ = ["hv"]


def hv(
    key: torch.Tensor, objs: torch.Tensor, ref: torch.Tensor, num_sample: int = 100000
) -> torch.Tensor:
    """Monte-Carlo hypervolume of ``objs`` (n, m) with respect to the
    reference point ``ref`` (m,), by uniform sampling of the bounding box.
    Higher is better.

    :param key: a port key (:func:`evox_tpu_torch.utils.rng.key`); the
        samples are Philox draws, the same bits on every device."""
    seed = rng.child(key)
    points = torch.abs(objs - ref)
    bound = torch.amax(points, dim=0)
    max_vol = torch.prod(bound)
    samples = rng.uniform(seed, (num_sample, points.shape[1]), objs.dtype, objs.device) * bound
    in_cube = torch.any(torch.all(samples[:, None, :] < points[None, :, :], dim=2), dim=1)
    return torch.sum(in_cube) / num_sample * max_vol
