"""Grid (meshgrid lattice) sampling (counterpart of
``evox_tpu/operators/sampling/grid.py``).  Host-side construction, like the
Das-Dennis lattice: it is built once, never inside the generation loop."""

from __future__ import annotations

from math import ceil

import numpy as np
import torch

__all__ = ["grid_sampling"]


def grid_sampling(n: int, m: int) -> tuple[torch.Tensor, int]:
    """Uniform lattice of about ``n`` points in the unit hypercube
    ``[0, 1]^m``.

    :return: ``(points, n_samples)`` with ``n_samples = ceil(n^(1/m))^m``;
        points are a float32 CPU tensor, the last axis varying slowest.
    """
    num_points = int(ceil(n ** (1 / m)))
    # numpy's float32 linspace rounds each point as jnp.linspace does.
    gap = torch.from_numpy(np.linspace(np.float32(0), np.float32(1), num_points, dtype=np.float32))
    grid = torch.meshgrid(*([gap] * m), indexing="ij")
    w = torch.stack(grid, dim=-1).reshape(-1, m)
    w = torch.flip(w, dims=(1,))
    return w, w.shape[0]
