"""Das-Dennis simplex-lattice reference-vector sampling (counterpart of
``evox_tpu/operators/sampling/uniform.py``).  Host-side numpy
construction: reference vectors are built once, never inside the
generation loop."""

from __future__ import annotations

import itertools
from math import comb

import numpy as np
import torch

__all__ = ["uniform_sampling"]


def _das_dennis_layer(h: int, m: int) -> np.ndarray:
    combos = np.asarray(
        list(itertools.combinations(range(1, h + m), m - 1)), dtype=np.float64
    )
    combos = combos - np.arange(m - 1)[None, :] - 1
    left = np.concatenate([combos, np.full((combos.shape[0], 1), h)], axis=1)
    right = np.concatenate([np.zeros((combos.shape[0], 1)), combos], axis=1)
    return (left - right) / h


def uniform_sampling(n: int, m: int) -> tuple[torch.Tensor, int]:
    """About ``n`` uniformly spread points on the ``m``-simplex (Das and
    Dennis's method, with Deb and Jain's inner layer when the boundary
    layer is too coarse).

    :return: ``(points, n_samples)``; points are a float32 CPU tensor of
        shape ``(n_samples, m)``.
    """
    h1 = 1
    while comb(h1 + m, m - 1) <= n:
        h1 += 1
    w = _das_dennis_layer(h1, m)

    if h1 < m:
        h2 = 0
        while comb(h1 + m - 1, m - 1) + comb(h2 + m, m - 1) <= n:
            h2 += 1
        if h2 > 0:
            w2 = _das_dennis_layer(h2, m)
            w = np.concatenate([w, w2 / 2.0 + 1.0 / (2.0 * m)], axis=0)

    w = np.maximum(w, 1e-6)
    return torch.from_numpy(w.astype(np.float32)), w.shape[0]
