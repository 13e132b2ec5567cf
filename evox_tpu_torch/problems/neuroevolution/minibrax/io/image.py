"""Raster trajectory renderer (the ``brax.io.image.render_array`` role;
counterpart of ``evox_tpu/problems/neuroevolution/minibrax/io/image.py``):
draws each frame's collision spheres into an RGB uint8 array with numpy,
after copying the tensors to the host."""

from __future__ import annotations

import numpy as np

# World window rendered into the image: x in [-2, 2], z in [-0.2, 2.2].
_X0, _X1, _Z0, _Z1 = -2.0, 2.0, -0.2, 2.2
_COLORS = np.array([[232, 163, 61], [90, 169, 230], [159, 230, 90]], np.uint8)


def host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def render_array(sys, trajectory, height: int = 240, width: int = 320) -> np.ndarray:
    """Render a list of ``PipelineState``s to a (T, height, width, 3) array."""
    radii = host(sys.radius)
    yy, xx = np.mgrid[0:height, 0:width]
    wx = _X0 + (xx + 0.5) * (_X1 - _X0) / width
    wz = _Z1 - (yy + 0.5) * (_Z1 - _Z0) / height
    ground = wz < 0.0

    frames = np.empty((len(trajectory), height, width, 3), np.uint8)
    for t, ps in enumerate(trajectory):
        img = np.full((height, width, 3), (18, 22, 29), np.uint8)
        img[ground] = (42, 52, 66)
        q = host(ps.q)
        for i in range(q.shape[0]):
            mask = (wx - q[i, 0]) ** 2 + (wz - q[i, 1]) ** 2 <= radii[i] ** 2
            img[mask] = _COLORS[i % len(_COLORS)]
        frames[t] = img
    return frames
