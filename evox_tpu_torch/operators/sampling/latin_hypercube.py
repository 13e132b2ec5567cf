"""Latin hypercube sampling (counterpart of
``evox_tpu/operators/sampling/latin_hypercube.py``).

The stratum permutations and the jitter are two words of one Philox draw
(one launch of the draw kernel on the card); ``draws=`` supplies them from
outside instead."""

from __future__ import annotations

import torch

from ... import resolve_device
from ...ops.philox import philox_draws
from ...utils import rng

__all__ = ["latin_hypercube_sampling", "latin_hypercube_sampling_standard"]


def latin_hypercube_sampling_standard(
    key: torch.Tensor | None,
    n: int,
    d: int,
    smooth: bool = True,
    device: str | torch.device | None = None,
    draws: tuple | None = None,
) -> torch.Tensor:
    """LHS in the unit hypercube: one sample per stratum per dimension,
    with independently permuted strata across dimensions.

    :param key: a port key; unused when ``draws`` is given.
    :param device: ``None`` means the CUDA card.
    :param draws: ``(perm_u, offset_u)``, (n, d) uniforms: the stable
        argsort of ``perm_u`` down each column permutes the strata and
        ``offset_u`` jitters within them.
    :return: (n, d) float32 samples.
    """
    if draws is None:
        u = philox_draws(rng.child(key), n * d, [torch.float32, torch.float32], resolve_device(device))
        draws = tuple(t.reshape(n, d) for t in u)
    perm_u, offset_u = draws
    cells = torch.argsort(perm_u, dim=0, stable=True).to(torch.float32)
    offset = offset_u if smooth else 0.5
    return (cells + offset) / n


def latin_hypercube_sampling(
    key: torch.Tensor | None,
    n: int,
    lb: torch.Tensor,
    ub: torch.Tensor,
    smooth: bool = True,
    draws: tuple | None = None,
) -> torch.Tensor:
    """LHS in the box ``[lb, ub]`` (both 1-D of size ``d``), on their
    device."""
    if lb.ndim != 1 or ub.ndim != 1 or lb.shape != ub.shape:
        raise ValueError(
            f"lb and ub must be 1-D of the same shape, got {tuple(lb.shape)} and {tuple(ub.shape)}"
        )
    samples = latin_hypercube_sampling_standard(key, n, lb.shape[0], smooth, lb.device, draws)
    return lb[None, :] + samples.to(lb.dtype) * (ub - lb)[None, :]
