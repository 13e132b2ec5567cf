"""Polynomial mutation (counterpart of
``evox_tpu/operators/mutation/pm_mutation.py``).

Its two per-gene draws (the site coin and ``mu``) are two words of ONE
Philox evaluation, one launch of the draw kernel on the card; ``draws=``
supplies them from outside instead.
"""

from __future__ import annotations

import torch

from ...ops.philox import philox_draws
from ...utils import rng

__all__ = ["polynomial_mutation", "pm_draws"]


def pm_draws(key: torch.Tensor, shape, dtype: torch.dtype, device) -> tuple:
    """The raw draws of one mutation call, ``(site, mu)``: uniforms of
    ``shape`` and ``dtype``."""
    draws = philox_draws(rng.child(key), shape[0] * shape[1], [dtype, dtype], device)
    return tuple(d.reshape(shape) for d in draws)


def polynomial_mutation(
    key: torch.Tensor | None,
    x: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    pro_m: float = 1.0,
    dis_m: float = 20.0,
    draws: tuple | None = None,
) -> torch.Tensor:
    """Polynomial mutation: each gene mutates with probability ``pro_m / d``
    by a polynomial perturbation with distribution index ``dis_m``.

    :param key: a port key; unused when ``draws`` is given.
    :param x: population (n, d); ``lb``/``ub`` broadcastable bounds.
    :param draws: ``(site, mu)`` uniforms of shape (n, d), as
        :func:`pm_draws` makes them.
    :return: mutated population (n, d).
    """
    n, d = x.shape
    if draws is None:
        draws = pm_draws(key, (n, d), x.dtype, x.device)
    site_u, mu = draws
    site = site_u < pro_m / d

    pop = torch.clamp(x, lb, ub)
    span = ub - lb
    zero = torch.zeros((), dtype=x.dtype, device=x.device)

    # mu <= 0.5: perturb toward the lower bound.
    low = site & (mu <= 0.5)
    norm_l = torch.where(low, (pop - lb) / span, zero)
    delta_l = (2.0 * mu + (1.0 - 2.0 * mu) * (1.0 - norm_l) ** (dis_m + 1.0)) ** (
        1.0 / (dis_m + 1.0)
    ) - 1.0
    pop = torch.where(low, pop + span * delta_l, pop)

    # mu > 0.5: perturb toward the upper bound.
    high = site & (mu > 0.5)
    norm_h = torch.where(high, (ub - pop) / span, zero)
    delta_h = 1.0 - (
        2.0 * (1.0 - mu) + 2.0 * (mu - 0.5) * (1.0 - norm_h) ** (dis_m + 1.0)
    ) ** (1.0 / (dis_m + 1.0))
    return torch.where(high, pop + span * delta_h, pop)
