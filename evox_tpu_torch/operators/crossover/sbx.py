"""Simulated binary crossover (SBX), full and half-offspring variants
(counterpart of ``evox_tpu/operators/crossover/sbx.py``).

The four per-gene draws (the spread ``mu``, the direction, and the two
pass-through coins) come from ONE Philox evaluation: its four words are the
four draws, made in one launch of the draw kernel on the card.  ``draws=``
supplies them from outside instead (the parity tests feed the JAX
package's draws this way).
"""

from __future__ import annotations

import torch

from ...ops.philox import philox_draws
from ...utils import rng

__all__ = ["simulated_binary", "simulated_binary_half", "sbx_draws"]


def sbx_draws(key: torch.Tensor, shape, dtype: torch.dtype, device) -> tuple:
    """The raw draws of one SBX call, ``(mu, direction, p1, p2)``: uniforms
    of ``shape`` and ``dtype``, ``direction`` int64 in {0, 1}."""
    draws = philox_draws(rng.child(key), shape[0] * shape[1], [dtype, (0, 2), dtype, dtype], device)
    return tuple(d.reshape(shape) for d in draws)


def _sbx_beta(draws, pro_c: float, dis_c: float) -> torch.Tensor:
    mu, direction, p1, p2 = draws
    beta = torch.where(
        mu <= 0.5,
        (2.0 * mu) ** (1.0 / (dis_c + 1.0)),
        (2.0 - 2.0 * mu) ** (-1.0 / (dis_c + 1.0)),
    )
    # Random contraction/expansion direction per gene.
    beta = beta * (1 - 2 * direction)
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    # Half the genes (and all genes of non-crossover pairs) pass through.
    beta = torch.where(p1 < 0.5, one, beta)
    return torch.where(p2 > pro_c, one, beta)


def _parents(key, x, draws):
    n, d = x.shape
    p1 = x[: n // 2]
    p2 = x[n // 2 : n // 2 * 2]
    if draws is None:
        draws = sbx_draws(key, p1.shape, x.dtype, x.device)
    return p1, p2, draws


def simulated_binary(
    key: torch.Tensor | None,
    x: torch.Tensor,
    pro_c: float = 1.0,
    dis_c: float = 20.0,
    draws: tuple | None = None,
) -> torch.Tensor:
    """SBX producing a full set of offspring (two per parent pair).

    :param key: a port key; unused when ``draws`` is given.
    :param x: parents, (n, d); pairs are (x[i], x[i + n//2]).
    :param draws: ``(mu, direction, p1, p2)`` of shape (n//2, d), as
        :func:`sbx_draws` makes them.
    :return: (2 * (n // 2), d) offspring.
    """
    p1, p2, draws = _parents(key, x, draws)
    beta = _sbx_beta(draws, pro_c, dis_c)
    mean = (p1 + p2) / 2.0
    diff = beta * (p1 - p2) / 2.0
    return torch.cat([mean + diff, mean - diff], dim=0)


def simulated_binary_half(
    key: torch.Tensor | None,
    x: torch.Tensor,
    pro_c: float = 1.0,
    dis_c: float = 20.0,
    draws: tuple | None = None,
) -> torch.Tensor:
    """SBX producing one offspring per parent pair ((n // 2, d))."""
    p1, p2, draws = _parents(key, x, draws)
    beta = _sbx_beta(draws, pro_c, dis_c)
    return (p1 + p2) / 2.0 + beta * (p1 - p2) / 2.0
