"""Shared ES helpers (counterpart of the ``opt`` module of the JAX
package's ``evox_tpu.algorithms.so.es_variants``): a single-tensor Adam
step and the fitness-sorted permutation of a population."""

from __future__ import annotations

import torch

__all__ = ["adam_single_tensor", "sort_by_key"]


def adam_single_tensor(
    param: torch.Tensor,
    grad: torch.Tensor,
    exp_avg: torch.Tensor,
    exp_avg_sq: torch.Tensor,
    beta1=0.9,
    beta2=0.999,
    lr=1e-3,
    weight_decay=0.0,
    eps=1e-8,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on a flat parameter tensor (no bias correction, as the
    JAX package); returns ``(new_param, new_exp_avg, new_exp_avg_sq)``.
    The operations and their order are the JAX package's, so the result
    has its bits."""
    grad = grad + weight_decay * param
    exp_avg = exp_avg + (1 - beta1) * (grad - exp_avg)
    exp_avg_sq = beta2 * exp_avg_sq + (1 - beta2) * grad * grad
    return param - lr * exp_avg / (torch.sqrt(exp_avg_sq) + eps), exp_avg, exp_avg_sq


def sort_by_key(fitness: torch.Tensor, *arrays: torch.Tensor):
    """Sort ``arrays`` rows by ascending fitness; returns ``(fitness,
    *arrays)``.  The order is ``jnp.argsort``'s: stable (ties by index,
    -0.0 equal to +0.0), NaN last."""
    order = torch.argsort(fitness, stable=True)
    return (fitness[order], *(a[order] for a in arrays))
