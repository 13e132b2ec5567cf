"""Differential Evolution (counterpart of
``evox_tpu/algorithms/so/de_variants/de.py``): rand or best base vector,
``k`` difference vectors (replacement-sampled, as the JAX package and the
reference library draw them), binomial crossover, greedy selection.

A generation makes two draw launches (the index table and the crossover's
draws) and reads no value on the host, so a replayed CUDA graph runs it.
"""

from __future__ import annotations

from typing import Literal

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....operators.crossover import DE_binary_crossover
from ....utils import rng
from ...validation import bounds

__all__ = ["DE", "init_population"]


def init_population(seed, pop_size, lb, ub, mean=None, stdev=None) -> torch.Tensor:
    """``pop_size`` rows in the dtype and on the device of ``lb``: uniform
    in ``[lb, ub]``, or, given ``mean`` and ``stdev``, normal around
    ``mean`` clipped to the box."""
    shape = (pop_size, lb.shape[0])
    if mean is not None and stdev is not None:
        pop = mean + stdev * rng.normal(seed, shape, lb.dtype, lb.device)
        return torch.clamp(pop, lb, ub)
    return rng.uniform(seed, shape, lb.dtype, lb.device) * (ub - lb) + lb


def improve(state: State, new_pop, new_fit, strict: bool = True, **extra) -> State:
    """Greedy selection: each row keeps the trial where it is better
    (``new_fit < fit``, or ``<=`` when not ``strict``)."""
    better = new_fit < state.fit if strict else new_fit <= state.fit
    return state.replace(
        pop=torch.where(better[:, None], new_pop, state.pop),
        fit=torch.where(better, new_fit, state.fit),
        **extra,
    )


class DE(Algorithm):
    """Classic DE/rand-or-best/k/bin."""

    # The population-sized buffers (the JAX package's precision map, read
    # by the precision plane, evox_tpu_torch/precision/).
    storage_leaves = ("pop", "fit")

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        base_vector: Literal["best", "rand"] = "rand",
        num_difference_vectors: int = 1,
        differential_weight=0.5,
        cross_probability: float = 0.9,
        mean=None,
        stdev=None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param differential_weight: F, a number, or a (k,) vector when
            ``num_difference_vectors`` k > 1.
        :param mean: with ``stdev``, the centre of a normal first
            population (clipped to the box); uniform in the box otherwise.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if pop_size < 4:
            raise ValueError(f"pop_size must be >= 4, got {pop_size}")
        if not 0 < cross_probability <= 1:
            raise ValueError(f"cross_probability must be in (0, 1], got {cross_probability}")
        if not 1 <= num_difference_vectors < pop_size // 2:
            raise ValueError(
                f"num_difference_vectors must be in [1, pop_size // 2), "
                f"got {num_difference_vectors} with pop_size={pop_size}"
            )
        if base_vector not in ("rand", "best"):
            raise ValueError(f"base_vector must be 'rand' or 'best', got {base_vector!r}")
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.best_vector = base_vector == "best"
        self.num_difference_vectors = num_difference_vectors
        if num_difference_vectors > 1:
            differential_weight = torch.as_tensor(differential_weight, dtype=dtype)
            if tuple(differential_weight.shape) != (num_difference_vectors,):
                raise ValueError(
                    f"differential_weight must have shape ({num_difference_vectors},), "
                    f"got {tuple(differential_weight.shape)}"
                )
        self.differential_weight = differential_weight
        self.cross_probability = cross_probability
        self.mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=self.device)
        self.stdev = None if stdev is None else torch.as_tensor(stdev, dtype=dtype, device=self.device)
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))
        return State(
            key=key,
            differential_weight=Parameter(self.differential_weight, dtype=self.dtype, device=self.device),
            cross_probability=Parameter(self.cross_probability, dtype=self.dtype, device=self.device),
            pop=init_population(init_seed, self.pop_size, self.lb, self.ub, self.mean, self.stdev),
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        return state.replace(fit=evaluate(state.pop))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (choices,
        crossover))`` to supply them: the (num_vec, pop_size) int64 index
        table (num_vec = 2k, plus 1 for the rand base) and the binary
        crossover's ``(u, j)``; the parity tests inject the JAX package's
        draws this way."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        pop, fit = state.pop, state.fit
        n, k = self.pop_size, self.num_difference_vectors
        num_vec = 2 * k + (0 if self.best_vector else 1)
        key, (choice_seed, cx_seed) = rng.split(state.key, 2)
        state, draws = self._draws(state)
        if draws is None:
            choices = rng.randint(choice_seed, (num_vec, n), 0, n, pop.device)
            cx = None
        else:
            choices, cx = draws

        if self.best_vector:
            base = pop.index_select(0, torch.argmin(fit).reshape(1))
            start = 0
        else:
            base = pop[choices[0]]
            start = 1
        diffs = pop[choices[start::2][:k]] - pop[choices[start + 1 :: 2][:k]]  # (k, n, d)
        F = state.differential_weight
        if k == 1:
            difference = F * diffs[0]
        else:
            difference = torch.sum(F[:, None, None] * diffs, dim=0)
        mutant = base + difference

        # Binomial crossover with one guaranteed mutant gene per row.
        new_pop = DE_binary_crossover(cx_seed, mutant, pop, state.cross_probability, draws=cx)
        new_pop = torch.clamp(new_pop, self.lb, self.ub)
        return improve(state, new_pop, evaluate(new_pop), key=key)
