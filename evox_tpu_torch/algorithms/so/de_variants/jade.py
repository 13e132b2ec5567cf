"""JaDE, adaptive Differential Evolution (counterpart of
``evox_tpu/algorithms/so/de_variants/jade.py``): current-to-pbest/1
mutation with per-individual F/CR drawn around adaptive means, binomial
crossover, greedy selection, then a moving-average update of the means
from the successful trials, gated by a device ``where`` (no host reads
whether any trial succeeded)."""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, State
from ....operators.crossover import DE_binary_crossover
from ....operators.selection import select_rand_pbest
from ....utils import rng
from .de import bounds, improve, init_population

__all__ = ["JaDE"]


class JaDE(Algorithm):
    """JaDE (Zhang & Sanderson, 2009) with vector-wise F/CR adaptation."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        num_difference_vectors: int = 1,
        mean=None,
        stdev=None,
        c: float = 0.1,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param c: learning rate of the adaptive means F_u and CR_u.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if pop_size < 4:
            raise ValueError(f"pop_size must be >= 4, got {pop_size}")
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.num_difference_vectors = num_difference_vectors
        self.c = c
        self.mean = None if mean is None else torch.as_tensor(mean, dtype=dtype, device=self.device)
        self.stdev = None if stdev is None else torch.as_tensor(stdev, dtype=dtype, device=self.device)
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))

        def half():
            return torch.full((self.pop_size,), 0.5, dtype=self.dtype, device=self.device)

        return State(
            key=key,
            F_u=half(),
            CR_u=half(),
            pop=init_population(init_seed, self.pop_size, self.lb, self.ub, self.mean, self.stdev),
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        return state.replace(fit=evaluate(state.pop))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (z_F, z_CR,
        choices, pbest, crossover))`` to supply them: the standard normals
        of F and CR ((pop_size,) each), the (2k + 1, pop_size) index table,
        the p-best positions and the binary crossover's ``(u, j)``."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        pop, fit = state.pop, state.fit
        n = self.pop_size
        num_vec = self.num_difference_vectors * 2 + 1
        key, (f_seed, choice_seed, pbest_seed, cx_seed) = rng.split(state.key, 4)
        state, draws = self._draws(state)
        if draws is None:
            z = rng.normal(f_seed, (2, n), pop.dtype, pop.device)
            z_F, z_CR = z[0], z[1]
            choices = rng.randint(choice_seed, (num_vec, n), 0, n, pop.device)
            pbest_draws = cx = None
        else:
            z_F, z_CR, choices, pbest_draws, cx = draws

        # Per-individual F/CR around the adaptive means, clipped (the
        # reference clips normal draws rather than redrawing Cauchy ones).
        F_vec = torch.clamp(z_F * 0.1 + state.F_u, 0.0, 1.0)
        CR_vec = torch.clamp(z_CR * 0.1 + state.CR_u, 0.0, 1.0)

        # current-to-pbest/1 mutation with summed difference vectors.
        diffs = pop[choices[1:-1:2]] - pop[choices[2::2]]
        difference = torch.sum(diffs, dim=0)
        pbest = select_rand_pbest(pbest_seed, 0.05, pop, fit, draws=pbest_draws)
        F2 = F_vec[:, None]
        base = pop + F2 * (pbest - pop)
        mutant = base + F2 * difference

        new_pop = DE_binary_crossover(cx_seed, mutant, pop, CR_vec, draws=cx)
        new_pop = torch.clamp(new_pop, self.lb, self.ub)
        new_fit = evaluate(new_pop)
        success = new_fit < fit
        state = improve(state, new_pop, new_fit, key=key)

        # Lehmer mean of the successful F, arithmetic mean of the successful
        # CR, moving-average update where any trial succeeded.
        w = success.to(pop.dtype)
        count = torch.sum(w)
        mean_F = torch.sum(F_vec * F_vec * w) / (torch.sum(F_vec * w) + 1e-9)
        mean_CR = torch.sum(CR_vec * w) / (count + 1e-9)
        any_success = count > 0
        F_u = torch.where(any_success, (1 - self.c) * state.F_u + self.c * mean_F, state.F_u)
        CR_u = torch.where(any_success, (1 - self.c) * state.CR_u + self.c * mean_CR, state.CR_u)
        return state.replace(F_u=F_u, CR_u=CR_u)
