"""SHADE, success-history based parameter adaptation for DE (counterpart
of ``evox_tpu/algorithms/so/de_variants/shade.py``): current-to-pbest/1
mutation with F/CR drawn around entries of a success-history memory,
binomial crossover, greedy selection, then a memory update from the
fitness-gain-weighted statistics of this generation's successes: two
masked weighted reductions and a rolled memory, kept by a device
``where`` only when some trial succeeded."""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, State
from ....utils import rng
from .de import bounds, improve, init_population
from .strategy import CURRENT2PBEST_1_BIN, TRIAL_SEEDS, composite_trial

__all__ = ["SHADE"]


class SHADE(Algorithm):
    """SHADE (Tanabe & Fukunaga, 2013)."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        diff_padding_num: int = 9,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param diff_padding_num: width of the padded difference-vector index
            table.
        :param device: ``None`` means the CUDA card; pass ``"cpu"`` for the
            CPU.
        """
        if pop_size < 9:
            raise ValueError(f"pop_size must be >= 9, got {pop_size}")
        self.device = resolve_device(device)
        self.lb, self.ub = bounds(lb, ub, dtype, self.device)
        self.pop_size = pop_size
        self.dim = self.lb.shape[0]
        self.diff_padding_num = diff_padding_num
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))
        # Uniform in the box, as the JAX package (the reference library
        # centres a normal on the lower bound).
        return State(
            key=key,
            memory_FCR=torch.full((2, self.pop_size), 0.5, dtype=self.dtype, device=self.device),
            best_index=torch.zeros((), dtype=torch.int32, device=self.device),
            pop=init_population(init_seed, self.pop_size, self.lb, self.ub),
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, best_index=torch.argmin(fit).to(torch.int32))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (perm, z_F,
        z_CR, trial))`` to supply them: the permutation of the memory, the
        standard normals of F and CR ((pop_size,) each) and
        :func:`composite_trial`'s draws."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        pop, fit = state.pop, state.fit
        n = self.pop_size
        key, seeds = rng.split(state.key, 2 + TRIAL_SEEDS)
        state, draws = self._draws(state)
        if draws is None:
            fcr_ids = rng.permutation(seeds[0], n, pop.device)
            z = rng.normal(seeds[1], (2, n), pop.dtype, pop.device)
            z_F, z_CR, trial_draws = z[0], z[1], None
        else:
            fcr_ids, z_F, z_CR, trial_draws = draws

        # F/CR around a random permutation of the success memory.
        M_F = state.memory_FCR[0, fcr_ids]
        M_CR = state.memory_FCR[1, fcr_ids]
        F_vec = torch.clamp(z_F * 0.1 + M_F, 0, 1)
        CR_vec = torch.clamp(z_CR * 0.1 + M_CR, 0, 1)

        trial = composite_trial(
            seeds[2], pop, fit, state.best_index, *CURRENT2PBEST_1_BIN, F_vec, CR_vec,
            self.diff_padding_num, static_base_types=CURRENT2PBEST_1_BIN[:2], draws=trial_draws,
        )
        trial = torch.clamp(trial, self.lb, self.ub)
        trial_fit = evaluate(trial)
        success = trial_fit < fit
        state = improve(state, trial, trial_fit, key=key)

        # Success-history update: the gain-weighted arithmetic mean of CR
        # and Lehmer mean of F over this generation's successes, pushed into
        # slot 0 of the rolled memory; unchanged without a success.
        delta = (fit - trial_fit) * success.to(pop.dtype)
        w = delta / (torch.sum(delta) + 1e-12)
        M_CR_new = torch.sum(w * CR_vec)
        M_F_new = torch.sum(w * (F_vec * F_vec)) / (torch.sum(w * F_vec) + 1e-12)
        rolled = torch.cat([torch.stack([M_F_new, M_CR_new])[:, None], state.memory_FCR[:, :-1]], dim=1)
        memory = torch.where(torch.any(success), rolled, state.memory_FCR)
        return state.replace(best_index=torch.argmin(state.fit).to(torch.int32), memory_FCR=memory)
