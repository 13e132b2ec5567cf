"""SaDE, DE with strategy adaptation (counterpart of
``evox_tpu/algorithms/so/de_variants/sade.py``): four candidate strategies
(rand/1/bin, rand-to-best/2/bin, rand/2/bin, current-to-rand/1) drawn per
individual from success-rate probabilities, CR drawn around per-strategy
medians of a success memory, and LP-deep success, failure and CR memories
updated each generation as fixed-shape tensor operations.

Two places differ from PyTorch's own calls: the CR medians are
``jnp.nanmedian``'s (:func:`~evox_tpu_torch.utils.ops.nanmedian`, the mean
of the two middle values), and the strategies are drawn by Gumbel-max over
``log(p)`` (:func:`~evox_tpu_torch.utils.rng.categorical`).  The branches
on the generation count (``gen_iter >= LP``) are ``torch.where``s.
"""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, State
from ....utils import rng
from ....utils.ops import nanmedian
from .de import bounds, improve, init_population
from .strategy import (
    CURRENT2RAND_1,
    RAND2BEST_2_BIN,
    RAND_1_BIN,
    RAND_2_BIN,
    TRIAL_SEEDS,
    composite_trial,
)

__all__ = ["SaDE"]


class SaDE(Algorithm):
    """SaDE (Qin, Huang & Suganthan, 2008)."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        diff_padding_num: int = 9,
        LP: int = 50,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param LP: learning-period depth of the success, failure and CR
            memories.
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
        self.LP = LP
        self.dtype = dtype
        self.strategy_pool = torch.tensor(
            [RAND_1_BIN, RAND2BEST_2_BIN, RAND_2_BIN, CURRENT2RAND_1], device=self.device
        )

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))

        def memory(value):
            return torch.full((self.LP, 4), value, dtype=self.dtype, device=self.device)

        return State(
            key=key,
            gen_iter=torch.zeros((), dtype=torch.int32, device=self.device),
            best_index=torch.zeros((), dtype=torch.int32, device=self.device),
            pop=init_population(init_seed, self.pop_size, self.lb, self.ub),
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
            success_memory=memory(0.0),
            failure_memory=memory(0.0),
            CR_memory=memory(float("nan")),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, best_index=torch.argmin(fit).to(torch.int32))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state,
        (strategy_ids, z_CR, z_CR_repair, z_F, trial))`` to supply them: the
        (pop_size,) strategy ids, the (pop_size, 4) standard normals of CR
        and of its redraw, the (pop_size,) normals of F and
        :func:`composite_trial`'s draws."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        pop, fit = state.pop, state.fit
        n = self.pop_size
        key, seeds = rng.split(state.key, 3 + TRIAL_SEEDS)

        # Strategy probabilities from the memories once the learning period
        # has filled; CR medians after it.
        success_sum = torch.sum(state.success_memory, dim=0)
        failure_sum = torch.sum(state.failure_memory, dim=0)
        S = success_sum / (success_sum + failure_sum + 1e-12) + 0.01
        strategy_p = torch.where(state.gen_iter >= self.LP, S / torch.sum(S), 0.25)
        CRM = torch.where(state.gen_iter > self.LP, nanmedian(state.CR_memory, dim=0), 0.5)
        CRM = torch.nan_to_num(CRM, nan=0.5)

        state, draws = self._draws(state)
        if draws is None:
            strategy_ids = rng.categorical(seeds[0], torch.log(strategy_p), (n,), pop.device)
            z = rng.normal(seeds[1], (2, n, 4), pop.dtype, pop.device)
            z_CR, z_CR_repair = z[0], z[1]
            z_F = rng.normal(seeds[2], (n,), pop.dtype, pop.device)
            trial_draws = None
        else:
            strategy_ids, z_CR, z_CR_repair, z_F, trial_draws = draws

        # CR around the strategy's median, redrawn once if outside [0, 1].
        CRs = z_CR * 0.1 + CRM
        CRs_repair = z_CR_repair * 0.1 + CRM
        CRs = torch.where((CRs < 0) | (CRs > 1), CRs_repair, CRs)
        CR_vec = torch.take_along_dim(CRs, strategy_ids[:, None], dim=1)[:, 0]
        F_vec = z_F * 0.3 + 0.5

        code = self.strategy_pool[strategy_ids]  # (n, 4)
        trial = composite_trial(
            seeds[3], pop, fit, state.best_index, code[:, 0], code[:, 1], code[:, 2], code[:, 3],
            F_vec, CR_vec, self.diff_padding_num, draws=trial_draws,
        )
        trial = torch.clamp(trial, self.lb, self.ub)
        trial_fit = evaluate(trial)
        success = trial_fit <= fit
        state = improve(state, trial, trial_fit, strict=False, key=key)

        # This generation's successes and failures per strategy, pushed into
        # row 0 of the rolled memories.
        one_hot = (strategy_ids[:, None] == torch.arange(4, device=pop.device)).to(self.dtype)
        succ_counts = torch.sum(one_hot * success[:, None], dim=0)
        fail_counts = torch.sum(one_hot * (~success)[:, None], dim=0)
        success_memory = torch.cat([succ_counts[None], state.success_memory[:-1]], dim=0)
        failure_memory = torch.cat([fail_counts[None], state.failure_memory[:-1]], dim=0)
        return state.replace(
            gen_iter=state.gen_iter + 1,
            best_index=torch.argmin(state.fit).to(torch.int32),
            success_memory=success_memory,
            failure_memory=failure_memory,
            CR_memory=self._push_cr(state.CR_memory, CR_vec, strategy_ids, success),
        )

    def _push_cr(self, CR_memory, CR_vec, strategy_ids, success) -> torch.Tensor:
        """Push this generation's successful CRs into the per-strategy FIFO
        columns, newest at row 0: for each strategy, its successes in
        reverse order compacted to the front by a stable argsort of the
        mask, then the old column shifted down by their count — the
        reference's one-at-a-time rolls, all four columns at once."""
        n = CR_vec.shape[0]
        dev = CR_vec.device
        mask = success[None, :] & (strategy_ids[None, :] == torch.arange(4, device=dev)[:, None])  # (4, n)
        order = torch.argsort((~mask.flip(1)).to(torch.uint8), dim=1, stable=True)
        compacted = CR_vec.flip(0)[order]  # (4, n)
        s = torch.sum(mask, dim=1, keepdim=True)  # (4, 1)
        j = torch.arange(self.LP, device=dev)[None, :]
        new = torch.take_along_dim(compacted, torch.clamp(j, max=n - 1).expand(4, -1), dim=1)
        old = torch.take_along_dim(CR_memory.T, torch.clamp(j - s, 0, self.LP - 1), dim=1)
        return torch.where(j < s, new, old).T
