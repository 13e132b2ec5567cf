"""CoDE, composite trial-vector generation DE (counterpart of
``evox_tpu/algorithms/so/de_variants/code.py``): each individual makes
three trials (rand/1/bin, rand/2/bin, current-to-rand/1) with (F, CR)
drawn from a small pool, the 3 x pop_size trials are evaluated as one
batch, and the best trial of each individual (the first on ties) competes
with its parent."""

from __future__ import annotations

import torch

from .... import resolve_device
from ....core import Algorithm, EvalFn, Parameter, State
from ....utils import rng
from .de import bounds, improve, init_population
from .strategy import CURRENT2RAND_1, RAND_1_BIN, RAND_2_BIN, TRIAL_SEEDS, composite_trial

__all__ = ["CoDE"]

STRATEGIES = (RAND_1_BIN, RAND_2_BIN, CURRENT2RAND_1)


class CoDE(Algorithm):
    """CoDE (Wang, Cai & Zhang, 2011)."""

    def __init__(
        self,
        pop_size: int,
        lb,
        ub,
        diff_padding_num: int = 5,
        param_pool=((1.0, 0.1), (1.0, 0.9), (0.8, 0.2)),
        dtype: torch.dtype = torch.float32,
        device: str | torch.device | None = None,
    ):
        """
        :param param_pool: the (F, CR) pairs each strategy of each
            individual draws from.
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
        self.param_pool = torch.as_tensor(param_pool, dtype=dtype)
        self.dtype = dtype

    def setup(self, key: torch.Tensor) -> State:
        key, (init_seed,) = rng.split(key.to(self.device))
        return State(
            key=key,
            param_pool=Parameter(self.param_pool, dtype=self.dtype, device=self.device),
            best_index=torch.zeros((), dtype=torch.int32, device=self.device),
            pop=init_population(init_seed, self.pop_size, self.lb, self.ub),
            fit=torch.full((self.pop_size,), float("inf"), dtype=self.dtype, device=self.device),
        )

    def init_step(self, state: State, evaluate: EvalFn) -> State:
        fit = evaluate(state.pop)
        return state.replace(fit=fit, best_index=torch.argmin(fit).to(torch.int32))

    def _draws(self, state: State):
        """The generation's random choices: ``(state, None)`` draws them
        from the state's key.  A subclass may return ``(state, (param_ids,
        trials))`` to supply them: the (3, pop_size) int64 indices into the
        parameter pool and :func:`composite_trial`'s draws for each of the
        three strategies."""
        return state, None

    def step(self, state: State, evaluate: EvalFn) -> State:
        pop, fit = state.pop, state.fit
        n, d = pop.shape
        key, seeds = rng.split(state.key, 1 + len(STRATEGIES) * TRIAL_SEEDS)
        state, draws = self._draws(state)
        if draws is None:
            pool_size = self.param_pool.shape[0]
            param_ids = rng.randint(seeds[0], (len(STRATEGIES), n), 0, pool_size, pop.device)
            trial_draws = [None] * len(STRATEGIES)
        else:
            param_ids, trial_draws = draws
        params = state.param_pool[param_ids]  # (3, n, 2)
        F, CR = params[:, :, 0], params[:, :, 1]

        trials = torch.stack([
            composite_trial(
                seeds[1 + i * TRIAL_SEEDS], pop, fit, state.best_index, *code, F[i], CR[i],
                self.diff_padding_num, static_base_types=code[:2], draws=trial_draws[i],
            )
            for i, code in enumerate(STRATEGIES)
        ])
        trials = torch.clamp(trials, self.lb, self.ub)  # (3, n, d)
        trial_fit = evaluate(trials.reshape(len(STRATEGIES) * n, d)).reshape(len(STRATEGIES), n)
        best_strategy = torch.argmin(trial_fit, dim=0)
        sel_fit = torch.gather(trial_fit, 0, best_strategy[None, :])[0]
        sel_trial = torch.take_along_dim(trials, best_strategy[None, :, None], dim=0)[0]
        state = improve(state, sel_trial, sel_fit, strict=False, key=key)
        return state.replace(best_index=torch.argmin(state.fit).to(torch.int32))
