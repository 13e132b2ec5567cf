"""Population rollout problem (counterpart of
``evox_tpu/problems/neuroevolution/rollout.py``): policies evaluated by
episodes of an environment.

The contract is the JAX package's: a *single-individual* ``policy(params,
obs)`` and a *single-episode* environment (:class:`~.envs.Env`), mapped
over the population and the episodes with ``torch.func.vmap``.  The (pop,
episodes) grid is one batch axis, population-major; each of the
``max_episode_length`` steps is one vmapped call of policy and
environment step.

The time loop is the JAX package's ``lax.scan``.  On the card an
evaluation replays a CUDA graph of the whole loop, captured once per shape
(``utils/graph.py``): functorch's host cost and the launches of its
~50 operations a step are paid at capture, as XLA compiles a scan once.
Inside a fused segment of :class:`~evox_tpu_torch.workflows.StdWorkflow`
(already a capture) the loop is captured inline with the generation, and
under ``torch.func.vmap`` over problem instances it runs eagerly.  A
capture that fails raises its error; there is no eager fallback on the
card.  On the CPU the loop runs eagerly.

Semantics kept from the JAX package:

* keys: ``next_key, eval_key = split(state.key)`` when ``rotate_key``
  (else both are ``state.key``), then one key per episode, shared by every
  individual;
* ``done`` is sticky, and a step's reward counts iff the episode was alive
  when the step was taken;
* the return accumulates in float32 whatever the environment's dtype;
* ``reduce_fn`` over an individual's episodes, then a negation when
  ``maximize_reward``.

The episodes' initial states come from :meth:`RolloutProblem._resets`,
the seam through which a test supplies the other framework's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from ...core import Problem, State
from ...utils import rng
from ...utils import graph
from .envs import Env

__all__ = ["RolloutProblem"]


class RolloutProblem(Problem):
    """Evaluates a population of policy parameters by environment rollouts.

    The population arrives as a parameter tree with a leading pop axis (use
    :class:`~evox_tpu_torch.utils.ParamsAndVector` as the workflow's
    ``solution_transform`` when the algorithm evolves flat vectors).
    Fitness is the *negated* reduced episode return when
    ``maximize_reward`` (problems are minimized; pass
    ``opt_direction="max"`` to the workflow instead if preferred, never
    both)."""

    def __init__(
        self,
        policy: Callable[[Any, torch.Tensor], torch.Tensor],
        env: Env,
        max_episode_length: int,
        num_episodes: int = 1,
        rotate_key: bool = True,
        reduce_fn: Callable[[torch.Tensor], torch.Tensor] = torch.mean,
        maximize_reward: bool = True,
        unroll: int = 1,
    ):
        """
        :param policy: pure ``(params, obs) -> action`` of one individual.
        :param env: the environment (pure reset/step; see ``envs.Env``).
        :param max_episode_length: time steps per episode.
        :param num_episodes: episodes per individual; the episode keys are
            shared across individuals.
        :param rotate_key: draw fresh episode keys each evaluation (noisy
            fitness) or reuse the same keys forever (deterministic).
        :param reduce_fn: reduces the per-episode returns of an individual.
        :param maximize_reward: if True, fitness = -return (minimization).
        :param unroll: accepted for the JAX signature (``lax.scan``'s
            unroll factor); no effect.
        """
        del unroll
        self.policy = policy
        self.env = env
        self.max_episode_length = max_episode_length
        self.num_episodes = num_episodes
        self.rotate_key = rotate_key
        self.reduce_fn = reduce_fn
        self.maximize_reward = maximize_reward
        # Captured rollout loops, one per input structure.
        self._graphs = graph.Cache()

    def setup(self, key: torch.Tensor) -> State:
        return State(key=key)

    def _resets(self, episode_keys: torch.Tensor) -> tuple[Any, Any]:
        """The episodes' initial ``(env_state, obs)``, each leaf with a
        leading episode axis: ``env.reset`` mapped over the (episodes, 2)
        keys.  A subclass may return states made elsewhere; the parity
        tests supply the JAX package's this way."""
        return torch.func.vmap(self.env.reset)(episode_keys)

    def _episode_step(self, params, env_state, obs, total, done):
        action = self.policy(params, obs)
        env_state, obs, reward, step_done = self.env.step(env_state, action)
        # Accumulate in float32 regardless of the environment's dtypes.
        total = total + torch.where(done, 0.0, reward.to(torch.float32))
        done = done | step_done
        return env_state, obs, total, done

    def _rollout(self, carry: tuple, length: int) -> tuple:
        """``length`` steps of every episode of the grid; the program of
        ``graph.run`` (returns ``((total,), {}, None)``)."""
        params, env_state, obs, total, done = carry
        step = torch.func.vmap(self._episode_step)
        for _ in range(length):
            env_state, obs, total, done = step(params, env_state, obs, total, done)
        return (total,), {}, None

    def evaluate(self, state: State, pop_params: Any) -> tuple[torch.Tensor, State]:
        if self.rotate_key:
            next_key, eval_key = rng.split_keys(state.key, 2)
        else:
            next_key = eval_key = state.key
        episodes = self.num_episodes
        env_state, obs = self._resets(torch.stack(rng.split_keys(eval_key, episodes)))

        leaves = pytree.tree_leaves(pop_params)
        pop = leaves[0].shape[0]
        device = leaves[0].device

        # The grid's leaves are made contiguous: the eager replay (which
        # copies them into its graph's buffers) and a segment's inline
        # capture then read them in one layout, so the products are the
        # same.
        def per_individual(p):  # (pop, ...) -> (pop * episodes, ...)
            grid = p.unsqueeze(1).expand(pop, episodes, *p.shape[1:])
            return grid.reshape(pop * episodes, *p.shape[1:]).contiguous()

        def per_episode(x):  # (episodes, ...) -> (pop * episodes, ...)
            return x.unsqueeze(0).expand(pop, *x.shape).reshape(pop * episodes, *x.shape[1:]).contiguous()

        carry = (
            pytree.tree_map(per_individual, pop_params),
            pytree.tree_map(per_episode, env_state),
            pytree.tree_map(per_episode, obs),
            torch.zeros((pop * episodes,), dtype=torch.float32, device=device),
            torch.zeros((pop * episodes,), dtype=torch.bool, device=device),
        )
        if graph.replays(device):
            (total,), _, _ = graph.run(self._graphs, "rollout", self._rollout, carry, self.max_episode_length)
        else:
            (total,), _, _ = self._rollout(carry, self.max_episode_length)
        fitness = torch.func.vmap(self.reduce_fn)(total.reshape(pop, episodes))
        if self.maximize_reward:
            fitness = -fitness
        return fitness, state.replace(key=next_key)
