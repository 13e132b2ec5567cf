"""The port's neuroevolution problems
(``evox_tpu_torch.problems.neuroevolution``: ``MLPPolicy``, the pendulum
and cart-pole environments, ``RolloutProblem``,
``SupervisedLearningProblem``) against the JAX package's, on the CPU at
small sizes (pop <= 16, T <= 50, MLP <= 4-8-1).

Inputs are numpy arrays made from a seed; the JAX package's policy
parameters are carried across with ``params_from_numpy``.  JAX runs one
operation at a time (``jax.disable_jit``: a jitted program would fuse
``a + dt * b`` into one multiply-add).  The two random streams differ, so
the episodes' initial states are JAX's, handed to the port through
``RolloutProblem._resets`` (:class:`Injected`), and OpenES's normals
through its ``_draws`` seam.  Tolerances:

* :data:`MLP_ATOL` for policy outputs (products summed in another order);
* :data:`STEP_RTOL` for environment states over 50 steps (``sin``,
  ``cos`` and the products differ in the last bits and the dynamics
  amplify them; ``done`` must agree exactly);
* cart-pole returns exactly, for the episodes whose JAX trajectory stays
  at least :data:`EDGE_MARGIN` away from a termination threshold
  (checked, not assumed); pendulum returns within :data:`RETURN_RTOL`.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.algorithms import OpenES as JOpenES  # noqa: E402
from evox_tpu.problems import neuroevolution as jne  # noqa: E402
from evox_tpu.utils import ParamsAndVector as JParamsAndVector  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import PSO, OpenES  # noqa: E402
from evox_tpu_torch.problems import neuroevolution as tne  # noqa: E402
from evox_tpu_torch.utils import ParamsAndVector, rng  # noqa: E402
from evox_tpu_torch.utils.convert import params_from_numpy  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402
from test_torch_rvea import Injected as InjectedDraws  # noqa: E402

CPU = torch.device("cpu")
# Policy outputs in [-1, 1]: measured at most 3.6e-7 apart (4-32-32-1).
MLP_ATOL = 2e-6
# Environment states over 50 steps, relative to the largest magnitude:
# measured 2.5e-7 (cart-pole) and 1.8e-5 (pendulum, whose clamped,
# accelerating swing amplifies the last-bit differences of sin).
STEP_RTOL = 1e-4
# Pendulum returns (sums of 50 costs) against JAX's.
RETURN_RTOL = 1e-4
# A cart-pole episode whose |x| or |theta| comes this close to 2.4 or 12
# degrees may end one step apart in the two frameworks.
EDGE_MARGIN = 1e-4
# OpenES's center after a generation: the gradient estimate is a product
# summed over the population in another order.
CENTER_RTOL = 1e-5
THETA_LIMIT = 12 * math.pi / 180


def jeval(fn, *args):
    """JAX ``fn`` run one operation at a time (no fused multiply-add)."""
    with jax.disable_jit():
        return fn(*args)


def to_torch(tree):
    """A JAX pytree (tuples, dicts, arrays) as the same nest of CPU tensors."""
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class Injected:
    """Mixin: the episodes' initial states supplied from outside."""

    next_resets = None

    def _resets(self, episode_keys):
        if self.next_resets is None:
            return super()._resets(episode_keys)
        assert self.next_resets[1].shape[0] == episode_keys.shape[0]
        return self.next_resets


class InjectedRollout(Injected, tne.RolloutProblem):
    pass


class InjectedOpenES(InjectedDraws, OpenES):
    pass


def jax_resets(jprob, key):
    """The initial ``(env_state, obs)`` of JAX's next evaluation from its
    problem key: the keys ``RolloutProblem.evaluate`` derives."""
    eval_key = jax.random.split(key)[1] if jprob.rotate_key else key
    return jax.vmap(jprob.env.reset)(jax.random.split(eval_key, jprob.num_episodes))


def jax_params(sizes, seed=1, pop=None):
    """JAX's ``MLPPolicy(sizes).init`` (one model, or a population of
    ``pop`` made by ``stack_model_params``) as numpy arrays."""
    policy = jne.MLPPolicy(sizes)
    if pop is None:
        params = policy.init(jax.random.key(seed))
    else:
        params = jne.stack_model_params(policy.init, jax.random.key(seed), pop)
    return jax.tree.map(np.asarray, params)


def jax_margin(apply, env_step, params, s0, obs0, steps, edge) -> np.ndarray:
    """Each (individual, episode)'s closest approach to a termination
    threshold (``edge(env_state)``, a distance) up to and including its
    last counted step, along JAX's trajectory from ``s0``/``obs0`` (leading
    episode axis) under ``params`` (leading pop axis)."""
    act = jax.vmap(jax.vmap(apply, in_axes=(None, 0)), in_axes=(0, 0))
    step = jax.vmap(jax.vmap(env_step))

    @jax.jit
    def run(params, s0, obs0):
        pop = jax.tree.leaves(params)[0].shape[0]
        grid = lambda x: jnp.broadcast_to(x, (pop,) + x.shape)  # noqa: E731
        obs = grid(obs0)

        def body(carry, _):
            state, obs, margin, done = carry
            state, obs, _, step_done = step(state, act(params, obs))
            margin = jnp.where(done, margin, jnp.minimum(margin, edge(state)))
            return (state, obs, margin, done | step_done), None

        init = (jax.tree.map(grid, s0), obs, jnp.full(obs.shape[:2], jnp.inf), jnp.zeros(obs.shape[:2], bool))
        return jax.lax.scan(body, init, None, length=steps)[0][2]

    return np.asarray(run(params, s0, obs0))


def cartpole_edge(state):
    """Distance of a cart-pole state to its termination thresholds."""
    return jnp.minimum(jnp.abs(jnp.abs(state[0]) - 2.4), jnp.abs(jnp.abs(state[2]) - THETA_LIMIT))


def cartpole_margin(policy, params, s0, obs0, steps) -> np.ndarray:
    return jax_margin(policy.apply, jne.cartpole().step, params, s0, obs0, steps, cartpole_edge)


# ---------------------------------------------------------------------------
# MLPPolicy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [(4, 8, 1), (3, 8, 1), (4, 8, 8, 2)])
def test_mlp_apply_matches_jax(sizes):
    params = jax_params(sizes)
    x = np.random.default_rng(0).standard_normal((16, sizes[0])).astype(np.float32) * 2
    want = np.asarray(jax.vmap(lambda o: jne.MLPPolicy(sizes).apply(params, o))(x))
    policy = tne.MLPPolicy(sizes)
    p = params_from_numpy(params, CPU)
    got = torch.func.vmap(lambda o: policy(p, o))(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MLP_ATOL)
    # One observation, no vmap: the same rows.
    np.testing.assert_allclose(policy.apply(p, torch.from_numpy(x[3])).numpy(), want[3], rtol=0, atol=MLP_ATOL)


def test_params_from_numpy_carries_jax_params():
    params = jax_params((4, 8, 1))
    p = params_from_numpy(params, CPU)
    assert sorted(p) == sorted(params)
    for k in params:
        assert p[k].dtype == torch.float32 and p[k].device == CPU
        np.testing.assert_array_equal(p[k].numpy(), params[k])
    # The port's flat vector is ravel_pytree's.
    want = np.asarray(JParamsAndVector(params).to_vector(params))
    np.testing.assert_array_equal(ParamsAndVector(p).to_vector(p).numpy(), want)


def test_mlp_init_and_stacked_population():
    policy = tne.MLPPolicy((4, 32, 1))
    key = rng.key(5)
    params = policy.init(key)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "w0": (4, 32), "b0": (32,), "w1": (32, 1), "b1": (1,)}
    assert all(not p.any() for k, p in params.items() if k.startswith("b"))
    # He-scaled normals: std sqrt(2 / fan_in), the same shapes as JAX's.
    assert abs(float(params["w0"].std()) / math.sqrt(2 / 4) - 1) < 0.3
    assert {k: v.shape for k, v in jax_params((4, 32, 1)).items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    # A stacked population (one batched draw a layer) is each child key's
    # own init, bit for bit.
    pop = tne.stack_model_params(policy.init, key, 5)
    for i, child in enumerate(rng.split_keys(key, 5)):
        solo = policy.init(child)
        for k in solo:
            assert pop[k].shape == (5,) + solo[k].shape
            torch.testing.assert_close(pop[k][i], solo[k], rtol=0, atol=0)
    assert not torch.equal(pop["w0"][0], pop["w0"][1])


def test_mlp_rejects_one_layer_size():
    with pytest.raises(ValueError):
        tne.MLPPolicy((4,))


# ---------------------------------------------------------------------------
# Environments
# ---------------------------------------------------------------------------


def _env_case(name, episodes, seed):
    r = np.random.default_rng(seed)
    if name == "cartpole":
        s0 = tuple(r.uniform(-0.05, 0.05, episodes).astype(np.float32) for _ in range(4))
        actions = r.uniform(-1.5, 1.5, (50, episodes, 1)).astype(np.float32)
    else:
        s0 = (r.uniform(-np.pi, np.pi, episodes).astype(np.float32),
              r.uniform(-1, 1, episodes).astype(np.float32))
        actions = r.uniform(-3, 3, (50, episodes, 1)).astype(np.float32)
    return s0, actions


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_steps_match_jax(name):
    """50 steps of 16 episodes from the same states under the same actions
    (beyond the clip bounds): states, observations and rewards within
    STEP_RTOL, ``done`` equal, every step."""
    jenv, tenv = getattr(jne, name)(), getattr(tne, name)()
    assert (tenv.obs_size, tenv.action_size) == (jenv.obs_size, jenv.action_size)
    s0, actions = _env_case(name, 16, 1)
    jstep, tstep = jax.vmap(jenv.step), torch.func.vmap(tenv.step)
    js = tuple(jnp.asarray(a) for a in s0)
    ts = tuple(torch.from_numpy(a) for a in s0)
    worst = 0.0
    with jax.disable_jit():
        for a in actions:
            js, jobs, jrew, jdone = jstep(js, jnp.asarray(a))
            ts, tobs, trew, tdone = tstep(ts, torch.from_numpy(a))
            for got, want in zip((*ts, tobs, trew), (*js, jobs, jrew)):
                assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
                worst = max(worst, rel(got, want))
            assert tdone.dtype == torch.bool
            np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert worst <= STEP_RTOL


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_step_takes_batch_shaped_state(name):
    """``step`` on (episodes,) state tensors and an (episodes, 1) action,
    with no vmap, equals the vmapped step bit for bit."""
    tenv = getattr(tne, name)()
    s0, actions = _env_case(name, 8, 2)
    ts = tuple(torch.from_numpy(a) for a in s0)
    a = torch.from_numpy(actions[0])
    for got, want in zip(tenv.step(ts, a), torch.func.vmap(tenv.step)(ts, a)):
        got, want = (got, want) if isinstance(got, torch.Tensor) else (torch.stack(got), torch.stack(want))
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["cartpole", "pendulum"])
def test_env_reset_draws_in_range_with_one_batched_launch(name, monkeypatch):
    """A vmapped reset of many episodes is one call of the draw operator
    (one batched launch on the card), its values in the JAX package's
    ranges and each episode's own."""
    from evox_tpu_torch.ops import philox

    calls = []
    real = philox.philox_draws_batched_plain
    monkeypatch.setattr(philox, "philox_draws_batched_plain",
                        lambda keys, *a: calls.append(tuple(keys.shape)) or real(keys, *a))
    env = getattr(tne, name)()
    keys = torch.stack(rng.split_keys(rng.key(3), 64))
    state, obs = torch.func.vmap(env.reset)(keys)
    assert calls == [(64, 2)]
    assert obs.shape == (64, env.obs_size)
    if name == "cartpole":
        assert bool((obs.abs() <= 0.05).all())
    else:
        assert bool((state[0].abs() <= math.pi).all()) and bool((state[1].abs() <= 1).all())
    solo = env.reset(keys[7])[1]
    torch.testing.assert_close(obs[7], solo, rtol=0, atol=0)
    assert len(torch.unique(obs[:, 0])) == 64


# ---------------------------------------------------------------------------
# RolloutProblem
# ---------------------------------------------------------------------------


def _rollout_pair(env_name, sizes, pop, steps, episodes, rotate_key=True, maximize_reward=True, seed=1):
    jpolicy, tpolicy = jne.MLPPolicy(sizes), tne.MLPPolicy(sizes)
    kw = dict(max_episode_length=steps, num_episodes=episodes, rotate_key=rotate_key,
              maximize_reward=maximize_reward)
    jprob = jne.RolloutProblem(jpolicy.apply, getattr(jne, env_name)(), **kw)
    tprob = InjectedRollout(tpolicy.apply, getattr(tne, env_name)(), **kw)
    return jpolicy, jprob, tprob, jax_params(sizes, seed, pop)


@pytest.mark.parametrize("env_name,sizes", [("cartpole", (4, 8, 1)), ("pendulum", (3, 8, 1))])
@pytest.mark.parametrize("episodes", [1, 3])
def test_rollout_matches_jax_from_injected_states(env_name, sizes, episodes):
    """16 individuals, 50 steps, from JAX's initial states: the fitness
    JAX's (jitted) evaluation gives, and with ``maximize_reward=False``
    its negation."""
    jpolicy, jprob, tprob, params = _rollout_pair(env_name, sizes, 16, 50, episodes)
    jkey = jax.random.key(7)
    want, _ = jax.jit(jprob.evaluate)(jprob.setup(jkey), params)
    want = np.asarray(want)
    s0, obs0 = jax.jit(jax_resets, static_argnums=0)(jprob, jkey)
    tprob.next_resets = (to_torch(s0), to_torch(obs0))
    tparams = params_from_numpy(params, CPU)
    got, _ = tprob.evaluate(tprob.setup(rng.key(7)), tparams)
    assert got.shape == (16,) and got.dtype == torch.float32
    tprob.maximize_reward = False
    raw, _ = tprob.evaluate(tprob.setup(rng.key(7)), tparams)
    torch.testing.assert_close(raw, -got, rtol=0, atol=0)
    if env_name == "pendulum":
        assert rel(got, want) <= RETURN_RTOL
        assert bool((raw < 0).all())  # returns are sums of -cost
        return
    margin = cartpole_margin(jpolicy, params, s0, obs0, 50)
    clear = (margin >= EDGE_MARGIN).all(axis=1)
    assert clear.sum() >= 14, margin  # the comparison holds on most individuals
    # The episodes' summed returns exactly; their mean (jitted XLA divides
    # in its own way) within an ulp.
    np.testing.assert_array_equal(np.round(got.numpy() * episodes)[clear], np.round(want * episodes)[clear])
    np.testing.assert_allclose(got.numpy()[clear], want[clear], rtol=2.0**-23, atol=0)
    returns = raw.numpy()
    assert ((returns >= 0) & (returns <= 50) & (returns == np.round(returns * episodes) / episodes)).all()
    assert len(np.unique(returns)) > 1


def test_done_is_sticky_and_stops_the_reward():
    """An environment whose ``done`` flips on at step 3 and off again at
    step 4: the return counts the steps up to and including the one that
    ended the episode, as JAX's does."""

    def jstep(t, action):
        t = t + 1
        return t, jnp.stack([t, t]), jnp.ones_like(t), (t == 3) | (t == 7)

    jenv = jne.Env(lambda key: (jnp.zeros(()), jnp.zeros((2,))), jstep, 2, 1)
    jprob = jne.RolloutProblem(lambda p, o: o[:1] * p["w"], jenv, 10)
    want, _ = jprob.evaluate(jprob.setup(jax.random.key(0)), {"w": jnp.ones((3, 1))})

    def treset(key):
        z = torch.zeros_like(key[0], dtype=torch.float32)
        return z, torch.stack([z, z])

    def tstep(t, action):
        t = t + 1
        return t, torch.stack([t, t]), torch.ones_like(t), (t == 3) | (t == 7)

    tprob = tne.RolloutProblem(lambda p, o: o[:1] * p["w"], tne.Env(treset, tstep, 2, 1), 10)
    got, _ = tprob.evaluate(tprob.setup(rng.key(0)), {"w": torch.ones((3, 1))})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [-3.0, -3.0, -3.0])


def test_rotate_key_on_and_off():
    policy = tne.MLPPolicy((4, 8, 1))
    pop = tne.stack_model_params(policy.init, rng.key(2), 6)
    # Two equal individuals: the episode keys are shared by the population.
    pop = {k: torch.cat([v, v[:1]]) for k, v in pop.items()}
    fixed = tne.RolloutProblem(policy, tne.cartpole(), 30, num_episodes=2, rotate_key=False)
    s = fixed.setup(rng.key(4))
    f1, s1 = fixed.evaluate(s, pop)
    f2, s2 = fixed.evaluate(s1, pop)
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    assert torch.equal(s2.key, s.key)
    assert float(f1[0]) == float(f1[-1])

    policy3 = tne.MLPPolicy((3, 8, 1))
    pop3 = tne.stack_model_params(policy3.init, rng.key(2), 6)
    rotating = tne.RolloutProblem(policy3, tne.pendulum(), 30, num_episodes=2)
    s = rotating.setup(rng.key(4))
    g1, s1 = rotating.evaluate(s, pop3)
    g2, s2 = rotating.evaluate(s1, pop3)
    assert not torch.equal(s1.key, s.key) and not torch.equal(s2.key, s1.key)
    assert not torch.equal(g1, g2)
    # The same state gives the same fitness: the stream is the key's.
    torch.testing.assert_close(rotating.evaluate(s, pop3)[0], g1, rtol=0, atol=0)


def test_direction_conventions_drive_the_algorithm_identically():
    """Problem-side negation (``maximize_reward=True`` with "min") and
    workflow-side direction (``maximize_reward=False`` with "max") give the
    same trajectory; mixing them would optimize toward the worst return."""
    policy = tne.MLPPolicy((4, 4, 1))
    adapter = ParamsAndVector(policy.init(rng.key(0)))
    dim = adapter.vector_size

    def build(maximize_reward, opt_direction):
        prob = tne.RolloutProblem(policy, tne.cartpole(), 20, rotate_key=False, maximize_reward=maximize_reward)
        wf = StdWorkflow(PSO(8, -torch.ones(dim), torch.ones(dim), device=CPU), prob,
                         opt_direction=opt_direction, solution_transform=adapter.batched_to_params)
        s = wf.init_step(wf.init(3))
        for _ in range(2):
            s = wf.step(s)
        return s

    a, b = build(True, "min"), build(False, "max")
    torch.testing.assert_close(a.algorithm.pop, b.algorithm.pop, rtol=0, atol=0)
    torch.testing.assert_close(a.algorithm.fit, b.algorithm.fit, rtol=0, atol=0)


def test_rollout_vmaps_over_problem_instances():
    """``torch.func.vmap`` of ``evaluate`` over 2 instances (their own keys
    and populations, as an HPO level stacks them) equals each instance's
    solo evaluation bit for bit."""
    policy = tne.MLPPolicy((4, 8, 1))
    prob = tne.RolloutProblem(policy, tne.cartpole(), 25, num_episodes=2)
    pop = tne.stack_model_params(policy.init, rng.key(8), 6)
    pop2 = {k: v.reshape((2, 3) + v.shape[1:]) for k, v in pop.items()}
    keys = torch.stack(rng.split_keys(rng.key(9), 2))
    states = torch.func.vmap(prob.setup)(keys)
    fit, new_states = torch.func.vmap(prob.evaluate)(states, pop2)
    assert fit.shape == (2, 3)
    for i in range(2):
        solo, solo_state = prob.evaluate(prob.setup(keys[i]), {k: v[i] for k, v in pop2.items()})
        torch.testing.assert_close(fit[i], solo, rtol=0, atol=0)
        assert torch.equal(new_states.key[i], solo_state.key)


def test_rollout_runs_where_its_inputs_are_and_is_not_captured_on_the_cpu():
    policy = tne.MLPPolicy((4, 8, 1))
    prob = tne.RolloutProblem(policy, tne.cartpole(), 10)
    fit, _ = prob.evaluate(prob.setup(rng.key(0)), tne.stack_model_params(policy.init, rng.key(1), 4))
    assert fit.device == CPU
    assert len(prob._graphs) == 0


def test_graph_flatten_keeps_named_tuples():
    from evox_tpu_torch.problems.neuroevolution.minibrax import PipelineState

    tree = (PipelineState(torch.zeros(2), torch.ones(3)), {"a": torch.zeros(1)})
    leaves, spec = graph.flatten(tree)
    back = graph.unflatten(spec, leaves)
    assert type(back[0]) is PipelineState and torch.equal(back[0].qd, torch.ones(3))
    assert graph.structure(tree) == graph.structure(back)


# ---------------------------------------------------------------------------
# The slice as a whole: OpenES on cart-pole through StdWorkflow
# ---------------------------------------------------------------------------


def _bench_like(pop, steps, sizes=(4, 8, 1)):
    """bench.py's neuroevolution config at a small size, in both
    frameworks: OpenES (lr 0.02, sigma 0.05, adam) on cart-pole,
    ``maximize_reward=False`` with ``opt_direction="max"``, the vector
    population through ``ParamsAndVector.batched_to_params``."""
    params0 = jax_params(sizes)
    jpolicy, tpolicy = jne.MLPPolicy(sizes), tne.MLPPolicy(sizes)
    jadapter = JParamsAndVector(params0)
    jprob = jne.RolloutProblem(jpolicy.apply, jne.cartpole(), max_episode_length=steps, maximize_reward=False)
    jwf = JWorkflow(JOpenES(pop_size=pop, center_init=jadapter.to_vector(params0), learning_rate=0.02,
                            noise_stdev=0.05, optimizer="adam"),
                    jprob, opt_direction="max", solution_transform=jadapter.batched_to_params)
    tparams0 = params_from_numpy(params0, CPU)
    tadapter = ParamsAndVector(tparams0)
    tprob = InjectedRollout(tpolicy.apply, tne.cartpole(), max_episode_length=steps, maximize_reward=False)
    twf = StdWorkflow(InjectedOpenES(pop, tadapter.to_vector(tparams0), 0.02, 0.05, optimizer="adam", device=CPU),
                      tprob, monitor=EvalMonitor(), opt_direction="max",
                      solution_transform=tadapter.batched_to_params)
    return jpolicy, jadapter, jwf, twf


def test_openes_cartpole_workflow_matches_jax():
    """Three generations of the bench config (pop 16, T 50, MLP 4-8-1)
    from JAX's center, with JAX's normals and initial states injected into
    the port: the same fitness (the returns of individuals clear of the
    thresholds exactly) and centers within CENTER_RTOL.  JAX's steps are
    jitted, as its own tests run them: a fused multiply-add moves a
    center by an ulp, far inside the limit."""
    pop, steps = 16, 50
    jpolicy, jadapter, jwf, twf = _bench_like(pop, steps)
    jinit_step, jstep = jax.jit(jwf.init_step), jax.jit(jwf.step)
    js = jwf.init(jax.random.key(0))
    ts = twf.init(0)
    center = twf.algorithm.center_init
    np.testing.assert_array_equal(center.numpy(), np.asarray(js.algorithm.center))
    for gen in range(3):
        _, noise_key = jax.random.split(js.algorithm.key)
        half = jeval(lambda k: jax.random.normal(k, (pop // 2, center.shape[0])), noise_key)
        s0, obs0 = jax_resets(jwf.problem, js.problem.key)
        twf.algorithm.next_draws = [torch.from_numpy(np.array(half))]
        twf.problem.next_resets = (to_torch(s0), to_torch(obs0))
        # JAX's population of this generation, for the threshold margins.
        jpop = np.asarray(js.algorithm.center) + 0.05 * np.concatenate([half, -half])
        margin = cartpole_margin(jpolicy, jadapter.batched_to_params(jnp.asarray(jpop, jnp.float32)), s0, obs0, steps)
        js = (jinit_step if gen == 0 else jstep)(js)
        ts = (twf.init_step if gen == 0 else twf.step)(ts)
        clear = (margin >= EDGE_MARGIN).all(axis=1)
        assert clear.sum() >= pop - 2, margin
        np.testing.assert_array_equal(ts.algorithm.fit.numpy()[clear], np.asarray(js.algorithm.fit)[clear])
        assert rel(ts.algorithm.center, js.algorithm.center) <= CENTER_RTOL
    best = float(twf.monitor.get_best_fitness(ts.monitor))
    assert best == float(-np.asarray(js.algorithm.fit).min()) and 0 < best <= steps


def test_openes_cartpole_run_equals_eager_steps():
    """``run(5)`` (on the CPU: the same generations, eagerly) equals 5
    eager steps bit for bit, the monitor's history included."""
    def build():
        policy = tne.MLPPolicy((4, 8, 1))
        params0 = policy.init(rng.key(1))
        adapter = ParamsAndVector(params0)
        prob = tne.RolloutProblem(policy, tne.cartpole(), 30, maximize_reward=False)
        return StdWorkflow(OpenES(16, adapter.to_vector(params0), 0.02, 0.05, optimizer="adam", device=CPU),
                           prob, monitor=EvalMonitor(), opt_direction="max",
                           solution_transform=adapter.batched_to_params)

    wf = build()
    s = wf.init_step(wf.init(0))
    for _ in range(4):
        s = wf.step(s)
    fused_wf = build()
    f = fused_wf.run(fused_wf.init(0), 5)
    for a, b in zip(graph.flatten(s)[0], graph.flatten(f)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    hist, fhist = wf.monitor.get_fitness_history(), fused_wf.monitor.get_fitness_history()
    assert len(hist) == len(fhist) == 5
    for a, b in zip(hist, fhist):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SupervisedLearningProblem
# ---------------------------------------------------------------------------


def _linear(params, x):
    return x @ params["w"]


def _mse(p, y):
    return ((p - y) ** 2).mean()


def _jmse(p, y):
    return jnp.mean((p - y) ** 2)


def _regression(n=48, d=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, d)).astype(np.float32)
    w = np.array([[2.0], [-1.0], [0.5]], np.float32)[:d]
    return x, (x @ w).astype(np.float32), w


@pytest.mark.parametrize("batch_size,n_batch,reduction", [(16, 2, "mean"), (10, 1, "sum"), (8, -1, "mean"),
                                                          (None, 1, "mean")])
def test_supervised_device_resident_matches_jax(batch_size, n_batch, reduction):
    """Four evaluations (the cursor wraps) against JAX's, the same cursor
    after each; fitness within 1e-6 relative (per-example losses summed in
    another order); the true weights give zero loss."""
    x, y, w = _regression()
    r = np.random.default_rng(1)
    pop = np.concatenate([w[None], r.standard_normal((4, 3, 1)).astype(np.float32)])
    per_example = reduction == "sum"
    jprob = jne.SupervisedLearningProblem(
        _linear, jnp.asarray(x), jnp.asarray(y),
        criterion=(lambda p, l: jnp.sum((p - l) ** 2, axis=-1)) if per_example else _jmse,
        batch_size=batch_size, n_batch_per_eval=n_batch, reduction=reduction)
    tprob = tne.SupervisedLearningProblem(
        _linear, x, y, criterion=(lambda p, l: ((p - l) ** 2).sum(-1)) if per_example else _mse,
        batch_size=batch_size, n_batch_per_eval=n_batch, reduction=reduction, device=CPU)
    assert (tprob.num_batches, tprob.n_batch_per_eval) == (jprob.num_batches, jprob.n_batch_per_eval)
    js, ts = jprob.setup(jax.random.key(0)), tprob.setup(rng.key(0))
    tpop = {"w": torch.from_numpy(pop)}
    for _ in range(4):
        want, js = jeval(jprob.evaluate, js, {"w": jnp.asarray(pop)})
        got, ts = tprob.evaluate(ts, tpop)
        assert rel(got, want) <= 1e-6
        assert float(got[0]) < 1e-10 and int(got.argmin()) == 0
        assert ts.batch_cursor.dtype == torch.int32 and int(ts.batch_cursor) == int(js.batch_cursor)


def test_supervised_cursor_wraps_and_full_sweep():
    x, y, w = _regression(32, 3)
    prob = tne.SupervisedLearningProblem(_linear, x, y, criterion=_mse, batch_size=8, n_batch_per_eval=3,
                                         device=CPU)
    s = prob.setup(rng.key(0))
    cursors = []
    for _ in range(3):
        _, s = prob.evaluate(s, {"w": torch.zeros((1, 3, 1))})
        cursors.append(int(s.batch_cursor))
    assert cursors == [3, 2, 1]  # (0 + 3) % 4, (3 + 3) % 4, ...
    sweep = tne.SupervisedLearningProblem(_linear, x, y, criterion=_mse, batch_size=8, n_batch_per_eval=-1,
                                          device=CPU)
    fit, s = sweep.evaluate(sweep.setup(rng.key(0)), {"w": torch.from_numpy(w)[None]})
    assert sweep.n_batch_per_eval == 4 and int(s.batch_cursor) == 0 and float(fit[0]) < 1e-10
    full = sweep.evaluate(sweep.setup(rng.key(0)), {"w": torch.zeros((1, 3, 1))})[0]
    torch.testing.assert_close(full, torch.from_numpy(y).pow(2).mean()[None], rtol=1e-6, atol=0)


def test_supervised_rejects_bad_arguments():
    x, y, _ = _regression(8)
    with pytest.raises(ValueError, match="exceeds"):
        tne.SupervisedLearningProblem(_linear, x, y, criterion=_mse, batch_size=9, device=CPU)
    with pytest.raises(ValueError, match="criterion"):
        tne.SupervisedLearningProblem(_linear, x, y, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        tne.SupervisedLearningProblem(_linear, x, y, criterion=_mse, data_source=[(x, y)], device=CPU)
    with pytest.raises(ValueError, match="full sweep"):
        tne.SupervisedLearningProblem(_linear, criterion=_mse, data_source=[(x, y)], n_batch_per_eval=-1,
                                      device=CPU)


class _Batches:
    """A re-iterable source: batch k's labels are the constant k."""

    def __init__(self, n_batches, bs=4, ragged=False):
        self.n_batches, self.bs, self.ragged = n_batches, bs, ragged

    def __iter__(self):
        for k in range(self.n_batches):
            yield np.ones((self.bs, 1), np.float32), np.full((self.bs, 1), float(k), np.float32)
        if self.ragged:
            yield np.ones((2, 1), np.float32), np.full((2, 1), 99.0, np.float32)


def test_supervised_streaming_order_matches_jax():
    """With w = 0 the loss of batch k is k^2: both frameworks see the
    batches in source order, re-epoch after the last, and share each batch
    across the population."""
    jprob = jne.SupervisedLearningProblem(_linear, criterion=_jmse, data_source=_Batches(3))
    tprob = tne.SupervisedLearningProblem(_linear, criterion=_mse, data_source=_Batches(3), device=CPU)
    assert tprob.batch_size == jprob.batch_size == 4 and not tprob.capturable
    js, ts = jprob.setup(jax.random.key(0)), tprob.setup(rng.key(0))
    seen = []
    for _ in range(5):
        want, js = jprob.evaluate(js, {"w": jnp.zeros((2, 1, 1))})
        got, ts = tprob.evaluate(ts, {"w": torch.zeros((2, 1, 1))})
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got[0]) == float(got[1])
        seen.append(math.sqrt(float(got[0])))
    assert seen == [0.0, 1.0, 2.0, 0.0, 1.0] and int(ts.batch_cursor) == 5


def test_supervised_streaming_skips_ragged_and_takes_several_batches():
    prob = tne.SupervisedLearningProblem(_linear, criterion=_mse, data_source=_Batches(2, ragged=True),
                                         n_batch_per_eval=2, device=CPU)
    s = prob.setup(rng.key(0))
    for _ in range(2):  # the ragged batch is dropped, not delivered
        fit, s = prob.evaluate(s, {"w": torch.zeros((1, 1, 1))})
        assert float(fit[0]) == pytest.approx(0.5)


def test_supervised_streaming_one_shot_iterator_errors():
    def gen():
        for _ in range(2):
            yield np.zeros((2, 1), np.float32), np.zeros((2, 1), np.float32)

    prob = tne.SupervisedLearningProblem(_linear, criterion=_mse, data_source=gen(), device=CPU)
    s = prob.setup(rng.key(0))
    for _ in range(2):
        _, s = prob.evaluate(s, {"w": torch.zeros((1, 1, 1))})
    with pytest.raises(RuntimeError, match="re-iterable"):
        prob.evaluate(s, {"w": torch.zeros((1, 1, 1))})


def test_supervised_streaming_torch_dataloader():
    from torch.utils.data import DataLoader, TensorDataset

    xs = torch.arange(32, dtype=torch.float32).reshape(32, 1)
    loader = DataLoader(TensorDataset(xs, 2.0 * xs), batch_size=8, shuffle=False)
    prob = tne.SupervisedLearningProblem(_linear, criterion=_mse, data_source=loader, device=CPU)
    fit, _ = prob.evaluate(prob.setup(rng.key(0)), {"w": torch.tensor([[[2.0]], [[0.0]]])})
    assert float(fit[0]) == 0.0 and float(fit[1]) > 0.0


@pytest.mark.parametrize("streaming", [False, True])
def test_supervised_workflow_run_equals_eager_steps(streaming):
    """OpenES on a regression through ``run(4)`` equals 4 eager steps bit
    for bit; on the CPU a fused segment pulls the streamed batches in
    source order, as eager steps do."""
    x, y, _ = _regression(32)

    def build():
        kw = (dict(data_source=[(x[i:i + 8], y[i:i + 8]) for i in range(0, 32, 8)]) if streaming
              else dict(inputs=x, labels=y, batch_size=8))
        prob = tne.SupervisedLearningProblem(_linear, criterion=_mse, device=CPU, **kw)
        adapter = ParamsAndVector({"w": torch.zeros((3, 1))})
        return StdWorkflow(OpenES(8, torch.zeros(3), 0.1, 0.1, device=CPU), prob,
                           solution_transform=adapter.batched_to_params)

    wf = build()
    s = wf.init_step(wf.init(1))
    for _ in range(3):
        s = wf.step(s)
    other = build()
    f = other.run(other.init(1), 4)
    for a, b in zip(graph.flatten(s)[0], graph.flatten(f)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
