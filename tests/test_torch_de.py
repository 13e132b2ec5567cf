"""The port's DE family (``evox_tpu_torch.algorithms.so.de_variants``), its
crossovers, ``select_rand_pbest``, the normal and categorical draws and the
JAX-style ``nanmedian``, against the JAX package's, on the CPU.

Draws: JAX's own (``jax.random`` from the same keys as its step) go through
the port's ``_draws`` seams and the operators' ``draws=`` arguments.

Arithmetic: XLA's CPU backend contracts ``a * b + c`` inside a fused
program into one fused multiply-add; the port, like JAX run one operation
at a time, rounds the product and the sum separately.  The algorithm steps
are therefore held against JAX's step run eagerly (``jax.disable_jit``),
where each operation rounds on its own, and the port's workflow evaluates
its trials with the JAX problem (:class:`JaxEvaluated`), so that fitness,
population, index tables, masks and selections must be equal bit for bit.
Only values summed over the population may differ in the last bits, as the
two frameworks add in another order: JaDE's adaptive means, SHADE's
success memory (``SUM_ULP``).  The whole slice, the port's CEC2022 with the
port's DE, is held separately within the CEC2022 float32 tolerance.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu import algorithms as jalgorithms  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.operators import crossover as jcross  # noqa: E402
from evox_tpu.operators.selection import select_rand_pbest as jpbest  # noqa: E402
from evox_tpu.problems.numerical import CEC2022 as JCEC2022  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.core import Problem  # noqa: E402
from evox_tpu_torch.operators import crossover  # noqa: E402
from evox_tpu_torch.operators.crossover import differential_evolution as de_ops  # noqa: E402
from evox_tpu_torch.operators.selection import select_rand_pbest  # noqa: E402
from evox_tpu_torch.operators.selection.find_pbest import pbest_count  # noqa: E402
from evox_tpu_torch.ops import philox  # noqa: E402
from evox_tpu_torch.problems.numerical import CEC2022  # noqa: E402
from evox_tpu_torch.utils import nanmedian, rng  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402
from test_torch_rvea import Injected  # noqa: E402

N, D, GENS = 48, 10, 5
# Units in the last place allowed where a float sum over the population is
# taken in another order (JaDE's F_u/CR_u, SHADE's memory): each of the n
# addends may round differently, the means divide two such sums.
SUM_ULP = 64
F32_RTOL = 2e-4  # the CEC2022 float32 tolerance (tests/test_torch_cec2022.py)


def long(a):
    return t(a).to(torch.int64)


def jeval(fn, *args):
    """JAX ``fn`` run one operation at a time (no fused multiply-add)."""
    with jax.disable_jit():
        return fn(*args)


def ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(2**31) - ia, ia)
    ib = np.where(ib < 0, -(2**31) - ib, ib)
    return np.abs(ia - ib)


# ---------------------------------------------------------------------------
# Draw helpers: JAX's draws from the keys its operators split.
# ---------------------------------------------------------------------------


def binary_draws(key, n, d):
    mask_key, j_key = jax.random.split(key)
    return t(jax.random.uniform(mask_key, (n, d))), long(jax.random.randint(j_key, (n,), 0, d))


def exponential_draws(key, n, d):
    n_key, l_key = jax.random.split(key)
    return long(jax.random.randint(n_key, (n,), 0, d)), t(jax.random.uniform(l_key, (n,)))


def trial_draws(key, n, d, pad):
    diff_key, pbest_key, cross_key = jax.random.split(key, 3)
    bin_key, exp_key = jax.random.split(cross_key)
    return (
        long(jax.random.randint(diff_key, (n, pad), 0, n)),
        long(jax.random.randint(pbest_key, (n,), 0, pbest_count(n, 0.05))),
        binary_draws(bin_key, n, d),
        exponential_draws(exp_key, n, d),
    )


def de_draws(ja, algo):
    _, choice_key, cx_key = jax.random.split(ja.key, 3)
    n, d = ja.pop.shape
    num_vec = 2 * algo.num_difference_vectors + (0 if algo.best_vector else 1)
    return long(jax.random.randint(choice_key, (num_vec, n), 0, n)), binary_draws(cx_key, n, d)


def jade_draws(ja, algo):
    _, f_key, cr_key, choice_key, pbest_key, cx_key = jax.random.split(ja.key, 6)
    n, d = ja.pop.shape
    return (
        t(jax.random.normal(f_key, (n,))),
        t(jax.random.normal(cr_key, (n,))),
        long(jax.random.randint(choice_key, (2 * algo.num_difference_vectors + 1, n), 0, n)),
        long(jax.random.randint(pbest_key, (n,), 0, pbest_count(n, 0.05))),
        binary_draws(cx_key, n, d),
    )


def shade_draws(ja, algo):
    _, perm_key, f_key, cr_key, trial_key = jax.random.split(ja.key, 5)
    n, d = ja.pop.shape
    return (
        long(jax.random.permutation(perm_key, n)),
        t(jax.random.normal(f_key, (n,))),
        t(jax.random.normal(cr_key, (n,))),
        trial_draws(trial_key, n, d, algo.diff_padding_num),
    )


def sade_draws(ja, algo):
    _, strat_key, cr_key, cr_fix_key, f_key, trial_key = jax.random.split(ja.key, 6)
    n, d = ja.pop.shape

    def probabilities():
        # The step's own expressions (sade.py), so the logits are its bits.
        s = jnp.sum(ja.success_memory, axis=0)
        f = jnp.sum(ja.failure_memory, axis=0)
        S = s / (s + f + 1e-12) + 0.01
        return jnp.where(ja.gen_iter >= algo.LP, S / jnp.sum(S), jnp.full((4,), 0.25))

    p = jeval(probabilities)
    return (
        long(jax.random.categorical(strat_key, jnp.log(p), shape=(n,))),
        t(jax.random.normal(cr_key, (n, 4))),
        t(jax.random.normal(cr_fix_key, (n, 4))),
        t(jax.random.normal(f_key, (n,))),
        trial_draws(trial_key, n, d, algo.diff_padding_num),
    )


def code_draws(ja, algo):
    _, param_key, *trial_keys = jax.random.split(ja.key, 5)
    n, d = ja.pop.shape
    return (
        long(jax.random.randint(param_key, (3, n), 0, algo.param_pool.shape[0])),
        [trial_draws(k, n, d, algo.diff_padding_num) for k in trial_keys],
    )


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


def _pop(n, d, seed):
    return np.random.default_rng(seed).uniform(-100, 100, (n, d)).astype(np.float32)


@pytest.mark.parametrize("num_diff", ["1", "2", "per_row"])
@pytest.mark.parametrize("n,pad", [(48, 9), (17, 5)])
def test_differential_sum_matches_jax(num_diff, n, pad):
    x = _pop(n, D, n + pad)
    key = jax.random.key(n * pad)
    if num_diff == "per_row":
        k = np.random.default_rng(3).integers(1, (pad - 1) // 2 + 1, n)
        jk, tk = jnp.asarray(k), torch.from_numpy(k)
    else:
        jk = tk = int(num_diff)
    index = np.arange(n)
    jsum, jfirst = jcross.DE_differential_sum(key, pad, jk, jnp.asarray(index), jnp.asarray(x))
    draws = long(jax.random.randint(key, (n, pad), 0, n))
    tsum, tfirst = crossover.DE_differential_sum(None, pad, tk, torch.from_numpy(index), t(x), draws=draws)
    np.testing.assert_array_equal(tsum.numpy(), np.asarray(jsum))
    np.testing.assert_array_equal(tfirst.numpy(), np.asarray(jfirst))


@pytest.mark.parametrize("cr", ["scalar", "vector"])
def test_binary_crossover_matches_jax(cr):
    n = 64
    v, x = _pop(n, D, 1), _pop(n, D, 2)
    CR = np.float32(0.3) if cr == "scalar" else np.random.default_rng(4).uniform(0, 1, n).astype(np.float32)
    key = jax.random.key(5)
    want = jcross.DE_binary_crossover(key, jnp.asarray(v), jnp.asarray(x), jnp.asarray(CR))
    tCR = t(CR) if cr == "vector" else float(CR)
    got = crossover.DE_binary_crossover(None, t(v), t(x), tCR, draws=binary_draws(key, n, D))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


EXP_CR = {
    "scalar": np.float32(0.7),
    "vector": np.random.default_rng(6).uniform(0, 1, 64).astype(np.float32),
    # JaDE and SHADE clip CR to [0, 1]: 0 gives an infinite length.
    "zero": np.zeros(64, np.float32),
    # SaDE's CR may leave [0, 1]: log1p of a CR below -1 is NaN.
    "nan_and_negative": np.array([np.nan, -1.5, -1.0, -0.5, 1.0, 5.0] * 10 + [0.0] * 4, np.float32),
}


@pytest.mark.parametrize("cr", list(EXP_CR))
def test_exponential_crossover_matches_jax(cr):
    n = 64
    v, x = _pop(n, D, 7), _pop(n, D, 8)
    CR = EXP_CR[cr]
    key = jax.random.key(9)
    want = jcross.DE_exponential_crossover(key, jnp.asarray(v), jnp.asarray(x), jnp.asarray(CR))
    tCR = float(CR) if cr == "scalar" else t(CR)
    got = crossover.DE_exponential_crossover(None, t(v), t(x), tCR, draws=exponential_draws(key, n, D))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_saturating_cast_matches_xla():
    v = np.array([np.inf, np.nan, -np.inf, 3e9, -3e9, 2.0**31, -(2.0**31), 2147483520.0,
                  -2147483520.0, 1.5, -1.5, -0.0, 7.0], np.float32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int32))
    got = de_ops.saturating_int32(t(v))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(want[:3], [2**31 - 1, 0, -(2**31)])


@pytest.mark.parametrize("k", ["scalar", "vector"])
def test_arithmetic_recombination_matches_jax(k):
    n = 40
    v, x = _pop(n, D, 10), _pop(n, D, 11)
    K = np.float32(0.8) if k == "scalar" else np.random.default_rng(12).uniform(0, 1, n).astype(np.float32)
    want = jeval(jcross.DE_arithmetic_recombination, jnp.asarray(v), jnp.asarray(x), jnp.asarray(K))
    got = crossover.DE_arithmetic_recombination(t(v), t(x), t(K) if k == "vector" else float(K))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PBEST_FIT = {
    "random": np.random.default_rng(13).uniform(0, 1, 100).astype(np.float32),
    # Ties, signed zeros and NaN of both signs: a stable argsort with NaN
    # last and -0 == +0, as jnp.argsort.
    "ties": np.array([0.0, -0.0, np.nan, 1.0, -np.nan, 0.0, -0.0, -1.0, np.nan, 2.0] * 10, np.float32),
    "all_nan": np.full(100, np.nan, np.float32),
}


@pytest.mark.parametrize("kind", list(PBEST_FIT))
@pytest.mark.parametrize("percent", [0.05, 0.2, 0.001])
def test_select_rand_pbest_matches_jax(kind, percent):
    fit = PBEST_FIT[kind]
    n = fit.shape[0]
    x = _pop(n, D, 14)
    key = jax.random.key(15)
    want = jpbest(key, percent, jnp.asarray(x), jnp.asarray(fit))
    draws = long(jax.random.randint(key, (n,), 0, pbest_count(n, percent)))
    got = select_rand_pbest(None, percent, t(x), t(fit), draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        torch.argsort(t(fit), stable=True).numpy(), np.asarray(jnp.argsort(jnp.asarray(fit)))
    )


ARGMIN_FIT = {
    "nan": np.array([3.0, np.nan, 1.0, np.nan, -2.0], np.float32),
    "ties": np.array([2.0, -0.0, 0.0, -0.0, 5.0], np.float32),
    "inf": np.array([np.inf, np.inf, -np.inf, -np.inf], np.float32),
}


@pytest.mark.parametrize("kind", list(ARGMIN_FIT))
def test_best_index_matches_jax_argmin(kind):
    """The best index of DE's ``best`` base, SHADE, SaDE and CoDE: the
    first NaN if any (as ``jnp.argmin``), else the first minimum."""
    fit = ARGMIN_FIT[kind]
    assert int(torch.argmin(t(fit))) == int(jnp.argmin(jnp.asarray(fit)))
    table = np.stack([fit, fit[::-1], np.roll(fit, 2)])
    np.testing.assert_array_equal(torch.argmin(t(table), dim=0).numpy(), np.asarray(jnp.argmin(table, axis=0)))


NANMEDIAN = {
    "even": np.array([[0.1], [0.4], [np.nan], [0.3], [0.2]], np.float32),
    "odd": np.array([[0.1], [0.4], [0.5], [0.3], [0.2]], np.float32),
    "all_nan": np.full((5, 1), np.nan, np.float32),
    "no_nan_even": np.array([[3.0], [1.0], [4.0], [1.5]], np.float32),
    "one_valid": np.array([[np.nan], [0.7], [np.nan]], np.float32),
    "memory": np.where(np.random.default_rng(16).uniform(0, 1, (50, 4)) < 0.5, np.nan,
                       np.random.default_rng(17).uniform(0, 1, (50, 4))).astype(np.float32),
}


@pytest.mark.parametrize("kind", list(NANMEDIAN))
def test_nanmedian_matches_jax(kind):
    a = NANMEDIAN[kind]
    got = nanmedian(t(a), dim=0).numpy()
    want = np.asarray(jnp.nanmedian(jnp.asarray(a), axis=0))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    if kind == "even":
        # torch.nanmedian gives the lower middle value (0.2), JAX the mean.
        assert got[0] == np.float32(0.25) and float(torch.nanmedian(t(a)[:, 0])) == np.float32(0.2)


def _jax_uniform_floats(key, shape):
    """The [0, 1) floats jax.random builds from its bits (23 high bits)."""
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    return ((bits >> 9) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


# The two frameworks' float32 ``erfinv`` differ in the last places, most in
# the tails (XLA's polynomial, |z| > 3.5: up to 91 units); measured 5.8e-6
# relative on 2 x 10^5 uniforms, limit 1e-5.
NORMAL_RTOL = 1e-5


def test_normal_follows_jax_construction():
    key = jax.random.key(18)
    shape = (200_000,)
    got = rng.normal_from_uniform(t(_jax_uniform_floats(key, shape)))
    want = np.asarray(jax.random.normal(key, shape))
    np.testing.assert_allclose(got.numpy(), want, rtol=NORMAL_RTOL, atol=0)
    # The extremes of the construction: u = 0 maps to the value above -1.
    ends = rng.normal_from_uniform(torch.tensor([0.0, 0.5, 1 - 2.0**-24]))
    assert bool(torch.isfinite(ends).all()) and float(ends[0]) == -float(ends[2])


def test_categorical_follows_jax_construction():
    key = jax.random.key(19)
    logits = np.log(np.array([0.1, 0.2, 0.3, 0.4], np.float32))
    n = 20_000
    got = torch.argmax(rng.gumbel_from_uniform(t(_jax_uniform_floats(key, (n, 4)))) + t(logits), dim=-1)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), shape=(n,)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_draws_have_the_right_laws():
    k = rng.key(20)
    z = rng.normal(rng.child(k, 0), (200_000,), device="cpu")
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    p = torch.tensor([0.1, 0.2, 0.3, 0.4])
    c = rng.categorical(rng.child(k, 1), torch.log(p), (200_000,), device="cpu")
    freq = torch.bincount(c, minlength=4).float() / c.numel()
    assert float((freq - p).abs().max()) < 0.01


def test_operators_draw_once_per_call_from_consecutive_seeds(monkeypatch):
    """Each random operator draws in one kernel launch on the card, so
    here one plain draw per call; composite_trial draws from its seed and
    the three after it."""
    from evox_tpu_torch.algorithms.so.de_variants.strategy import composite_trial

    calls = []
    real = philox.philox_draws_plain

    def spy(seed, numel, kinds, device):
        calls.append((seed.index, numel))
        return real(seed, numel, kinds, device)

    monkeypatch.setattr(philox, "philox_draws_plain", spy)
    x = t(_pop(32, D, 21))
    fit = torch.arange(32, dtype=torch.float32)
    composite_trial(rng.Seed(rng.key(22), 5), x, fit, torch.tensor(0), torch.tensor([0, 1, 2, 3] * 8),
                    torch.zeros(32, dtype=torch.int64), torch.ones(32, dtype=torch.int64),
                    torch.tensor([0, 1, 2, 0] * 8), torch.full((32,), 0.5), torch.full((32,), 0.9), 9)
    assert calls == [(5, 32 * 9), (6, 32), (7, 32 * D), (8, 32)]


# ---------------------------------------------------------------------------
# Algorithms, step for step against JAX with injected draws
# ---------------------------------------------------------------------------


class JaxEvaluated(Problem):
    """A port problem that evaluates with the JAX package's problem, one
    operation at a time: the same fitness bits for the same population as
    JAX's eager step computes."""

    def __init__(self, jprob):
        self.jprob = jprob

    def evaluate(self, state, pop):
        fit = jeval(lambda: self.jprob.evaluate(JState(), jnp.asarray(pop.numpy()))[0])
        return torch.from_numpy(np.array(fit)), state


def _injected(cls):
    return type(f"Injected{cls.__name__}", (Injected, cls), {})


# (name, port/JAX class name, keyword arguments, draw helper)
ALGOS = [
    ("DE-rand-1", "DE", {}, de_draws),
    ("DE-rand-2", "DE", dict(num_difference_vectors=2, differential_weight=[0.5, 0.3]), de_draws),
    ("DE-best-1", "DE", dict(base_vector="best"), de_draws),
    ("DE-best-2", "DE", dict(base_vector="best", num_difference_vectors=2,
                             differential_weight=[0.6, 0.4]), de_draws),
    ("ODE", "ODE", {}, de_draws),
    ("JaDE", "JaDE", {}, jade_draws),
    ("SHADE", "SHADE", {}, shade_draws),
    # LP=2 takes SaDE through both branches on the generation count (the
    # strategy probabilities from gen_iter 2, the CR medians from 3).
    ("SaDE", "SaDE", dict(LP=2), sade_draws),
    ("CoDE", "CoDE", {}, code_draws),
]
# Leaves summed over the population (SUM_ULP); every other leaf exactly.
SUMMED = {"F_u", "CR_u", "memory_FCR"}


def _jax_kwargs(kw):
    return {k: jnp.asarray(v, jnp.float32) if k == "differential_weight" else v for k, v in kw.items()}


def _workflows(name, fn, seed):
    _, cls, kw, draws = next(a for a in ALGOS if a[0] == name)
    lb, ub = np.full(D, -100.0, np.float32), np.full(D, 100.0, np.float32)
    jprob = JCEC2022(fn, D)
    jalgo = getattr(jalgorithms, cls)(N, jnp.asarray(lb), jnp.asarray(ub), **_jax_kwargs(kw))
    algo = _injected(getattr(algorithms, cls))(N, t(lb), t(ub), device="cpu", **kw)
    return JWorkflow(jalgo, jprob), StdWorkflow(algo, JaxEvaluated(jprob)), jalgo, algo, draws


def _check_state(ts, js, what):
    ts, js = ts.algorithm, js.algorithm
    assert set(ts) == set(js), what
    for k in js:
        if k == "key":
            continue
        got, want = ts[k].numpy(), np.asarray(js[k])
        assert got.shape == want.shape and got.dtype == want.dtype, (what, k, got.dtype, want.dtype)
        if k in SUMMED:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: {k}")
            assert int(ulps(got, want).max()) <= SUM_ULP, (what, k, got, want)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("fn", [1, 5, 9])
@pytest.mark.parametrize("name", [a[0] for a in ALGOS])
def test_steps_match_jax_with_injected_draws(name, fn):
    jwf, wf, jalgo, algo, draws = _workflows(name, fn, seed=fn)
    js = jeval(jwf.init_step, jwf.init(jax.random.key(fn)))
    ts = wf.init_step(state_from_numpy(to_numpy(jwf.init(jax.random.key(fn))), device="cpu"))
    _check_state(ts, js, f"{name} f{fn} init_step")
    for gen in range(GENS):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = draws(js.algorithm, jalgo)
        ts = wf.step(ts)
        js = jeval(jwf.step, js)
        _check_state(ts, js, f"{name} f{fn} generation {gen + 1}")


@pytest.mark.parametrize("name", ["DE-rand-1", "JaDE", "SaDE"])
def test_whole_slice_with_the_ports_cec2022(name):
    """The port's DE on the port's CEC2022 f5 against JAX's on JAX's (run
    one operation at a time): fitness within the CEC2022 float32 tolerance;
    a row may take the other side of a selection only where its trial's
    and its parent's fitness lie within that tolerance of each other;
    every other row's population is equal bit for bit."""
    jwf, _, jalgo, algo, draws = _workflows(name, 5, seed=0)
    wf = StdWorkflow(algo, CEC2022(5, D, device="cpu"))
    js = jeval(jwf.init_step, jwf.init(jax.random.key(3)))
    for _ in range(GENS):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = draws(js.algorithm, jalgo)
        ts = wf.step(ts).algorithm
        before = np.asarray(js.algorithm.fit)
        js = jeval(jwf.step, js)
        tfit, jfit = ts.fit.numpy(), np.asarray(js.algorithm.fit)
        np.testing.assert_allclose(tfit, jfit, rtol=F32_RTOL)
        tmoved = ~np.all(ts.pop.numpy() == np.asarray(to_numpy(js)["algorithm"]["pop"]), axis=1)
        near = np.abs(jfit - before) <= F32_RTOL * np.abs(before)
        assert not np.any(tmoved & ~near), "a selection differs where the fitness is not a near tie"


@pytest.mark.parametrize("name", [a[0] for a in ALGOS])
def test_run_equals_eager_steps_on_the_cpu(name):
    _, cls, kw, _ = next(a for a in ALGOS if a[0] == name)
    algo = getattr(algorithms, cls)(N, torch.full((D,), -100.0), torch.full((D,), 100.0), device="cpu", **kw)
    wf = StdWorkflow(algo, CEC2022(5, D, device="cpu"))
    s0 = wf.init_step(wf.init(7))
    s = s0
    for _ in range(20):
        s = wf.step(s)
    fused = wf.run(s0, 20, init=False)
    for k in s.algorithm:
        torch.testing.assert_close(fused.algorithm[k], s.algorithm[k], rtol=0, atol=0, equal_nan=True)
    assert float(s.algorithm.fit.min()) < float(s0.algorithm.fit.min())
    assert bool(torch.isfinite(s.algorithm.pop).all())
    assert float(s.algorithm.pop.min()) >= -100.0 and float(s.algorithm.pop.max()) <= 100.0


def test_setup_layout_matches_jax():
    for name, cls, kw, _ in ALGOS:
        jwf, wf, *_ = _workflows(name, 1, seed=0)
        js, ts = jwf.init(jax.random.key(0)).algorithm, wf.init(0).algorithm
        assert set(ts) == set(js), name
        for k in js:
            if k != "key":
                assert tuple(ts[k].shape) == js[k].shape, (name, k)
                assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), (name, k)


def test_normal_initialisation_and_refusals():
    lb, ub = torch.full((D,), -100.0), torch.full((D,), 100.0)
    algo = algorithms.DE(N, lb, ub, mean=torch.full((D,), 90.0), stdev=torch.full((D,), 20.0), device="cpu")
    pop = algo.setup(rng.key(0)).pop
    assert float(pop.max()) == 100.0 and 85.0 < float(pop.mean()) < 95.0
    for kw in (dict(pop_size=3), dict(cross_probability=0.0), dict(num_difference_vectors=0),
               dict(base_vector="worst"), dict(num_difference_vectors=2, differential_weight=0.5)):
        args = dict(pop_size=N, lb=lb, ub=ub, device="cpu")
        args.update(kw)
        with pytest.raises(ValueError):
            algorithms.DE(**args)
    for cls in (algorithms.SHADE, algorithms.SaDE, algorithms.CoDE):
        with pytest.raises(ValueError):
            cls(8, lb, ub, device="cpu")
    with pytest.raises(ValueError):
        algorithms.JaDE(3, lb, ub, device="cpu")
    assert algorithms.ODE.max_evaluations_per_step == 2
