"""The port's RVEA and RVEAa (``evox_tpu_torch.algorithms.mo.rvea`` /
``rveaa``), their selection (``operators.selection.rvea_selection``) and the
device-bounded draws they need (``utils.rng.randint_below``,
``rng.permutation``) against the JAX package's, on the CPU.

Each generation starts both frameworks from the same state (the JAX state
carried across with ``state_from_numpy``) and the port is handed JAX's
draws through its ``_draws`` seam.  Tolerances: survivors, NaN places,
indices and generation counters exactly; the population, fitness and
reference vectors at rtol 1e-5 (float32 ``pow``/``sin``/``cos``/``arccos``
may differ in the last bits); ``apd_fn`` at rtol 1e-6."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.algorithms import RVEA as JRVEA  # noqa: E402
from evox_tpu.algorithms import RVEAa as JRVEAa  # noqa: E402
from evox_tpu.algorithms.mo.rvea import _valid_mating_pool as j_mating_pool  # noqa: E402
from evox_tpu.operators.selection import rvea_selection as jsel  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import RVEA, RVEAa  # noqa: E402
from evox_tpu_torch.algorithms.mo.rvea import _valid_mating_pool  # noqa: E402
from evox_tpu_torch.operators.selection import rvea_selection as sel  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402

D, M = 10, 3
PARAMS = ("algorithm.alpha", "algorithm.fr", "algorithm.max_gen")


def sbx_pm_draws(x_key, mut_key, pairs, rows, d):
    """The raw draws JAX's SBX (``pairs`` x d) and polynomial mutation
    (``rows`` x d) make from their keys."""
    shape = (pairs, d)
    mu_key, dir_key, p1_key, p2_key = jax.random.split(x_key, 4)
    sbx = (
        t(jax.random.uniform(mu_key, shape)),
        t(jax.random.randint(dir_key, shape, 0, 2)),
        t(jax.random.uniform(p1_key, shape)),
        t(jax.random.uniform(p2_key, shape)),
    )
    site_key, pm_key = jax.random.split(mut_key)
    pm = (t(jax.random.uniform(site_key, (rows, d))), t(jax.random.uniform(pm_key, (rows, d))))
    return sbx, pm


def jax_mating(key, pop, n):
    """The indices into the valid rows that JAX's ``_valid_mating_pool``
    draws from ``key``."""
    num_valid = jnp.sum(~jnp.isnan(pop).all(axis=1), dtype=jnp.int32)
    return t(jax.random.randint(key, (n,), 0, jnp.maximum(num_valid, 1))).to(torch.int64)


def rvea_draws(js, pop_size, keys=4):
    """JAX's mating pool indices, SBX and PM draws (and, for RVEAa, the
    regeneration uniforms) of one generation from this state's key."""
    split = jax.random.split(js.key, keys)
    mating = jax_mating(split[1], js.pop, pop_size)
    sbx, pm = sbx_pm_draws(split[2], split[3], pop_size // 2, 2 * (pop_size // 2), js.pop.shape[1])
    if keys == 4:
        return mating, sbx, pm
    v = js.reference_vector[pop_size:]
    return mating, sbx, pm, t(jax.random.uniform(split[4], v.shape, dtype=v.dtype))


class Injected:
    """Mixin: a generation uses choices supplied from outside."""

    next_draws = None

    def _draws(self, state):
        return state, self.next_draws


class InjectedRVEA(Injected, RVEA):
    pass


class InjectedRVEAa(Injected, RVEAa):
    pass


def _close(got, want, what, rtol=1e-5):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN places")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6, err_msg=what)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def _selection_inputs(n, nv, d, seed):
    r = np.random.default_rng(seed)
    f = r.uniform(0.0, 2.0, (n, M)).astype(np.float32)
    x = r.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    f[3] = np.nan
    f[7, 1] = np.nan
    f[11] = np.inf
    f[13, 2] = -np.inf
    f[20] = f[21]  # duplicate rows: the lower row survives
    x[20] = x[21] + 1.0
    f[30:33] = f[40]  # three copies of one row
    v = r.uniform(0.0, 1.0, (nv, M)).astype(np.float32)
    v[-1] = [0.0, 0.0, 1e-7]  # a vector no solution leans to: a NaN row
    return x, f, v


@pytest.mark.parametrize("n,nv,seed", [(60, 15, 0), (200, 91, 1), (41, 40, 2)])
def test_ref_vec_guided_matches_jax(n, nv, seed):
    x, f, v = _selection_inputs(n, nv, 4, seed)
    theta = np.float32(0.37)
    jx, jf = jsel.ref_vec_guided(jnp.asarray(x), jnp.asarray(f), jnp.asarray(v), jnp.asarray(theta))
    tx, tf = sel.ref_vec_guided(t(x), t(f), t(v), torch.tensor(theta))
    assert tx.shape == (nv, 4) and tf.shape == (nv, M)
    # Survivors are rows of the inputs: equal bits, NaN rows at the same
    # places.
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.isnan(tf.numpy()).all(axis=1).any()


def test_ref_vec_guided_all_rows_nan():
    x = np.full((10, 3), np.nan, np.float32)
    f = np.full((10, M), np.nan, np.float32)
    v = np.eye(M, dtype=np.float32)
    tx, tf = sel.ref_vec_guided(t(x), t(f), t(v), torch.tensor(0.5))
    jx, jf = jsel.ref_vec_guided(jnp.asarray(x), jnp.asarray(f), jnp.asarray(v), jnp.asarray(0.5))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.isnan(tx.numpy()).all()


def test_apd_fn_matches_jax():
    r = np.random.default_rng(5)
    n, nv = 30, 8
    partition = r.integers(-1, n, (n, nv)).astype(np.int32)
    gamma = r.uniform(0.1, 1.0, nv).astype(np.float32)
    angle = r.uniform(0.0, 1.5, (n, nv)).astype(np.float32)
    obj = r.uniform(0.0, 2.0, (n, M)).astype(np.float32)
    got = sel.apd_fn(t(partition).to(torch.int64), t(gamma), t(angle), t(obj), torch.tensor(0.4))
    want = jsel.apd_fn(jnp.asarray(partition), jnp.asarray(gamma), jnp.asarray(angle), jnp.asarray(obj), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("valid", [0, 1, 17, 40])
def test_valid_mating_pool_with_injected_indices(valid):
    r = np.random.default_rng(valid)
    pop = r.uniform(0, 1, (40, D)).astype(np.float32)
    empty = r.permutation(40)[: 40 - valid]
    pop[empty] = np.nan
    key = jax.random.key(valid)
    want = j_mating_pool(key, jnp.asarray(pop), 25)
    got = _valid_mating_pool(None, t(pop), 25, jax_mating(key, jnp.asarray(pop), 25))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The port's own draw stays among the valid rows.
    own = _valid_mating_pool(rng.key(valid), t(pop), 25)
    if valid:
        assert not torch.isnan(own).any()
        assert {tuple(r) for r in own.tolist()} <= {tuple(r) for r in t(pop).tolist()}


# ---------------------------------------------------------------------------
# Device-bounded draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("span", [1, 2, 7, 1000, 2**31])
def test_randint_below_is_the_multiply_shift_of_31_bit_words(span):
    seed = rng.child(rng.key(3))
    got = rng.randint_below(seed, (5000,), torch.tensor(span), "cpu")
    words = rng.philox_words(seed, 5000, "cpu")[0] >> 1
    assert torch.equal(got, (words * span) >> 31)
    assert int(got.min()) >= 0 and int(got.max()) < span
    if span == 7:
        counts = torch.bincount(got, minlength=7).double()
        assert float(counts.min()) > 5000 / 7 * 0.85


@pytest.mark.parametrize("shape", [1, 17, 1000, (30, 12)])
def test_permutation_is_a_stable_argsort_of_one_draw(shape):
    seed = rng.child(rng.key(9))
    perm = rng.permutation(seed, shape, "cpu")
    shape = (shape,) if isinstance(shape, int) else shape
    assert perm.shape == shape and perm.dtype == torch.int64
    assert torch.equal(torch.sort(perm, dim=-1).values, torch.arange(shape[-1]).expand(shape))
    words = (rng.philox_words(seed, perm.numel(), "cpu")[0] >> 1).reshape(shape)
    assert torch.equal(perm, torch.argsort(words, dim=-1, stable=True))
    assert torch.equal(perm, rng.permutation(seed, shape, "cpu"))


# ---------------------------------------------------------------------------
# RVEA and RVEAa steps against JAX
# ---------------------------------------------------------------------------


def _workflows(jcls, cls, pop, **kw):
    jwf = JWorkflow(jcls(pop, M, jnp.zeros(D), jnp.ones(D), **kw), JDTLZ2(d=D, m=M))
    algo = cls(pop, M, torch.zeros(D), torch.ones(D), device="cpu", **kw)
    return jwf, StdWorkflow(algo, DTLZ2(d=D, m=M, device="cpu")), algo


def _check_algorithm(ts, js):
    for k in ("pop", "fit", "reference_vector"):
        _close(ts.algorithm[k], js.algorithm[k], k)
    assert int(ts.algorithm.gen) == int(js.algorithm.gen)


def test_rvea_setup_layout_matches_jax():
    jwf, wf, _ = _workflows(JRVEA, RVEA, 30)
    js, ts = jwf.init(jax.random.key(0)).algorithm, wf.init(0).algorithm
    assert list(ts) == list(js)
    assert ts.param_keys == {"alpha", "fr", "max_gen"}
    for k in ts:
        if k != "key":
            assert tuple(ts[k].shape) == js[k].shape, k
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), k
    np.testing.assert_array_equal(ts.reference_vector.numpy(), np.asarray(js.reference_vector))


@pytest.mark.parametrize("pop,fr", [(30, 0.5), (91, 0.1)])
def test_rvea_steps_match_jax_with_injected_draws(pop, fr):
    """Generations 1-6: with fr=0.5 the vectors adapt every second one."""
    jwf, wf, algo = _workflows(JRVEA, InjectedRVEA, pop, fr=fr, max_gen=8)
    jstep = jax.jit(jwf.step)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(pop)))
    for _ in range(6):
        ts = state_from_numpy(to_numpy(js), device="cpu", params=PARAMS)
        algo.next_draws = rvea_draws(js.algorithm, algo.pop_size)
        ts = wf.step(ts)
        js = jstep(js)
        _check_algorithm(ts, js)


def test_rveaa_steps_match_jax_through_the_final_truncation():
    """fr=0.5: adaptation every second generation; max_gen=4: the fourth
    generation truncates the most crowded half."""
    jwf, wf, algo = _workflows(JRVEAa, InjectedRVEAa, 28, fr=0.5, max_gen=4)
    jstep = jax.jit(jwf.step)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(4)))
    for gen in range(1, 6):
        ts = state_from_numpy(to_numpy(js), device="cpu", params=PARAMS)
        algo.next_draws = rvea_draws(js.algorithm, algo.pop_size, keys=5)
        ts = wf.step(ts)
        js = jstep(js)
        _check_algorithm(ts, js)
        if gen == 4:
            assert np.isnan(ts.algorithm.fit.numpy()).all(axis=1).sum() >= algo.pop_size


@pytest.mark.parametrize("empty", [0, 5, 30])
def test_batch_truncation_matches_jax(empty):
    """``-nanmax`` over each row equals JAX's ``sort(-cosine)[:, 0]``,
    also for rows that are all NaN."""
    r = np.random.default_rng(empty)
    n = 40
    pop = r.uniform(0, 1, (n, D)).astype(np.float32)
    obj = r.uniform(0, 1, (n, M)).astype(np.float32)
    obj[5] = obj[6]  # two rows at angle 0
    rows = r.permutation(n)[:empty]
    pop[rows] = np.nan
    obj[rows] = np.nan
    jalgo = JRVEAa(20, M, jnp.zeros(D), jnp.ones(D))
    algo = RVEAa(20, M, torch.zeros(D), torch.ones(D), device="cpu")
    jp, jo = jalgo._batch_truncation(jnp.asarray(pop), jnp.asarray(obj))
    tp, to = algo._batch_truncation(t(pop), t(obj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_rv_regeneration_matches_jax():
    r = np.random.default_rng(1)
    fit = r.uniform(0, 2, (24, M)).astype(np.float32)
    fit[::4] = np.nan
    v = r.uniform(0, 1, (12, M)).astype(np.float32)
    key = jax.random.key(2)
    jalgo = JRVEAa(12, M, jnp.zeros(D), jnp.ones(D))
    algo = RVEAa(12, M, torch.zeros(D), torch.ones(D), device="cpu")
    want = jalgo._rv_regeneration(key, jnp.asarray(fit), jnp.asarray(v))
    u = t(jax.random.uniform(key, v.shape, dtype=jnp.float32))
    got = algo._rv_regeneration(None, t(fit), t(v), u)
    _close(got, want, "regenerated vectors")
    # Some vectors attract no solution and are regenerated.
    assert (got.numpy() != v).any(axis=1).any()
