"""The port's NSGA-II through ``StdWorkflow`` and the multi-objective
``EvalMonitor`` against the JAX package's, on the CPU.

Each generation starts both frameworks from the same state: the JAX state
is carried across with ``state_from_numpy``, and the port's NSGA-II is
handed JAX's mating pool and raw SBX/mutation draws through its ``_draws``
seam.  The population and fitness are compared at rtol 1e-5 (float32
``pow``/``sin``/``cos`` may differ in the last bits), ranks exactly.  The
Pareto front of a monitor's history is compared with JAX's as a sorted set
of rows, exactly."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import evox_tpu.core as jcore  # noqa: E402
from evox_tpu.algorithms import NSGA2 as JNSGA2  # noqa: E402
from evox_tpu.operators.selection import tournament_selection_multifit as jtour  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import NSGA2  # noqa: E402
from evox_tpu_torch.metrics import igd  # noqa: E402
from evox_tpu_torch.ops import crowding, dominance, topk  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

N, D, M = 40, 12, 3


def t(a):
    return torch.from_numpy(np.array(a))


class InjectedNSGA2(NSGA2):
    """NSGA-II whose generation uses choices supplied from outside."""

    next_draws = None

    def _draws(self, state):
        return state, self.next_draws


def to_numpy(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, jcore.State):
            out[k] = to_numpy(v)
        elif jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key):
            out[k] = np.asarray(jax.random.key_data(v))
        else:
            out[k] = np.asarray(v)
    return out


def jax_draws(algo_state, pop_size):
    """The mating pool and raw draws JAX's ``NSGA2.step`` makes from this
    state's key."""
    _, sel_key, x_key, mut_key = jax.random.split(algo_state.key, 4)
    pool = jtour(sel_key, pop_size, [-algo_state.dis, algo_state.rank.astype(algo_state.dis.dtype)])
    shape = (pop_size // 2, algo_state.pop.shape[1])
    mu_key, dir_key, p1_key, p2_key = jax.random.split(x_key, 4)
    sbx = (
        t(jax.random.uniform(mu_key, shape)),
        t(jax.random.randint(dir_key, shape, 0, 2)),
        t(jax.random.uniform(p1_key, shape)),
        t(jax.random.uniform(p2_key, shape)),
    )
    site_key, pm_key = jax.random.split(mut_key)
    full = (2 * (pop_size // 2), algo_state.pop.shape[1])
    pm = (t(jax.random.uniform(site_key, full)), t(jax.random.uniform(pm_key, full)))
    return t(pool).to(torch.int64), sbx, pm


def _workflows(pop=N):
    jwf = JWorkflow(JNSGA2(pop, M, jnp.zeros(D), jnp.ones(D)), JDTLZ2(d=D, m=M))
    algo = InjectedNSGA2(pop, M, torch.zeros(D), torch.ones(D), device="cpu")
    wf = StdWorkflow(algo, DTLZ2(d=D, m=M, device="cpu"))
    return jwf, wf, algo


def test_setup_layout_matches_jax():
    jwf, wf, _ = _workflows()
    js, ts = jwf.init(jax.random.key(0)).algorithm, wf.init(0).algorithm
    assert set(ts) == set(js)
    for k in ("pop", "fit", "rank", "dis"):
        assert tuple(ts[k].shape) == js[k].shape, k
        assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), k
    assert float(ts.pop.min()) >= 0.0 and float(ts.pop.max()) < 1.0


def test_init_step_matches_jax():
    jwf, wf, _ = _workflows()
    js = jwf.init_step(jwf.init(jax.random.key(1)))
    ts = state_from_numpy(to_numpy(jwf.init(jax.random.key(1))), device="cpu")
    ts = wf.init_step(ts)
    np.testing.assert_allclose(ts.algorithm.fit.numpy(), np.asarray(js.algorithm.fit), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ts.algorithm.rank.numpy(), np.asarray(js.algorithm.rank))
    np.testing.assert_allclose(ts.algorithm.dis.numpy(), np.asarray(js.algorithm.dis), rtol=1e-5)


@pytest.mark.parametrize("pop", [N, 64])
def test_steps_match_jax_with_injected_draws(pop):
    jwf, wf, algo = _workflows(pop)
    jstep = jax.jit(jwf.step)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(pop)))
    for _ in range(5):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = jax_draws(js.algorithm, pop)
        ts = wf.step(ts)
        js = jstep(js)
        for k in ("pop", "fit", "dis"):
            np.testing.assert_allclose(
                ts.algorithm[k].numpy(), np.asarray(js.algorithm[k]), rtol=1e-5, atol=1e-6, err_msg=k
            )
        np.testing.assert_array_equal(ts.algorithm.rank.numpy(), np.asarray(js.algorithm.rank))


def _row_set(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


def test_pf_fitness_matches_jax_over_the_same_history():
    r = np.random.default_rng(0)
    fits = [(np.round(r.uniform(0, 1, (30, 3)) * 8) / 8).astype(np.float32) for _ in range(4)]
    fits[1][:5] = fits[0][:5]  # duplicates across generations
    sols = [r.uniform(0, 1, (30, 4)).astype(np.float32) for _ in range(4)]
    sols[2][:3] = sols[0][:3]
    tmon = EvalMonitor(multi_obj=True, full_sol_history=True).set_config(device="cpu")
    jmon = JEvalMonitor(multi_obj=True, full_sol_history=True)
    ts, js = tmon.setup(None), jmon.setup(jax.random.key(0))
    for f, x in zip(fits, sols):
        ts = tmon.pre_tell(tmon.post_ask(ts, t(x)), t(f))
        js = jmon.pre_tell(jmon.post_ask(js, jnp.asarray(x)), jnp.asarray(f))
    np.testing.assert_array_equal(_row_set(tmon.get_pf_fitness()), _row_set(jmon.get_pf_fitness()))
    np.testing.assert_array_equal(
        _row_set(tmon.get_pf_fitness(deduplicate=False)), _row_set(jmon.get_pf_fitness(deduplicate=False))
    )
    tsol, tfit = tmon.get_pf()
    jsol, jfit = jmon.get_pf()
    np.testing.assert_array_equal(tsol.numpy(), np.asarray(jsol))
    np.testing.assert_array_equal(tfit.numpy(), np.asarray(jfit))
    np.testing.assert_array_equal(tmon.get_pf_solutions().numpy(), np.asarray(jmon.get_pf_solutions()))
    assert int(ts.generation) == 4 and ts.latest_fitness.shape == (30, 3)


def test_monitor_refusals():
    mon = EvalMonitor(multi_obj=True).set_config(device="cpu")
    s = mon.setup(None)
    with pytest.raises(ValueError, match="single best"):
        mon.get_best_fitness(s)
    with pytest.raises(ValueError):
        mon.pre_tell(s, torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="multi-objective"):
        EvalMonitor().get_pf_fitness()


def test_example_run_improves_igd_and_keeps_a_front():
    """examples/03_multiobjective.py through the port with its own draws:
    IGD falls from generation 10 to 30 and the pooled front is non-empty."""
    problem = DTLZ2(d=D, m=M, device="cpu")
    mon = EvalMonitor(multi_obj=True)
    wf = StdWorkflow(NSGA2(128, M, torch.zeros(D), torch.ones(D), device="cpu"), problem, monitor=mon)
    pf = problem.pf()
    launches = (dominance.dominance_packed.launches, topk.lex_rank.launches,
                crowding.crowding_neighbors.launches)
    state = wf.init_step(wf.init(0))
    igds = {}
    for gen in range(30):
        state = wf.step(state)
        if (gen + 1) % 10 == 0:
            igds[gen + 1] = float(igd(mon.get_latest_fitness(state.monitor), pf))
    assert igds[30] < igds[10]
    front = mon.get_pf_fitness()
    assert front.shape[0] > 0 and front.shape[1] == M
    algo = state.algorithm
    assert bool(torch.isfinite(algo.pop).all()) and float(algo.pop.min()) >= 0.0 and float(algo.pop.max()) <= 1.0
    assert int(algo.rank.min()) >= 0
    # On the CPU no kernel launches.
    assert launches == (dominance.dominance_packed.launches, topk.lex_rank.launches,
                        crowding.crowding_neighbors.launches)
