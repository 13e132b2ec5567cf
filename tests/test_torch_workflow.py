"""The port's StdWorkflow and EvalMonitor (``evox_tpu_torch.workflows``)
against the JAX package's, on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import Algorithm, Problem, State  # noqa: E402
from evox_tpu_torch.precision import PrecisionPolicy  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley, Sphere  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _no_process_group_left():
    """Tests here may set up a one-rank gloo group (``make_pop_mesh``):
    destroy it with the module, so no later test file in this process finds
    one."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _pso(n=100, d=10, bound=32.0, **kw):
    return PSO(n, -bound * torch.ones(d), bound * torch.ones(d), device="cpu", **kw)


def test_quickstart_improves_more_than_tenfold():
    mon = EvalMonitor(topk=3)
    wf = StdWorkflow(_pso(), Ackley(), monitor=mon)
    state = wf.init_step(wf.init(42))
    best0 = float(mon.get_best_fitness(state.monitor))
    for _ in range(50):
        state = wf.step(state)
    best = float(mon.get_best_fitness(state.monitor))
    assert best * 10 < best0
    top = mon.get_topk_fitness(state.monitor)
    assert top.shape == (3,) and bool((top[:-1] <= top[1:]).all())
    assert mon.get_topk_solutions(state.monitor).shape == (3, 10)
    assert float(Ackley().evaluate(None, mon.get_best_solution(state.monitor)[None])[0][0]) == pytest.approx(best, rel=1e-6)
    hist = mon.get_fitness_history()
    assert len(hist) == 51 and all(h.device.type == "cpu" and h.shape == (100,) for h in hist)
    assert int(state.monitor.generation) == 51
    assert mon.get_latest_fitness(state.monitor).shape == (100,)


def test_topk_and_tie_order_match_jax():
    """Ties must resolve to the lower candidate index, as ``jax.lax.top_k``
    does: previous elites first, then the population in order."""
    fits = [
        [3.0, 1.0, 1.0, 2.0, 5.0, 1.0],
        [1.0, 0.5, 1.0, 3.0, 1.0, 0.5],
        [0.5, 7.0, 0.5, 0.5, 9.0, 0.25],
    ]
    k = 3
    tmon = EvalMonitor(topk=k, full_fit_history=False)
    tmon.set_config(device="cpu")
    jmon = JEvalMonitor(topk=k, full_fit_history=False)
    ts, js = tmon.setup(None), jmon.setup(jax.random.key(0))
    for g, fit in enumerate(fits):
        sol = np.arange(len(fit) * 2, dtype=np.float32).reshape(len(fit), 2) + 100 * g
        ts = tmon.pre_tell(tmon.post_ask(ts, torch.from_numpy(sol)), torch.tensor(fit))
        js = jmon.pre_tell(jmon.post_ask(js, jnp.asarray(sol)), jnp.asarray(fit, jnp.float32))
        np.testing.assert_array_equal(ts.topk_fitness.numpy(), np.asarray(js.topk_fitness))
        np.testing.assert_array_equal(ts.topk_solutions.numpy(), np.asarray(js.topk_solutions))
    assert int(ts.generation) == int(js.generation) == 3


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("fits", [
    [[0.0, -0.0, 1.0, -0.0], [-0.0, 0.0, -0.0, 2.0]],
    [[1.0, 2.0, -float("nan"), 3.0], [float("nan"), -float("nan"), 0.5, -float("inf")]],
], ids=["signed_zeros", "negative_nan"])
def test_topk_orders_signed_zeros_and_nan_as_jax(fits, dtype):
    """The top-k ranks by IEEE total order, as ``jax.lax.top_k(-f)``: -0
    before +0, a negative NaN before everything and a positive NaN after
    everything, ties to the lower index; carried over a second generation
    (the quarantine is off, so the NaN reach the monitor)."""
    k = 2
    tmon = EvalMonitor(topk=k, full_fit_history=False).set_config(device="cpu")
    jmon = JEvalMonitor(topk=k, full_fit_history=False)
    ts, js = tmon.setup(None), jmon.setup(jax.random.key(0))
    for g, fit in enumerate(fits):
        fit = np.asarray(fit, dtype=dtype)
        sol = np.arange(8, dtype=np.float32).reshape(4, 2) + 10 * g
        ts = tmon.pre_tell(tmon.post_ask(ts, torch.from_numpy(sol)), torch.from_numpy(fit))
        js = jmon.pre_tell(jmon.post_ask(js, jnp.asarray(sol)), jnp.asarray(fit))
        bits = np.int16 if dtype == "float16" else np.int32
        np.testing.assert_array_equal(ts.topk_fitness.numpy().view(bits), np.asarray(js.topk_fitness).view(bits))
        np.testing.assert_array_equal(ts.topk_solutions.numpy(), np.asarray(js.topk_solutions))


def test_topk_of_signed_zeros_and_nan_through_the_workflow():
    """The same two generations through StdWorkflow with
    quarantine_nonfinite=False: the tracked elites equal JAX's."""

    class Replay(Problem):
        def __init__(self, fits):
            self.fits = fits

        def setup(self, key):
            return State(i=torch.zeros((), dtype=torch.int64))

        def evaluate(self, state, pop):
            return self.fits[state.i], state.replace(i=state.i + 1)

    class Fixed(Algorithm):
        device = torch.device("cpu")

        def setup(self, key):
            return State(pop=torch.arange(8, dtype=torch.float32).reshape(4, 2))

        def step(self, state, evaluate):
            evaluate(state.pop)
            return state

    nan = float("nan")
    fits = torch.tensor([[1.0, 2.0, -nan, 3.0], [0.0, -0.0, -nan, 0.5], [-0.0, 1.0, nan, -0.0]])
    mon = EvalMonitor(topk=2, full_fit_history=False)
    wf = StdWorkflow(Fixed(), Replay(fits), monitor=mon, quarantine_nonfinite=False)
    state = wf.init(0)
    jmon = JEvalMonitor(topk=2, full_fit_history=False)
    js = jmon.setup(jax.random.key(0))
    for g in range(3):
        state = wf.step(state)
        js = jmon.pre_tell(jmon.post_ask(js, jnp.arange(8, dtype=jnp.float32).reshape(4, 2)),
                           jnp.asarray(fits[g].numpy()))
        np.testing.assert_array_equal(state.monitor.topk_fitness.numpy().view(np.int32),
                                      np.asarray(js.topk_fitness).view(np.int32))


@pytest.mark.parametrize("direction", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
def test_quarantine_matches_jax(direction, dtype):
    if dtype == "int32":
        fit = np.array([3, -1, 7, 0], np.int32)
    else:
        fit = np.array([1.5, np.nan, -np.inf, 2.0, np.inf, -3.0], dtype)
    jwf = JWorkflow(
        JPSO(8, -jnp.ones(2), jnp.ones(2)), JSphere(), monitor=JEvalMonitor(),
        opt_direction=direction,
    )
    twf = StdWorkflow(_pso(8, 2, 1.0), Sphere(), monitor=EvalMonitor(), opt_direction=direction)
    jfit, jmon = jwf._quarantine(jnp.asarray(fit), jwf.monitor.setup(jax.random.key(0)))
    tfit, tmon = twf._quarantine(torch.from_numpy(fit), twf.monitor.setup(None))
    assert str(tfit.dtype).split(".")[-1] == dtype
    np.testing.assert_array_equal(tfit.numpy(), np.asarray(jfit))
    assert int(tmon.num_nonfinite) == int(jmon.num_nonfinite)
    if dtype == "float16":  # the penalty is clamped to the dtype's range
        assert np.isfinite(tfit.numpy()).all()
    off = StdWorkflow(_pso(8, 2, 1.0), Sphere(), quarantine_nonfinite=False)
    out, _ = off._quarantine(torch.from_numpy(fit), State())
    np.testing.assert_array_equal(out.numpy(), fit)


class NegSphere(Problem):
    def evaluate(self, state, pop):
        return -(pop**2).sum(dim=1), state


def test_opt_direction_max():
    mon = EvalMonitor()
    wf = StdWorkflow(_pso(50, 5, 5.0), NegSphere(), monitor=mon, opt_direction="max")
    state = wf.init_step(wf.init(1))
    best0 = float(mon.get_best_fitness(state.monitor))
    state = wf.run(state, 30, init=False)
    best = float(mon.get_best_fitness(state.monitor))
    assert best0 < best <= 0.0  # maximizing, original sign restored
    assert float(state.monitor.topk_fitness[0]) == -best  # minimizing frame inside
    assert all(bool((h <= 0).all()) for h in mon.get_fitness_history())
    with pytest.raises(ValueError):
        StdWorkflow(_pso(), Sphere(), opt_direction="up")


class _Calls(Algorithm):
    def __init__(self, calls, limit=None):
        self.calls = calls
        if limit is not None:
            self.max_evaluations_per_step = limit

    def step(self, state, evaluate):
        for _ in range(self.calls):
            evaluate(torch.zeros(4, 2))
        return state


def test_evaluation_count_contract():
    with pytest.raises(RuntimeError, match="never called"):
        StdWorkflow(_Calls(0), Sphere()).step(State(algorithm=State(), problem=State(), monitor=State()))
    wf = StdWorkflow(_Calls(2), Sphere())
    with pytest.raises(RuntimeError, match="more than its declared limit of 1"):
        wf.step(wf.init(0))
    wf = StdWorkflow(_Calls(2, limit=2), Sphere())
    wf.step(wf.init(0))


@pytest.mark.parametrize(
    "kwargs",
    [
        {"enable_distributed": True},
        {"mesh": object()},
        {"quarantine_granularity": "shard"},
        {"key_impl": "nope"},
        {"precision": PrecisionPolicy()},
    ],
)
def test_unported_options_raise(kwargs):
    algo = _pso()
    error, match = NotImplementedError, "not yet ported"
    # The precision plane is ported: it refuses what the JAX package
    # refuses, an unknown key impl and a policy on an algorithm that
    # declares no storage leaves.
    if "key_impl" in kwargs:
        error, match = ValueError, "unknown PRNG key impl"
    if "precision" in kwargs:
        algo.storage_leaves = None
        error, match = TypeError, "declares no `storage_leaves`"
    # Distributed evaluation is ported: enable_distributed builds a sharded
    # workflow (a one-rank mesh here), a mesh without it is not stored, and
    # shard-granular quarantine without a sharded evaluation is refused as
    # the JAX package refuses it.
    if "quarantine_granularity" in kwargs:
        error, match = ValueError, "needs a sharded evaluation"
    if "enable_distributed" in kwargs or "mesh" in kwargs:
        wf = StdWorkflow(algo, Sphere(), **kwargs)
        assert (wf.mesh is not None) == bool(kwargs.get("enable_distributed"))
        return
    with pytest.raises(error, match=match):
        StdWorkflow(algo, Sphere(), **kwargs)


def test_unported_monitor_modes_raise():
    # The multi-objective mode is ported; what it does not have (a single
    # best, fitness of more than two dimensions) still raises.
    mon = EvalMonitor(multi_obj=True).set_config(device="cpu")
    with pytest.raises(ValueError, match="single best"):
        mon.get_best_solution(mon.setup(None))
    with pytest.raises(ValueError):
        mon.pre_tell(mon.setup(None), torch.zeros(4, 2, 2))
    with pytest.raises(ValueError, match="needs a sharded evaluation"):
        StdWorkflow(_pso(), Sphere(), quarantine_granularity="shard")
    with pytest.raises(ValueError):
        StdWorkflow(_pso(), Sphere(), quarantine_granularity="row")


def test_run_equals_manual_loop_and_transforms_apply():
    mon = EvalMonitor(full_sol_history=True)
    wf = StdWorkflow(
        _pso(20, 3, 2.0), Sphere(), monitor=mon,
        solution_transform=lambda x: x + 1.0, fitness_transform=lambda f: 2.0 * f,
    )
    a = wf.run(wf.init(9), 6)
    mon.clear_history()
    b = wf.init_step(wf.init(9))
    for _ in range(5):
        b = wf.step(b)
    for k in a.algorithm:
        assert torch.equal(a.algorithm[k], b.algorithm[k]), k
    sol, fit = mon.solution_history[-1], mon.fitness_history[-1]
    assert len(mon.solution_history) == 6
    # The monitor sees pre-transform solutions and transformed fitness.
    torch.testing.assert_close(fit, 2.0 * ((sol + 1.0) ** 2).sum(dim=1))


# ---------------------------------------------------------------------------
# The monitor's auxiliary history (full_pop_history, record_auxiliary)
# ---------------------------------------------------------------------------


def _es_pair(full_pop_history=True, **mon_kw):
    from evox_tpu.algorithms import OpenES as JOpenES
    from evox_tpu_torch.algorithms import OpenES
    from test_torch_rvea import Injected

    center = np.ones(6, np.float32)
    jalgo = JOpenES(16, jnp.asarray(center), 0.05, 0.1, optimizer="adam")
    algo = type("InjectedOpenES", (Injected, OpenES), {})(16, torch.from_numpy(center), 0.05, 0.1,
                                                            optimizer="adam", device="cpu")
    jmon = JEvalMonitor(full_pop_history=full_pop_history, **mon_kw)
    mon = EvalMonitor(full_pop_history=full_pop_history, **mon_kw)
    return JWorkflow(jalgo, JSphere(), monitor=jmon), StdWorkflow(algo, Sphere(), monitor=mon), algo


def test_auxiliary_history_matches_jax():
    """OpenES's ``record_step`` (its center) recorded every generation with
    ``full_pop_history=True``: the same keys, one entry a generation, and
    the values of JAX's run (JAX's draws injected, its state carried
    across each generation; the center moves by a product over the
    population: within 1e-5 of its magnitude, as in
    tests/test_torch_es.py)."""
    from evox_tpu_torch.utils.convert import state_from_numpy
    from test_torch_nsga2 import to_numpy

    jwf, wf, algo = _es_pair()
    js = jwf.init_step(jwf.init(jax.random.key(2)))
    ts = wf.init_step(state_from_numpy(to_numpy(jwf.init(jax.random.key(2))), device="cpu"))
    for _ in range(4):
        _, noise_key = jax.random.split(js.algorithm.key)
        algo.next_draws = [torch.from_numpy(np.asarray(jax.random.normal(noise_key, (8, 6))))]
        ts = wf.step(state_from_numpy(to_numpy(js), device="cpu"))
        js = jwf.step(js)
    jaux, aux = jwf.monitor.auxiliary_history, wf.monitor.aux_history
    assert list(aux) == list(jaux) == ["center"] == wf.monitor.aux_keys
    assert len(aux["center"]) == len(jaux["center"]) == 5
    # The init step ran each side's own draws: the four carried steps are
    # compared.
    for got, want in zip(aux["center"][1:], jaux["center"][1:]):
        assert got.device.type == "cpu" and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert len(wf.monitor.fitness_history) == len(jwf.monitor.fitness_history) == 5


def test_auxiliary_history_is_off_by_default_and_record_history_appends():
    jwf, wf, _ = _es_pair(full_pop_history=False, full_sol_history=True)
    ts = wf.step(wf.init_step(wf.init(0)))
    js = jwf.step(jwf.init_step(jwf.init(jax.random.key(0))))
    assert wf.monitor.aux_history == {} == jwf.monitor.auxiliary_history
    assert wf.monitor.aux_keys == [] == jwf.monitor.aux_keys
    ts = ts.replace(monitor=wf.monitor.record_history(ts.monitor))
    jwf.monitor.record_history(js.monitor)
    for mon in (wf.monitor, jwf.monitor):
        assert len(mon.fitness_history) == len(mon.solution_history) == 3
    torch.testing.assert_close(wf.monitor.fitness_history[-1], wf.monitor.fitness_history[-2], rtol=0, atol=0)
    torch.testing.assert_close(wf.monitor.solution_history[-1], ts.monitor.latest_solution, rtol=0, atol=0)


def test_auxiliary_history_through_a_fused_segment():
    """``run_segment`` and ``run`` hand the auxiliary records to the
    workflow (``_sink(..., slot=)``), and the boundary flush appends them
    key by key, generation by generation, as stepping records them; the
    fitness history keeps its own order beside them."""
    _, wf, _ = _es_pair()
    mon = wf.monitor
    s0 = wf.step(wf.init_step(wf.init(4)))
    n0 = len(mon.aux_history["center"])
    s = s0
    for _ in range(7):
        s = wf.step(s)
    seg, tel = wf.run_segment(s0, 7)
    assert StdWorkflow.sink_meta_pairs(tel) == [(0, 0), (2, 0)]
    wf.flush_telemetry(tel)
    wf.run(s0, 7, init=False)
    aux, fit = mon.aux_history["center"], mon.fitness_history
    assert len(aux) == n0 + 21 and len(fit) == n0 + 21
    for block in (1, 2):
        for g in range(7):
            for hist in (aux, fit):
                torch.testing.assert_close(hist[n0 + 7 * block + g], hist[n0 + g], rtol=0, atol=0)
    torch.testing.assert_close(aux[-1], s.algorithm.center, rtol=0, atol=0)
