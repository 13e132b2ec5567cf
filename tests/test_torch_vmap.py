"""Vectors and vmap in the port, on the CPU: ``utils/vmap_ops.py``
(operators with batching rules, host operators), ``ParamsAndVector``, the
rest of ``utils/ops.py``, the batched routes of the PSO move and the Philox
draws, and ``torch.func.vmap`` over workflow instances, against the JAX
package where it has a counterpart.

Vmapped instances equal solo runs from the same keys bit for bit wherever a
generation is elementwise, gathers or sorts.  Where it takes a matrix
product or a factorisation, the batched call sums in another order than
the solo one (a batched product, ``bmm``, against a matrix-vector one) and
the instances agree within ``BATCHED_RTOL`` of each leaf's scale
(``_scale``): the NES family's gradient ``noise.T @ fit``, CMA-ES's
covariance update and its eigendecomposition, RVEAa's products.  OpenES
sums its gradient in a fixed pairwise order, so it is held bit for bit.
"""

import random

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from evox_tpu.utils import ops as jops  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.ops import linalg, philox, pso_step  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2, Ackley, Sphere  # noqa: E402
from evox_tpu_torch.utils import ParamsAndVector, host_op, register_vmap_op, rng  # noqa: E402
from evox_tpu_torch.utils import ops as tops  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

# Leaves of a vmapped generation that takes a batched matrix product or
# factorisation, relative to the leaf's scale: the float32 roundings of a
# sum of a few dozen terms taken in another order, grown through a few
# generations (measured at most 2e-5).
BATCHED_RTOL = 1e-4
vmap = torch.func.vmap


# ---------------------------------------------------------------------------
# register_vmap_op and host_op (tests/test_vmap_ops.py's cases)
# ---------------------------------------------------------------------------


@register_vmap_op()
def _row_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x)


_calls = []


def _double_rule(info, in_dims, xs):
    _calls.append(info.batch_size)
    assert in_dims == (0,)
    return xs * 2.0, 0  # one call for the whole batch


@register_vmap_op(vmap_fn=_double_rule)
def _double(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


@register_vmap_op()
def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def test_register_vmap_op_sequential_default():
    x = torch.rand(4, 5, generator=torch.Generator().manual_seed(0)) + 0.1
    out = vmap(_row_normalize)(x)
    torch.testing.assert_close(out, x / torch.linalg.vector_norm(x, dim=1, keepdim=True), rtol=1e-6, atol=0)


def test_register_vmap_op_custom_rule():
    _calls.clear()
    x = torch.arange(6.0).reshape(3, 2)
    torch.testing.assert_close(vmap(_double)(x), x * 2.0)
    assert _calls == [3]
    # An unbatched call runs the function itself.
    torch.testing.assert_close(_double(torch.ones(2)), torch.full((2,), 2.0))
    assert _calls == [3]


def test_register_vmap_op_nested_vmap():
    x = torch.rand(2, 3, 4, generator=torch.Generator().manual_seed(1))
    out = vmap(vmap(_norm))(x)
    torch.testing.assert_close(out, torch.linalg.vector_norm(x, dim=-1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("ordered", [False, True])
def test_host_op_under_vmap(ordered):
    log = []

    def record(x):
        log.append(x.clone())
        return torch.cumsum(x, 0)

    call = host_op(record, ((4,), torch.float32), ordered=ordered)
    x = torch.tensor([1.0, 2.0, 3.0, 4.0])
    torch.testing.assert_close(call(x), torch.tensor([1.0, 3.0, 6.0, 10.0]))
    xs = torch.stack([x, 2 * x])
    if ordered:
        # As JAX's ordered io_callback: program order, and no vmap.
        with pytest.raises(ValueError, match="ordered"):
            vmap(call)(xs)
        for v in (10.0, 11.0, 12.0):
            call(torch.full((4,), v))
        assert [float(r[0]) for r in log[-3:]] == [10.0, 11.0, 12.0]
        return
    out = vmap(call)(xs)
    torch.testing.assert_close(out, torch.tensor([[1.0, 3.0, 6.0, 10.0], [2.0, 6.0, 12.0, 20.0]]))
    # Each instance reached the host function as a plain tensor of its own.
    assert [r.tolist() for r in log[-2:]] == [x.tolist(), (2 * x).tolist()]
    with pytest.raises(ValueError, match="declared"):
        host_op(lambda x: x[:2], ((4,), torch.float32))(x)


# ---------------------------------------------------------------------------
# ParamsAndVector
# ---------------------------------------------------------------------------


def _trees(seed):
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return [
        {"w": f(3, 4), "b": f(4)},
        {"layer2": {"kernel": f(2, 3), "bias": f(3)}, "layer1": {"kernel": f(5, 2), "bias": f(2)}, "a": f()},
        [f(2), (f(1, 3), {"z": f(2), "y": f(1)}), f(4)],
    ]


@pytest.mark.parametrize("i", range(3))
def test_params_and_vector_matches_ravel_pytree(i):
    tree = _trees(i)[i]
    want, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    port_tree = jax.tree_util.tree_map(torch.from_numpy, tree)
    pv = ParamsAndVector(port_tree)
    vec = pv.to_vector(port_tree)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    assert pv.vector_size == want.shape[0]
    back = pv.to_params(vec)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b), back, tree)
    # A population: (pop, n) rows and back.
    pop = torch.stack([vec, vec * 2, -vec])
    params = pv(pop)
    np.testing.assert_array_equal(pv.batched_to_vector(params).numpy(), pop.numpy())


def test_params_and_vector_takes_a_module():
    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Linear(2, 1))
    pv = ParamsAndVector(model)
    assert pv.vector_size == sum(p.numel() for p in model.parameters())
    params = pv.to_params(torch.arange(pv.vector_size, dtype=torch.float32))
    assert sorted(params) == sorted(k for k, _ in model.named_parameters())


# ---------------------------------------------------------------------------
# The rest of utils/ops.py
# ---------------------------------------------------------------------------


def _ops_inputs():
    r = np.random.default_rng(3)
    a = r.uniform(-3, 3, (5, 7)).astype(np.float32)
    a[0, 0], a[1, 1], a[2, 2] = np.nan, np.inf, -0.0
    lo = r.uniform(-2, 0, (7,)).astype(np.float32)
    hi = r.uniform(0, 2, (7,)).astype(np.float32)
    hi[3] = lo[3] - 1  # lo > hi: hi wins
    return a, lo, hi


@pytest.mark.parametrize("name", ["clamp", "clip", "clamp_float", "maximum", "minimum", "maximum_float",
                                  "minimum_int", "switch"])
def test_ops_match_jax(name):
    a, lo, hi = _ops_inputs()
    if name == "switch":
        label = np.array([[0, 1, 2, 5, -1, 1, 0]] * 5, np.int32)
        vals = [a, a * 2, a - 1]
        want = np.asarray(jops.switch(jnp.asarray(label), [jnp.asarray(v) for v in vals]))
        got = tops.switch(torch.from_numpy(label), [torch.from_numpy(v) for v in vals]).numpy()
    elif name.startswith("cl"):
        want = np.asarray(getattr(jops, name)(jnp.asarray(a), jnp.asarray(lo), jnp.asarray(hi)))
        got = getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
        want_n = np.asarray(getattr(jops, name)(jnp.asarray(a), -1.5, 2.0))
        np.testing.assert_array_equal(getattr(tops, name)(torch.from_numpy(a), -1.5, 2.0).numpy(), want_n)
    else:
        want = np.asarray(getattr(jops, name)(jnp.asarray(a), jnp.asarray(lo)))
        got = getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(lo)).numpy()
        np.testing.assert_array_equal(getattr(tops, name)(torch.from_numpy(a), 0.5).numpy(),
                                      np.asarray(getattr(jops, name)(jnp.asarray(a), 0.5)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_randint_tensor_bounds_as_jax():
    """The same contract as ``jax.random.randint`` with array bounds (the
    streams differ): every value in its own ``[low, high)``, every value of
    a small range drawn."""
    low = torch.tensor([0, 10, -5, 7])
    high = torch.tensor([3, 11, 5, 2**31 + 6])
    got = tops.randint(rng.key(0, "cpu"), (5000, 4), low, high)
    want = np.asarray(jops.randint(jax.random.key(0), (5000, 4), jnp.asarray(low.numpy()),
                                   jnp.asarray(np.minimum(high.numpy(), 2**31 - 1))))
    for v in (got.numpy(), want):
        assert np.all(v >= low.numpy()) and np.all(v < high.numpy())
    assert set(got[:, 0].tolist()) == {0, 1, 2} and set(got[:, 1].tolist()) == {10}
    assert set(got[:, 2].tolist()) == set(range(-5, 5))


def test_randint_follows_its_operands_device():
    """Number bounds draw where the key lies, tensor bounds where they lie,
    and the values do not depend on the bounds' form."""
    k = rng.key(3, "cpu")
    got = tops.randint(k, (40, 3), 2, 9)
    assert got.device.type == "cpu"
    assert torch.equal(got, tops.randint(k, (40, 3), torch.tensor(2), torch.tensor(9)))
    assert torch.equal(got, tops.randint(k, (40, 3), 2, 9, device="cpu"))
    assert torch.equal(got, 2 + rng.randint_below(rng.child(k), (40, 3), torch.tensor(7), "cpu"))


# ---------------------------------------------------------------------------
# The batched kernel routes (plain versions on the CPU)
# ---------------------------------------------------------------------------


def _move_inputs(b, n, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    fit = u(b, n)
    fit[:, ::5] = float("nan")
    big = [(u(b, n, d) * 8 - 4).to(dtype), (u(b, n, d) - 0.5).to(dtype), u(b, n, d).to(dtype)]
    scal = torch.stack([u(b) * 0.9, u(b) * 2.5, u(b)], 1)
    keys = torch.stack([torch.tensor([rng.signed64(s * 0x9E3779B97F4A7C15), s]) for s in range(b)])
    return big + [fit.to(dtype), u(b, n).to(dtype), u(b, d).to(dtype)], scal, keys, (u(b, n, d), u(b, n, d))


@pytest.mark.parametrize("rand", ["hw", "input"])
@pytest.mark.parametrize("per_instance_bounds", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_pso_move_plain_equals_solo_calls(dtype, per_instance_bounds, rand):
    b, n, d = 3, 9, 5
    arrays, scal, keys, draws = _move_inputs(b, n, d, dtype)
    if per_instance_bounds:
        lb, ub = -torch.rand(b, d) - 1, torch.rand(b, d) + 1
    else:
        lb, ub = torch.full((d,), -2.0), torch.full((d,), 2.0)
    got = pso_step.fused_pso_move_batched(
        *arrays, lb.to(dtype), ub.to(dtype), scal, keys, index=4, rand_draws=draws if rand == "input" else None
    )
    for i in range(b):
        solo = pso_step.fused_pso_move(
            *(a[i] for a in arrays), lb[i] if per_instance_bounds else lb, ub[i] if per_instance_bounds else ub,
            *scal[i], seed=rng.Seed(keys[i], 4), rand=rand,
            rand_draws=tuple(r[i] for r in draws) if rand == "input" else None,
        )
        for x, y in zip(got, solo):
            assert x[i].dtype == y.dtype
            torch.testing.assert_close(x[i], y, rtol=0, atol=0, equal_nan=True)


def test_vmapped_pso_move_takes_the_batched_route_nested_too():
    """``vmap`` of ``fused_pso_move`` goes through the batched operator (on
    the card one launch), a vmap around it merges the levels; both equal
    solo calls bit for bit."""
    arrays, scal, keys, _ = _move_inputs(6, 7, 4, torch.float32, seed=2)
    lb, ub = torch.full((4,), -2.0), torch.full((4,), 2.0)

    def move(p, v, l, f, lf, g, s, k):
        return pso_step.fused_pso_move(p, v, l, f, lf, g, lb, ub, *s, seed=rng.Seed(k, 1))

    flat = vmap(move)(*arrays, scal, keys)
    nested = vmap(vmap(move))(*(a.reshape(2, 3, *a.shape[1:]) for a in arrays), scal.reshape(2, 3, 3),
                              keys.reshape(2, 3, 2))
    for i in range(6):
        solo = move(*(a[i] for a in arrays), scal[i], keys[i])
        for x, y, z in zip(flat, nested, solo):
            torch.testing.assert_close(x[i], z, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(y.reshape(6, *y.shape[2:])[i], z, rtol=0, atol=0, equal_nan=True)


KINDS = [[torch.float32], [torch.bfloat16, (0, 7)], [torch.float64, torch.float16, (-3, 2**31 - 3), torch.float32]]


@pytest.mark.parametrize("kinds", KINDS, ids=["f32", "bf16_int", "four"])
@pytest.mark.parametrize("numel", [1, 5, 1001])
def test_batched_philox_plain_equals_solo_calls(numel, kinds):
    keys = torch.stack([torch.tensor([rng.signed64(s * 7919 + 2**63), s * 3]) for s in range(4)])
    got = philox.philox_draws_batched(keys, 2, numel, kinds)
    vm = vmap(lambda k: philox.philox_draws(rng.Seed(k, 2), numel, kinds, "cpu"))(keys)
    nested = vmap(vmap(lambda k: philox.philox_draws(rng.Seed(k, 2), numel, kinds, "cpu")))(keys.reshape(2, 2, 2))
    for i in range(4):
        solo = philox.philox_draws(rng.Seed(keys[i], 2), numel, kinds, "cpu")
        for x, v, w, z in zip(got, vm, nested, solo):
            assert x.shape == (4, numel) and x.dtype == z.dtype
            for y in (x[i], v[i], w.reshape(4, numel)[i]):
                torch.testing.assert_close(y, z, rtol=0, atol=0)
    # derive 0: the key's seed word itself, as an integer seed.
    got0 = philox.philox_draws_batched(keys, 0, numel, kinds, derive=0)
    solo0 = philox.philox_draws(int(keys[1, 0]) & (2**64 - 1), numel, kinds, "cpu")
    for x, z in zip(got0, solo0):
        torch.testing.assert_close(x[1], z, rtol=0, atol=0)


def test_batched_eigh_rule_equals_solo_calls():
    g = torch.Generator().manual_seed(5)
    a = torch.randn(5, 6, 6, generator=g)
    c = a @ a.mT + torch.eye(6)
    c[2, 0, 0] = float("nan")  # all NaN for that instance alone
    w, v = vmap(linalg.eigh)(c)
    for i in range(5):
        ws, vs = linalg.eigh(c[i])
        torch.testing.assert_close(w[i], ws, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(v[i], vs, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(w[2]).all()) and not bool(torch.isnan(w[1]).any())
    # Any n: above 32 the card takes the Jacobi kernel.  A stack that is
    # not square is refused.
    w, v = linalg.eigh_batched(torch.zeros(2, 40, 40))
    assert w.shape == (2, 40) and v.shape == (2, 40, 40)
    with pytest.raises(ValueError):
        linalg.eigh_batched(torch.zeros(2, 40, 41))


# ---------------------------------------------------------------------------
# Vmapped workflows
# ---------------------------------------------------------------------------

D = 6
_CPU = dict(device="cpu")
_C = torch.zeros(D)
_LB, _UB = torch.full((D,), -5.0), torch.full((D,), 5.0)
_MO = (torch.zeros(12), torch.ones(12))
# name -> (factory, matrix product or factorisation on the path)
ALGORITHMS = {
    "PSO": (lambda: algorithms.PSO(20, _LB, _UB, **_CPU), False),
    "CSO": (lambda: algorithms.CSO(20, _LB, _UB, phi=0.1, **_CPU), False),
    "CLPSO": (lambda: algorithms.CLPSO(20, _LB, _UB, **_CPU), False),
    "SLPSOGS": (lambda: algorithms.SLPSOGS(20, _LB, _UB, **_CPU), False),
    "SLPSOUS": (lambda: algorithms.SLPSOUS(20, _LB, _UB, **_CPU), False),
    "FSPSO": (lambda: algorithms.FSPSO(20, _LB, _UB, **_CPU), False),
    "DMSPSOEL": (lambda: algorithms.DMSPSOEL(_LB, _UB, 3, 4, 8, regrouped_iteration_num=2, max_iteration=4,
                                             **_CPU), False),
    "DE": (lambda: algorithms.DE(20, _LB, _UB, **_CPU), False),
    "ODE": (lambda: algorithms.ODE(20, _LB, _UB, **_CPU), False),
    "JaDE": (lambda: algorithms.JaDE(20, _LB, _UB, **_CPU), False),
    "SHADE": (lambda: algorithms.SHADE(20, _LB, _UB, **_CPU), False),
    "SaDE": (lambda: algorithms.SaDE(20, _LB, _UB, **_CPU), False),
    "CoDE": (lambda: algorithms.CoDE(20, _LB, _UB, **_CPU), False),
    "CMAES": (lambda: algorithms.CMAES(_C, 1.0, pop_size=16, **_CPU), True),
    "OpenES": (lambda: algorithms.OpenES(16, _C, 0.05, 0.1, **_CPU), False),
    "XNES": (lambda: algorithms.XNES(_C, torch.eye(D), pop_size=16, **_CPU), True),
    "SeparableNES": (lambda: algorithms.SeparableNES(_C, torch.ones(D), pop_size=16, **_CPU), True),
    "SNES": (lambda: algorithms.SNES(16, _C, **_CPU), True),
    "DES": (lambda: algorithms.DES(16, _C, **_CPU), True),
    "ARS": (lambda: algorithms.ARS(16, _C, **_CPU), True),
    "ASEBO": (lambda: algorithms.ASEBO(16, _C, subspace_dims=4, **_CPU), True),
    "GuidedES": (lambda: algorithms.GuidedES(16, _C, **_CPU), True),
    "PersistentES": (lambda: algorithms.PersistentES(16, _C, **_CPU), True),
    "NoiseReuseES": (lambda: algorithms.NoiseReuseES(16, _C, **_CPU), True),
    "ESMC": (lambda: algorithms.ESMC(17, _C, **_CPU), True),
    "NSGA2": (lambda: algorithms.NSGA2(20, 3, *_MO, **_CPU), False),
    "NSGA3": (lambda: algorithms.NSGA3(20, 3, *_MO, **_CPU), True),
    "RVEA": (lambda: algorithms.RVEA(20, 3, *_MO, **_CPU), True),
    "RVEAa": (lambda: algorithms.RVEAa(20, 3, *_MO, **_CPU), True),
    "MOEAD": (lambda: algorithms.MOEAD(20, 3, *_MO, **_CPU), True),
    "HypE": (lambda: algorithms.HypE(20, 3, *_MO, **_CPU), True),
}
_MULTI = {"NSGA2", "NSGA3", "RVEA", "RVEAa", "MOEAD", "HypE"}


def _scale(t):
    """A leaf's scale: its largest finite magnitude (at least 1)."""
    t = t.double()
    finite = t[torch.isfinite(t)]
    return max(1.0, float(finite.abs().max())) if finite.numel() else 1.0


def _instance(state, i):
    leaves, spec = graph.flatten(state)
    return graph.unflatten(spec, [x[i] for x in leaves])


def _same(got, want, rtol, what):
    lg, sg = graph.flatten(got)
    lw, sw = graph.flatten(want)
    assert sg == sw, what
    for x, y in zip(lg, lw):
        assert x.shape == y.shape and x.dtype == y.dtype, what
        if rtol and x.is_floating_point():
            torch.testing.assert_close(x, y, rtol=0, atol=rtol * _scale(y), equal_nan=True, msg=what)
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=what)


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_vmapped_step_equals_solo_runs(name):
    """``torch.func.vmap(wf.step)`` over 3 instances equal to 3 solo runs
    from the same keys: bit for bit, or within BATCHED_RTOL where the
    generation takes a batched matrix product or factorisation."""
    factory, batched_products = ALGORITHMS[name]
    problem = DTLZ2(m=3, device="cpu") if name in _MULTI else Sphere()
    wf = StdWorkflow(factory(), problem)
    keys = torch.stack([rng.key(k) for k in (10, 11, 12)])
    states = vmap(wf.init_step)(vmap(wf.init)(keys))
    step = vmap(wf.step)
    for _ in range(3):
        states = step(states)
    for i in range(3):
        solo = wf.init_step(wf.init(keys[i]))
        for _ in range(3):
            solo = wf.step(solo)
        _same(_instance(states, i), solo, BATCHED_RTOL if batched_products else 0, f"{name} instance {i}")
    assert not torch.equal(states.algorithm.fit[0], states.algorithm.fit[1])


def test_vmap_workflow_monitor_unordered():
    """The port of ``tests/test_std_workflow.py``'s unordered-monitor test:
    under vmap each history entry carries the leading instance axis, the
    grouping depends only on the (generation, instance) tags, and the
    per-instance top-k stays per instance; each instance's history equals
    its solo run's."""
    n_instances, n_steps, pop, dim = 4, 3, 20, 5
    mon = EvalMonitor(topk=2, full_fit_history=True, full_sol_history=True, ordered=False,
                      num_instances=n_instances)
    algo = algorithms.PSO(pop, torch.full((dim,), -32.0), torch.full((dim,), 32.0), **_CPU)
    wf = StdWorkflow(algo, Ackley(), monitor=mon)
    keys = torch.stack([rng.key(k) for k in range(7, 7 + n_instances)])
    states = vmap(wf.init)(keys, torch.arange(n_instances))
    assert states.monitor.instance_id.tolist() == list(range(n_instances))
    states = vmap(wf.init_step)(states)
    step = vmap(wf.step)
    for _ in range(n_steps):
        states = step(states)

    # Any order of arrival: shuffle the raw entries in place.
    shuffler = random.Random(0)
    for entries in mon._history.values():
        shuffler.shuffle(entries)

    assert states.monitor.topk_fitness.shape == (n_instances, 2)
    assert states.monitor.topk_solutions.shape == (n_instances, 2, dim)
    topk = vmap(mon.get_topk_fitness)(states.monitor)
    assert bool((torch.diff(topk, dim=1) >= 0).all())
    fit_hist, sol_hist = mon.fitness_history, mon.solution_history
    assert len(fit_hist) == n_steps + 1
    assert fit_hist[0].shape == (n_instances, pop) and sol_hist[0].shape == (n_instances, pop, dim)
    hist_min = torch.stack([h.min(dim=1).values for h in fit_hist]).min(dim=0).values
    torch.testing.assert_close(states.monitor.topk_fitness[:, 0], hist_min, rtol=0, atol=0)
    assert not torch.equal(fit_hist[-1][0], fit_hist[-1][1])

    solo_mon = EvalMonitor(topk=2, full_fit_history=True, full_sol_history=True)
    solo_wf = StdWorkflow(algo, Ackley(), monitor=solo_mon)
    for i in range(n_instances):
        solo_mon.clear_history()
        s = solo_wf.init_step(solo_wf.init(keys[i]))
        for _ in range(n_steps):
            s = solo_wf.step(s)
        for g in range(n_steps + 1):
            torch.testing.assert_close(fit_hist[g][i], solo_mon.fitness_history[g], rtol=0, atol=0)
            torch.testing.assert_close(sol_hist[g][i], solo_mon.solution_history[g], rtol=0, atol=0)

    # A second run on the same monitor repeats the tags: refused, not mixed.
    states = step(vmap(wf.init_step)(vmap(wf.init)(keys, torch.arange(n_instances))))
    with pytest.raises(RuntimeError, match="duplicate"):
        mon.fitness_history


def test_ordered_monitor_refuses_vmap():
    wf = StdWorkflow(algorithms.PSO(10, _LB, _UB, **_CPU), Sphere(), monitor=EvalMonitor())
    keys = torch.stack([rng.key(k) for k in (1, 2)])
    with pytest.raises(ValueError, match="ordered"):
        vmap(wf.init_step)(vmap(wf.init)(keys))


@pytest.mark.parametrize("call", ["run", "run_segment"])
def test_fused_segment_under_vmap_is_refused(call):
    """JAX's vmapped segment is ported: under vmap the generations run
    eagerly (never with batched tensors in a graph's buffers), and each
    instance equals its own segment bit for bit."""
    wf = StdWorkflow(algorithms.PSO(10, _LB, _UB, **_CPU), Sphere())
    keys = torch.stack([rng.key(k) for k in (1, 2)])
    states = vmap(wf.init_step)(vmap(wf.init)(keys))
    if call == "run_segment":
        got, tel = vmap(lambda s: wf.run_segment(s, 2))(states)
        assert tel.executed.tolist() == [2, 2] and tuple(tel.best_fitness.shape) == (2, 2)
    else:
        got = vmap(lambda s: wf.run(s, 2, init=False))(states)
    for i in range(2):
        one = _instance(states, i)
        want = wf.run_segment(one, 2)[0] if call == "run_segment" else wf.run(one, 2, init=False)
        for a, b in zip(graph.flatten(_instance(got, i))[0], graph.flatten(want)[0]):
            assert torch.equal(a, b)
