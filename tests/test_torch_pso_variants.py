"""The port's other PSO variants (CSO, CLPSO, SL-PSO GS/US, FS-PSO,
DMS-PSO-EL) and ``random_select_from_mask`` against the JAX package's, on
the CPU.

Each generation starts both frameworks from the same state (JAX's, carried
across with ``state_from_numpy``).  JAX's step runs one operation at a time
(``jax.disable_jit``: XLA's CPU backend would contract ``a * b + c`` into a
fused multiply-add inside a jitted program, ROADMAP's standing notes), the
port's step gets JAX's draws through its ``_draws`` seam and evaluates with
JAX's problem (``JaxEvaluated``).  Then every leaf is equal bit for bit:
positions, velocities, bests, index tables and masks.  The one exception is
a mean over the population (CSO's ``center``, SL-PSO's ``x_avg``): the two
frameworks add the rows in another order, so the swarm center is held
within ``CENTER_RTOL`` and, where it enters the update, the moved rows
within ``MOVE_RTOL`` (see below).  The fitness of those tests carries -0.0
next to +0.0, exact ties and NaN, so the stable sorts (NaN last, ±0 tied)
are held against ``jnp.argsort``'s order too.

Each variant also runs eager, fused (``run``) and vmapped over instances,
the three modes ``tests/test_base_algorithms.py`` asks of the JAX package.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu import algorithms as jalgorithms  # noqa: E402
from evox_tpu.algorithms.so.pso_variants.utils import random_select_from_mask as jselect  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.algorithms.so.pso_variants.utils import random_select_from_mask  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402
from test_torch_de import JaxEvaluated, jeval  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402
from test_torch_rvea import Injected  # noqa: E402

N, D, GENS = 32, 6, 4
# The swarm center is a mean over the population's rows, summed in another
# order by XLA and by PyTorch: a few float32 roundings of the sum, relative
# to the largest magnitude of the column (the sum may cancel).
CENTER_RTOL = 1e-6
# A row moved through the center: its velocity term ``phi * r * (center -
# x)`` carries the center's rounding, scaled by ``phi * r <= 1``; relative
# to the box width (the positions' scale).  Its Sphere fitness then moves by
# at most ``2 |x| dx`` a coordinate (FIT_ATOL).
MOVE_RTOL = 1e-6
BOX = 5.0
MOVE_ATOL = MOVE_RTOL * 2 * BOX
FIT_ATOL = 2 * BOX * D * MOVE_ATOL


def long(a):
    return t(a).to(torch.int64)


def uniform(key, shape):
    return t(jax.random.uniform(key, shape))


# ---------------------------------------------------------------------------
# JAX's draws from the keys its steps split (made one operation at a time,
# like the steps).
# ---------------------------------------------------------------------------


def cso_draws(ja, algo):
    _, pair_key, lam_key = jax.random.split(ja.key, 3)
    half = algo.pop_size // 2
    lams = jax.random.uniform(lam_key, (3, half, algo.dim))
    return long(jax.random.permutation(pair_key, algo.pop_size)), tuple(t(x) for x in lams)


def clpso_draws(ja, algo):
    _, coeff_key, r1_key, r2_key, p_key = jax.random.split(ja.key, 5)
    n = algo.pop_size
    return (
        uniform(coeff_key, (n, algo.dim)),
        long(jax.random.randint(r1_key, (n,), 0, n)),
        long(jax.random.randint(r2_key, (n,), 0, n)),
        uniform(p_key, (n,)),
    )


def slpso_draws(ja, algo):
    _, demo_key, r_key = jax.random.split(ja.key, 3)
    n = algo.pop_size
    demo = jax.random.normal(demo_key, (n,)) if isinstance(algo, algorithms.SLPSOGS) else jax.random.uniform(
        demo_key, (n,)
    )
    return t(demo), tuple(t(x) for x in jax.random.uniform(r_key, (3, n, algo.dim)))


def fspso_draws(ja, algo):
    _, vel_key, t1_key, t2_key, off_key, mask_key = jax.random.split(ja.key, 6)
    half = algo.pop_size // 2
    rg, rp = jax.random.uniform(vel_key, (2, half, algo.dim))
    return (
        t(rg), t(rp),
        long(jax.random.randint(t1_key, (half,), 0, half)),
        long(jax.random.randint(t2_key, (half,), 0, half)),
        uniform(off_key, (half, algo.dim)),
        uniform(mask_key, (half, algo.dim)),
    )


def dms_phase1(ja):
    return int(ja.iteration) < int((0.9 * ja.max_iteration).astype(jnp.int32))


def dms_draws(ja, algo):
    _, regroup_key, rand_key = jax.random.split(ja.key, 3)
    n, d, dyn = algo.pop_size, algo.dim, algo.swarm_size * algo.swarms_num
    perm = long(jax.random.permutation(regroup_key, dyn))
    if dms_phase1(ja):
        k1, k2, k3 = jax.random.split(rand_key, 3)
        u1 = jnp.concatenate([
            jax.random.uniform(k2, (algo.swarms_num, algo.swarm_size, d)).reshape(dyn, d),
            jax.random.uniform(k3, (algo.following_size, d)),
        ])
        return perm, uniform(k1, (n, d)), t(u1)
    u0, u1 = jax.random.uniform(rand_key, (2, n, d))
    return perm, t(u0), t(u1)


def _box():
    return np.full(D, -BOX, np.float32), np.full(D, BOX, np.float32)


# (name, class, keyword arguments, draw helper, leaves moved through a mean)
VARIANTS = {
    "CSO": ("CSO", {}, cso_draws, set()),
    "CSO_phi": ("CSO", dict(phi=0.3), cso_draws, {"pop", "velocity", "fit"}),
    "CLPSO": ("CLPSO", dict(learning_probability=0.5), clpso_draws, set()),
    "SLPSOGS": ("SLPSOGS", {}, slpso_draws, {"pop", "velocity", "fit"}),
    "SLPSOUS": ("SLPSOUS", {}, slpso_draws, {"pop", "velocity", "fit"}),
    "SLPSOGS_no_mean": ("SLPSOGS", dict(social_influence_factor=0.0), slpso_draws, set()),
    "SLPSOUS_no_mean": ("SLPSOUS", dict(social_influence_factor=0.0), slpso_draws, set()),
    "FSPSO": ("FSPSO", dict(mutate_rate=0.3), fspso_draws, set()),
    # 8 dynamic swarms of 3 plus 8 followers = N; regroup every 2
    # iterations, the switch at int(0.9 * 6) = 5 (test_dms_crosses_regroup_
    # and_switch steps across both).
    "DMSPSOEL": ("DMSPSOEL", dict(dynamic_sub_swarm_size=3, dynamic_sub_swarms_num=8,
                                  following_sub_swarm_size=8, regrouped_iteration_num=2, max_iteration=6),
                 dms_draws, set()),
}


def _make(name, port_cls=None, **extra):
    cls, kw, _, _ = VARIANTS[name]
    kw = {**kw, **extra}
    lb, ub = _box()
    if cls == "DMSPSOEL":
        jalgo = jalgorithms.DMSPSOEL(jnp.asarray(lb), jnp.asarray(ub), **kw)
        algo = (port_cls or getattr(algorithms, cls))(t(lb), t(ub), device="cpu", **kw)
    else:
        jalgo = getattr(jalgorithms, cls)(N, jnp.asarray(lb), jnp.asarray(ub), **kw)
        algo = (port_cls or getattr(algorithms, cls))(N, t(lb), t(ub), device="cpu", **kw)
    return jalgo, algo


def _injected(cls):
    return type(f"Injected{cls.__name__}", (Injected, cls), {})


def _check(ts, js, moved, what):
    ts, js = ts.algorithm, js.algorithm
    assert list(ts) == list(js), what
    for k in js:
        if k == "key":
            continue
        got, want = ts[k].numpy(), np.asarray(js[k])
        assert got.shape == want.shape and got.dtype == want.dtype, (what, k, got.dtype, want.dtype)
        if k in moved:
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: {k}")
            atol = FIT_ATOL if k == "fit" else MOVE_ATOL
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what}: {k}")


def _special_fitness(fit):
    """Fitness with -0.0 beside +0.0, exact ties and NaN, for the sorts."""
    f = np.array(fit, np.float32)
    f[0], f[5], f[9] = 0.0, -0.0, 0.0
    f[3] = f[7] = f[11]
    f[2] = np.nan
    return jnp.asarray(f)


@pytest.mark.parametrize("special", [False, True], ids=["plain", "ties_nan"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_steps_match_jax_with_injected_draws(name, special):
    _, _, draws, moved = VARIANTS[name]
    jalgo, algo = _make(name, port_cls=_injected(getattr(algorithms, VARIANTS[name][0])))
    jwf, wf = JWorkflow(jalgo, JSphere()), StdWorkflow(algo, JaxEvaluated(JSphere()))
    key = jax.random.key(len(name))
    js = jeval(jwf.init_step, jwf.init(key))
    ts = wf.init_step(state_from_numpy(to_numpy(jwf.init(key)), device="cpu"))
    _check(ts, js, set(), f"{name} init_step")
    for gen in range(GENS):
        if special:
            js = js.replace(algorithm=js.algorithm.replace(fit=_special_fitness(js.algorithm.fit)))
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = jeval(draws, js.algorithm, algo)
        ts = wf.step(ts)
        js = jeval(jwf.step, js)
        _check(ts, js, moved, f"{name} generation {gen + 1}")


@pytest.mark.parametrize("name", ["CSO_phi", "SLPSOGS"])
def test_swarm_center_within_its_tolerance(name):
    """The mean the update reads (CSO's ``center``, SL-PSO's ``x_avg``)
    against ``jnp.mean`` on the same population."""
    jalgo, algo = _make(name)
    pop = np.random.default_rng(4).uniform(-BOX, BOX, (N, D)).astype(np.float32)
    pop[3] = -pop[4]  # a cancelling pair
    want = np.asarray(jeval(jnp.mean, jnp.asarray(pop), 0))
    got = torch.mean(t(pop), dim=0).numpy()
    scale = np.abs(pop).max(axis=0)
    assert np.all(np.abs(got - want) <= CENTER_RTOL * scale)


def test_dms_crosses_regroup_and_switch():
    """DMS-PSO-EL from iteration 1: the regroup fires at even iterations
    while ``iteration < int(0.9 * max_iteration)``, then strategy 2 runs;
    the port's selects follow JAX's branches through both."""
    jalgo, algo = _make("DMSPSOEL", port_cls=_injected(algorithms.DMSPSOEL))
    jwf, wf = JWorkflow(jalgo, JSphere()), StdWorkflow(algo, JaxEvaluated(JSphere()))
    js = jeval(jwf.init_step, jwf.init(jax.random.key(2)))
    seen = []
    for gen in range(7):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = jeval(dms_draws, js.algorithm, algo)
        seen.append((int(js.algorithm.iteration), dms_phase1(js.algorithm)))
        ts = wf.step(ts)
        js = jeval(jwf.step, js)
        _check(ts, js, set(), f"DMSPSOEL generation {gen + 1}")
    assert seen == [(1, True), (2, True), (3, True), (4, True), (5, False), (6, False), (7, False)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_select_from_mask_matches_jax(seed):
    r = np.random.default_rng(seed)
    mask = r.uniform(size=(17, 9)) < 0.3
    mask[0] = False  # a row with no True entry gives 0
    mask[1] = True
    mask[2, 4] = True
    mask[2, :4] = mask[2, 5:] = False
    key = jax.random.key(seed)
    want = np.asarray(jselect(key, jnp.asarray(mask)))
    gumbel = t(jax.random.gumbel(key, mask.shape))
    got = random_select_from_mask(None, torch.from_numpy(mask), gumbel=gumbel).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[2] == 4
    # The port's own draw: one Philox launch, a True column of each row.
    own = random_select_from_mask(rng.child(rng.key(seed)), torch.from_numpy(mask)).numpy()
    assert all(mask[i, own[i]] if mask[i].any() else own[i] == 0 for i in range(17))


def test_setup_layout_matches_jax():
    for name in VARIANTS:
        jalgo, algo = _make(name)
        js, ts = jalgo.setup(jax.random.key(0)), algo.setup(rng.key(0))
        assert list(ts) == list(js), name
        assert ts.param_keys == js.param_keys, name
        for k in js:
            if k != "key":
                assert tuple(ts[k].shape) == js[k].shape, (name, k)
                assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), (name, k)
        assert bool((ts.pop >= -BOX).all()) and bool((ts.pop <= BOX).all()), name


@pytest.mark.parametrize("name", [n for n in VARIANTS if not n.endswith("_no_mean")])
def test_eager_fused_and_vmapped(name):
    """The three modes on the port's Sphere: ``run(n)`` equal to eager
    steps on every leaf, a vmapped step over 3 instances equal to 3 solo
    runs from the same keys, bit for bit, and the best fitness falling."""
    _, algo = _make(name)
    wf = StdWorkflow(algo, Sphere())
    s0 = wf.init_step(wf.init(3))
    s = s0
    for _ in range(6):
        s = wf.step(s)
    _equal(wf.run(s0, 6, init=False), s)
    assert float(s.algorithm.fit.min()) <= float(s0.algorithm.fit.min())

    keys = torch.stack([rng.key(k) for k in (5, 6, 7)])
    vs = torch.func.vmap(wf.init_step)(torch.func.vmap(wf.init)(keys))
    step = torch.func.vmap(wf.step)
    for _ in range(4):
        vs = step(vs)
    leaves, spec = graph.flatten(vs)
    for b in range(3):
        solo = wf.init_step(wf.init(keys[b]))
        for _ in range(4):
            solo = wf.step(solo)
        _equal(graph.unflatten(spec, [x[b] for x in leaves]), solo)
    assert not torch.equal(vs.algorithm.fit[0], vs.algorithm.fit[1])


def _equal(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def test_refusals():
    lb, ub = torch.full((D,), -1.0), torch.full((D,), 1.0)
    for cls in (algorithms.CSO, algorithms.FSPSO):
        with pytest.raises(ValueError):
            cls(7, lb, ub, device="cpu")
    with pytest.raises(ValueError):
        algorithms.CLPSO(8, lb, ub[:3], device="cpu")  # bounds of two shapes
