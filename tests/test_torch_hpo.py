"""The port's HPO nested core (``evox_tpu_torch/hpo``,
``evox_tpu_torch/problems/hpo_wrapper.py``) against the JAX package's
(``evox_tpu/hpo``), on the CPU at a small size.

The port's keys are Philox and JAX's threefry, so the comparisons keep
draws out by construction or carry them across:

* **the monitor** (``HPOFitnessMonitor``, the repeat aggregation under a
  nested vmap against JAX's ``all_gather`` under a named vmap, the raw
  fitness standalone and under ``"final"``): the same numpy fitness on both
  sides, bit for bit.  With ``multi_obj_metric`` = IGD against DTLZ1's
  front, IGD is a mean over the front's 2000 points, which XLA and torch
  add in another order (measured 1 ulp): each monitor's fold is held bit for
  bit against the running minimum of its own framework's IGD, and the two
  within :data:`IGD_RTOL`;
* **the draw-free nest**: a test-only inner algorithm written in both
  frameworks (:class:`Sweep`), whose population is a function of its state
  and its ``hp`` Parameter; the one per-lane value, ``phase``, is drawn in
  JAX's setup and carried into the port's state.  JAX's evaluation runs one
  operation at a time (``jax.disable_jit()``, no fused multiply-add) on
  Sphere at D = 2 (one addition a row).  Fitness and telemetry bit for bit,
  in both ``prng`` modes, with and without repeats, under both
  aggregations, and at ``iterations=2``;
* **vmap against solo**: the port alone; each candidate of a vmapped
  evaluation equals its solo inner run bit for bit (OpenES sums its
  gradient in a fixed pairwise order; the PSO move is one instance of the
  batched operator);
* **the ports of JAX's own tests** keep their tolerances (the JaDE repeats
  oracle at rtol 1e-5).
"""

import ast
import pickle
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.core import Algorithm as JAlgorithm  # noqa: E402
from evox_tpu.core import Parameter as JParameter  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.hpo import HPO_REPEAT_AXIS as JHPO_REPEAT_AXIS  # noqa: E402
from evox_tpu.hpo import HPOFitnessMonitor as JHPOFitnessMonitor  # noqa: E402
from evox_tpu.hpo import NestedProblem as JNestedProblem  # noqa: E402
from evox_tpu.hpo import monitor as jmonitor  # noqa: E402
from evox_tpu.metrics import igd as jigd  # noqa: E402
from evox_tpu.problems.numerical import DTLZ1 as JDTLZ1  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.core import Algorithm, Monitor, Parameter, Problem, State, set_params  # noqa: E402
from evox_tpu_torch.hpo import (  # noqa: E402
    HPO_REPEAT_AXIS,
    HPOFitnessMonitor,
    HPOMonitor,
    NestedProblem,
    candidate_series,
    find_nested,
)
from evox_tpu_torch.hpo import monitor as tmonitor  # noqa: E402
from evox_tpu_torch.metrics import igd  # noqa: E402
from evox_tpu_torch.problems.hpo_wrapper import HPOProblemWrapper  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ1, Sphere  # noqa: E402
from evox_tpu_torch.resilience.health import _is_prng, _leaves_with_path  # noqa: E402
from evox_tpu_torch.utils import graph, rng  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402
from evox_tpu_torch.workflows.std_workflow import check_kernel_dtypes  # noqa: E402

CPU = torch.device("cpu")
vmap = torch.func.vmap
# IGD of the same objectives in the two frameworks: a float32 mean over
# DTLZ1's 2000 front points summed in another order (measured 1 ulp, ~6e-8
# relative).
IGD_RTOL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a))


def bits_equal(got, want, what=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def same_tree(got, want, what=""):
    """Two port trees equal leaf for leaf, bit for bit."""
    lg, sg = graph.flatten(got)
    lw, sw = graph.flatten(want)
    assert sg == sw, what
    for i, (x, y) in enumerate(zip(lg, lw)):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(x.isnan(), y.isnan())
                                     and torch.equal(x.nan_to_num(), y.nan_to_num())), (what, i)


# ---------------------------------------------------------------------------
# (a) The monitor
# ---------------------------------------------------------------------------

FIT_SEQ = [np.random.default_rng(s).normal(size=12).astype(np.float32) * (3 - s) for s in range(5)]


def test_monitor_single_objective_matches_jax():
    jmon, mon = JHPOFitnessMonitor(), HPOFitnessMonitor()
    js, ts = jmon.setup(jax.random.key(0)), mon.setup(rng.key(0))
    bits_equal(ts.best_fitness, js.best_fitness, "setup")
    for i, f in enumerate(FIT_SEQ):
        js, ts = jmon.pre_tell(js, jnp.asarray(f)), mon.pre_tell(ts, t(f))
        bits_equal(mon.tell_fitness(ts), jmon.tell_fitness(js), i)


def test_monitor_multi_objective_igd_against_dtlz1_matches_jax():
    jprob, prob = JDTLZ1(d=2, m=2), DTLZ1(d=2, m=2, device=CPU)
    bits_equal(prob.pf(), jprob.pf(), "the front")
    jmetric, metric = (lambda f: jigd(f, jprob.pf())), (lambda f: igd(f, prob.pf()))
    jmon, mon = JHPOFitnessMonitor(multi_obj_metric=jmetric), HPOFitnessMonitor(multi_obj_metric=metric)
    js, ts = jmon.setup(jax.random.key(0)), mon.setup(rng.key(0))
    jbest = tbest = np.float32(np.inf)
    rs = np.random.default_rng(3)
    for i in range(6):
        f = (rs.random((10, 2)) * (4 - 0.5 * i)).astype(np.float32)
        js, ts = jmon.pre_tell(js, jnp.asarray(f)), mon.pre_tell(ts, t(f))
        jbest = np.minimum(jbest, np.asarray(jmetric(jnp.asarray(f))))
        tbest = np.minimum(tbest, metric(t(f)).numpy())
        bits_equal(jmon.tell_fitness(js), jbest, ("JAX's fold", i))
        bits_equal(mon.tell_fitness(ts), tbest, ("the port's fold", i))
        np.testing.assert_allclose(mon.tell_fitness(ts).numpy(), np.asarray(jmon.tell_fitness(js)), rtol=IGD_RTOL)


def _jax_repeat_lanes(fn, wiring, fit):
    """``fn`` of each lane under ``jax.vmap`` over candidates and a named
    ``jax.vmap`` over repeats, with the nest's wiring installed."""
    token = jmonitor._REPEAT_WIRING.set(wiring)
    try:
        with jax.disable_jit():
            return jax.vmap(jax.vmap(fn, axis_name=JHPO_REPEAT_AXIS))(fit)
    finally:
        jmonitor._REPEAT_WIRING.reset(token)


def _port_repeat_lanes(fn, wiring, fit):
    """The port's counterpart: ``torch.func.vmap`` over candidates and over
    repeats, the inner level bound as the repeat axis (as
    ``NestedProblem._run_batch`` binds it)."""

    def lane(f):
        token = tmonitor._REPEAT_LEVEL.set(torch._C._functorch.maybe_current_level())
        try:
            return fn(f)
        finally:
            tmonitor._REPEAT_LEVEL.reset(token)

    token = tmonitor._REPEAT_WIRING.set(wiring)
    try:
        return vmap(vmap(lane))(fit)
    finally:
        tmonitor._REPEAT_WIRING.reset(token)


REDUCERS = {
    "mean": (jnp.mean, torch.mean),
    "max_1d": (lambda v: jnp.max(v), lambda v: torch.amax(v)),  # no axis=: the 1-D fallback
}


@pytest.mark.parametrize("reducer", list(REDUCERS))
def test_aggregate_repeats_under_nested_vmap_matches_all_gather(reducer):
    """(candidates, repeats, pop) fitness: every lane of a candidate gets the
    reduction over that candidate's repeat lanes, as JAX's ``all_gather``
    over ``HPO_REPEAT_AXIS`` gives it, bit for bit; and a monitor's best
    over three generations of such fitness."""
    jfn, tfn = REDUCERS[reducer]
    fit = np.random.default_rng(1).normal(size=(4, 3, 10)).astype(np.float32)
    jmon, mon = JHPOFitnessMonitor(), HPOFitnessMonitor()
    got = _port_repeat_lanes(mon.aggregate_repeats, (3, tfn), t(fit))
    want = _jax_repeat_lanes(jmon.aggregate_repeats, (3, jfn), jnp.asarray(fit))
    bits_equal(got, want)
    # Through pre_tell, three generations.
    js = jax.vmap(jax.vmap(jmon.setup))(jax.random.split(jax.random.key(0), 12).reshape(4, 3))
    ts = vmap(vmap(mon.setup))(torch.stack(rng.split_keys(rng.key(0), 12)).reshape(4, 3, 2))
    for g in range(3):
        f = fit * (g + 1) - g
        js = _jax_pre_tell(jmon, js, f, (3, jfn))
        ts = _port_pre_tell(mon, ts, f, (3, tfn))
        bits_equal(ts.best_fitness, js.best_fitness, g)


def _jax_pre_tell(jmon, js, f, wiring):
    token = jmonitor._REPEAT_WIRING.set(wiring)
    try:
        with jax.disable_jit():
            return jax.vmap(jax.vmap(jmon.pre_tell, axis_name=JHPO_REPEAT_AXIS))(js, jnp.asarray(f))
    finally:
        jmonitor._REPEAT_WIRING.reset(token)


def _port_pre_tell(mon, ts, f, wiring):
    def lane(s, x):
        token = tmonitor._REPEAT_LEVEL.set(torch._C._functorch.maybe_current_level())
        try:
            return mon.pre_tell(s, x)
        finally:
            tmonitor._REPEAT_LEVEL.reset(token)

    token = tmonitor._REPEAT_WIRING.set(wiring)
    try:
        return vmap(vmap(lane))(ts, t(f))
    finally:
        tmonitor._REPEAT_WIRING.reset(token)


def test_aggregate_repeats_does_not_reduce_across_candidates():
    """Candidates of very different scales: each lane gets its own
    candidate's mean, and a vmap level inside the repeat vmap passes the
    reduction on to the repeat level."""
    fit = np.random.default_rng(2).normal(size=(3, 4, 5)).astype(np.float32)
    fit *= np.asarray([1.0, 100.0, 1e4], np.float32)[:, None, None]
    mon = HPOFitnessMonitor()
    got = _port_repeat_lanes(mon.aggregate_repeats, (4, torch.mean), t(fit))
    want = t(fit).mean(dim=1, keepdim=True).expand(3, 4, 5)
    assert torch.equal(got, want)
    # An unbound vmap level inside the repeat level (over the population):
    # the rule passes the call outward, the result is the same.

    def inner(f):
        token = tmonitor._REPEAT_LEVEL.set(torch._C._functorch.maybe_current_level())
        try:
            return vmap(mon.aggregate_repeats)(f[:, None])[:, 0]
        finally:
            tmonitor._REPEAT_LEVEL.reset(token)

    token = tmonitor._REPEAT_WIRING.set((4, torch.mean))
    try:
        nested = vmap(vmap(inner))(t(fit))
    finally:
        tmonitor._REPEAT_WIRING.reset(token)
    assert torch.equal(nested, want)


def test_raw_fitness_standalone_and_under_final():
    """With no repeat axis bound the monitor sees the raw per-lane fitness:
    standalone (its constructor's ``num_repeats=3``), and under a nest's
    ``"final"`` wiring (``(1, mean)``) inside a nested vmap, as JAX's
    ``NameError`` branch and early return give."""
    fit = np.random.default_rng(4).normal(size=(2, 3, 6)).astype(np.float32)
    jmon, mon = JHPOFitnessMonitor(num_repeats=3), HPOFitnessMonitor(num_repeats=3)
    with jax.disable_jit():
        bits_equal(mon.aggregate_repeats(t(fit[0, 0])), jmon.aggregate_repeats(jnp.asarray(fit[0, 0])))
        bits_equal(vmap(vmap(mon.aggregate_repeats))(t(fit)),
                   jax.vmap(jax.vmap(jmon.aggregate_repeats))(jnp.asarray(fit)))
    final = (1, torch.mean)
    got = _port_repeat_lanes(mon.aggregate_repeats, final, t(fit))
    want = _jax_repeat_lanes(jmon.aggregate_repeats, (1, jnp.mean), jnp.asarray(fit))
    bits_equal(got, want)
    bits_equal(got, fit)


def test_reduce_axis_takes_axis_reducers_and_one_d_reducers_as_jax():
    """``fn(arr, axis=...)``, else ``fn`` on every 1-D slice along the axis
    (maxima: exact in both frameworks; a mean over a row is rounded
    differently by XLA and torch, which multiplies by ``1/n``)."""
    arr = np.random.default_rng(5).normal(size=(3, 4, 5)).astype(np.float32)
    for axis in (0, 1, 2):
        with jax.disable_jit():
            bits_equal(tmonitor._reduce_axis(torch.amax, t(arr), axis), jmonitor._reduce_axis(jnp.max, jnp.asarray(arr), axis))
            bits_equal(tmonitor._reduce_axis(lambda v: torch.amax(v), t(arr), axis),
                       jmonitor._reduce_axis(lambda v: jnp.max(v), jnp.asarray(arr), axis))
    # A 1-D array: a 0-dim result.
    bits_equal(tmonitor._reduce_axis(lambda v: torch.amax(v), t(arr[0, 0]), 0), np.float32(arr[0, 0].max()))


# ---------------------------------------------------------------------------
# (b) The draw-free nest against JAX's
# ---------------------------------------------------------------------------

POP, DIM = 6, 2
GRID = (np.arange(POP * DIM, dtype=np.float32).reshape(POP, DIM) / 7.0 - 0.8).astype(np.float32)
HP0 = np.asarray([0.75, 0.5], np.float32)


class JSweep(JAlgorithm):
    """Test-only inner algorithm (JAX): ``pop <- pop * hp[0] + (grid -
    phase) * hp[1]``; ``phase`` is the one value drawn (in setup)."""

    def __init__(self):
        self.pop_size, self.grid = POP, jnp.asarray(GRID)

    def setup(self, key):
        return JState(key=key, hp=JParameter(jnp.asarray(HP0)), phase=jax.random.uniform(key, (DIM,), jnp.float32),
                      pop=jnp.zeros((POP, DIM), jnp.float32), fit=jnp.full((POP,), jnp.inf, jnp.float32))

    def step(self, state, evaluate):
        pop = state.pop * state.hp[0] + (self.grid - state.phase) * state.hp[1]
        return state.replace(pop=pop, fit=evaluate(pop))


class Sweep(Algorithm):
    """:class:`JSweep` in the port."""

    def __init__(self):
        self.pop_size, self.grid = POP, t(GRID)

    def setup(self, key):
        return State(key=key, hp=Parameter(t(HP0)), phase=rng.uniform(rng.child(key), (DIM,), torch.float32, key.device),
                     pop=torch.zeros((POP, DIM)), fit=torch.full((POP,), float("inf")))

    def step(self, state, evaluate):
        pop = state.pop * state.hp[0] + (self.grid - state.phase) * state.hp[1]
        return state.replace(pop=pop, fit=evaluate(pop))


def _nests(prng, repeats, aggregation, iterations, candidates=4, telemetry=True, base_uid=0):
    kw = dict(num_repeats=repeats, aggregation=aggregation, prng=prng, telemetry=telemetry, base_uid=base_uid)
    jn = JNestedProblem(JWorkflow(JSweep(), JSphere(), monitor=JHPOFitnessMonitor()), iterations, candidates, **kw)
    tn = NestedProblem(StdWorkflow(Sweep(), Sphere(), monitor=HPOFitnessMonitor()), iterations, candidates, **kw)
    return jn, tn


def _with_jax_phase(ts, js):
    """The port's nest state with JAX's per-lane phase (the one drawn
    value), so both lanes' runs see the same numbers."""
    phase = t(np.asarray(js.instances.algorithm.phase))
    return ts.replace(instances=ts.instances.replace(algorithm=ts.instances.algorithm.replace(phase=phase)))


def _hp(candidates, seed=0):
    return (np.random.default_rng(seed).random((candidates, 2)) * 0.9).astype(np.float32)


def _structure(tree):
    """{path: (shape, dtype name)} of a JAX or port telemetry tree."""
    out = {}
    for k, v in tree.items():
        out[k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


NEST_CASES = [(p, r, a) for p in ("uid", "split") for r, a in ((1, "per_generation"), (3, "per_generation"), (3, "final"))]


@pytest.mark.parametrize("iterations", [6, 2])
@pytest.mark.parametrize("prng,repeats,aggregation", NEST_CASES)
def test_draw_free_nest_matches_jax(prng, repeats, aggregation, iterations):
    """One evaluation of the nest: fitness and telemetry (best_fitness,
    executed, stopped) bit for bit against JAX's, from the same per-lane
    phases, and the setup's zero telemetry of JAX's structure."""
    jn, tn = _nests(prng, repeats, aggregation, iterations)
    js, ts = jn.setup(jax.random.key(1)), tn.setup(rng.key(1))
    assert _structure(ts.telemetry) == _structure(js.telemetry)
    for k in ts.telemetry:
        assert not ts.telemetry[k].any(), k
    ts = _with_jax_phase(ts, js)
    hp = _hp(4)
    with jax.disable_jit():
        jfit, js2 = jn.evaluate(js, {"algorithm.hp": jnp.asarray(hp)})
    tfit, ts2 = tn.evaluate(ts, {"algorithm.hp": t(hp)})
    bits_equal(tfit, jfit, "fitness")
    assert set(ts2.telemetry.keys()) == set(js2.telemetry.keys())
    for k in js2.telemetry:
        bits_equal(ts2.telemetry[k], js2.telemetry[k], k)
    # The lanes differ (the phases do), and the inner states are consumed:
    # the instances are the setup's.
    assert len(set(tfit.tolist())) == 4
    same_tree(ts2.instances, ts.instances, "instances after an evaluation")


@pytest.mark.parametrize("prng,repeats", [(p, r) for p in ("uid", "split") for r in (1, 3)])
def test_setup_structure_and_params_match_jax(prng, repeats):
    """The port's own setup: every instance leaf of JAX's shape and dtype
    (keys: JAX's key data (2,) uint32, the port's (2,) int64), the uids'
    values, and the tunable parameters."""
    jn, tn = _nests(prng, repeats, "per_generation", 5)
    js, ts = jn.setup(jax.random.key(2)), tn.setup(rng.key(2))
    jl = jax.tree_util.tree_flatten_with_path(js.instances)[0]
    tl = list(_leaves_with_path(ts.instances))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [f"['{n.replace('/', chr(39) + '][' + chr(39))}']" for n, _ in tl]
    for (path, jleaf), (name, tleaf) in zip(jl, tl):
        if name.endswith("key"):
            assert tuple(tleaf.shape) == tuple(jax.random.key_data(jleaf).shape) and tleaf.dtype == torch.int64
        else:
            assert tuple(tleaf.shape) == tuple(jleaf.shape) and str(tleaf.dtype).split(".")[-1] == str(jleaf.dtype), name
    bits_equal(ts.uids, np.asarray(js.uids).astype(np.int64))
    assert ts.uids.dtype == torch.int64
    tp, jp = tn.get_init_params(ts), jn.get_init_params(js)
    assert tp.keys() == jp.keys() == {"algorithm.hp"}
    bits_equal(tp["algorithm.hp"], jp["algorithm.hp"])
    assert tn.get_params_keys(ts) == jn.get_params_keys(js)
    assert tn.inner_pop == jn.inner_pop == POP
    assert tn.inner_generations_per_eval() == jn.inner_generations_per_eval()


# ---------------------------------------------------------------------------
# (c) Vmap against solo
# ---------------------------------------------------------------------------


def _solo_run(wf, key, hp, iterations):
    """One candidate's inner run, solo: its fitness and its best-fitness
    series."""
    ws = set_params(wf.setup(key), hp)
    ws = wf.init_step(ws)
    series = []
    for _ in range(iterations - 2):
        ws = wf.step(ws)
        series.append(torch.amin(ws.algorithm.fit))
    ws = wf.final_step(ws)
    return wf.monitor.tell_fitness(ws.monitor), torch.stack(series)


def test_vmapped_openes_candidates_equal_their_solo_runs():
    """``prng="uid"``: candidate i of a vmapped evaluation equals the solo
    run of the inner workflow from ``rng.fold_in(key, uid_i)`` with its own
    learning rate and noise, bit for bit."""
    inner = StdWorkflow(algorithms.OpenES(32, torch.zeros(6), 0.05, 0.1, device=CPU), Sphere(),
                        monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=6, num_candidates=5, base_uid=3)
    key = rng.key(9)
    state = nested.setup(key)
    hp = {"algorithm.lr": torch.linspace(0.01, 0.3, 5), "algorithm.noise_stdev": torch.linspace(0.3, 0.02, 5)}
    fit, state = nested.evaluate(state, hp)
    for i in range(5):
        uid = state.uids[i]
        assert int(uid) == 3 + i
        f, series = _solo_run(inner, rng.fold_in(key, uid), {k: v[i] for k, v in hp.items()}, 6)
        assert torch.equal(fit[i], f), i
        assert torch.equal(state.telemetry.best_fitness[i], series), i
    assert len(set(fit.tolist())) == 5


def test_vmapped_pso_candidates_with_their_own_scalars_equal_their_solo_runs():
    """The README quick start's inner PSO under ``HPOProblemWrapper``
    (``prng="split"``): each candidate moves with its own ``w``, ``phi_p``,
    ``phi_g`` (the batched move's per-instance scalars) and equals its solo
    run from ``split_keys(key, n)[i]``, bit for bit."""
    inner = StdWorkflow(algorithms.PSO(12, -10 * torch.ones(4), 10 * torch.ones(4), device=CPU), Sphere(),
                        monitor=HPOFitnessMonitor())
    hpo = HPOProblemWrapper(iterations=7, num_instances=4, workflow=inner)
    key = rng.key(5)
    state = hpo.setup(key)
    scal = torch.tensor([[0.2, 0.5, 0.5], [0.9, 2.0, 0.1], [0.5, 1.0, 3.0], [0.7, 2.5, 0.8]])
    hp = {"algorithm.w": scal[:, 0], "algorithm.phi_p": scal[:, 1], "algorithm.phi_g": scal[:, 2]}
    fit, _ = hpo.evaluate(state, hp)
    keys = rng.split_keys(key, 4)
    for i in range(4):
        f, _ = _solo_run(inner, keys[i], {k: v[i] for k, v in hp.items()}, 7)
        assert torch.equal(fit[i], f), i


def test_a_candidates_evaluation_does_not_depend_on_its_lane():
    """``prng="uid"``: candidates 2 and 3 of a 4-wide nest equal candidates
    0 and 1 of a 2-wide nest with ``base_uid=2``, given the same
    hyper-parameters: fitness and telemetry, bit for bit."""
    inner = StdWorkflow(algorithms.OpenES(16, torch.zeros(3), 0.05, 0.1, device=CPU), Sphere(),
                        monitor=HPOFitnessMonitor())
    wide = NestedProblem(inner, iterations=5, num_candidates=4)
    narrow = NestedProblem(inner, iterations=5, num_candidates=2, base_uid=2)
    hp = {"algorithm.lr": torch.tensor([0.1, 0.2, 0.05, 0.3]), "algorithm.noise_stdev": torch.tensor([0.1, 0.2, 0.3, 0.05])}
    fw, sw = wide.evaluate(wide.setup(rng.key(3)), hp)
    fn, sn = narrow.evaluate(narrow.setup(rng.key(3)), {k: v[2:] for k, v in hp.items()})
    assert torch.equal(fw[2:], fn)
    for k in sw.telemetry:
        assert torch.equal(sw.telemetry[k][2:], sn.telemetry[k]), k


# ---------------------------------------------------------------------------
# (d) The JAX package's own tests, ported (tests/test_hpo_wrapper.py,
# tests/test_hpo_workload.py)
# ---------------------------------------------------------------------------


class BasicAlgorithm(Algorithm):
    """Random search whose scale is the tunable hyper-parameter ``hp``."""

    def __init__(self, pop_size: int, lb, ub):
        self.pop_size = pop_size
        self.lb = torch.as_tensor(lb)
        self.ub = torch.as_tensor(ub)
        self.dim = self.lb.shape[0]

    def setup(self, key):
        return State(key=key, hp=Parameter(torch.tensor([1.0, 2.0])), pop=torch.zeros((self.pop_size, self.dim)),
                     fit=torch.full((self.pop_size,), float("inf")))

    def step(self, state, evaluate):
        key, (pop_seed,) = rng.split(state.key)
        pop = rng.uniform(pop_seed, (self.pop_size, self.dim), torch.float32, state.key.device)
        pop = pop * (self.ub - self.lb) + self.lb
        pop = pop * state.hp[0]
        fit = evaluate(pop)
        return state.replace(key=key, pop=pop, fit=fit)


def _make_hpo(prob, monitor, iterations=9, num_instances=7, num_repeats=1):
    algo = BasicAlgorithm(10, -10 * torch.ones(2), 10 * torch.ones(2))
    wf = StdWorkflow(algo, prob, monitor=monitor)
    return HPOProblemWrapper(iterations=iterations, num_instances=num_instances, workflow=wf, num_repeats=num_repeats)


def test_get_init_params():
    hpo = _make_hpo(Sphere(), HPOFitnessMonitor())
    state = hpo.setup(rng.key(0))
    params = hpo.get_init_params(state)
    assert "algorithm.hp" in params
    assert params["algorithm.hp"].shape == (7, 2)


def test_evaluate():
    hpo = _make_hpo(Sphere(), HPOFitnessMonitor())
    state = hpo.setup(rng.key(0))
    params = hpo.get_init_params(state)
    params["algorithm.hp"] = rng.uniform(rng.child(rng.key(0)), (7, 2), torch.float32, CPU)
    fit, _ = hpo.evaluate(state, params)
    assert fit.shape == (7,)
    assert torch.isfinite(fit).all()


def test_evaluate_mo():
    prob = DTLZ1(d=2, m=2, device=CPU)
    monitor = HPOFitnessMonitor(multi_obj_metric=lambda f: igd(f, prob.pf()))
    hpo = _make_hpo(prob, monitor)
    state = hpo.setup(rng.key(0))
    fit, _ = hpo.evaluate(state, hpo.get_init_params(state))
    assert fit.shape == (7,)
    assert torch.isfinite(fit).all()


def test_evaluate_repeats():
    hpo = _make_hpo(Sphere(), HPOFitnessMonitor(), num_repeats=3)
    state = hpo.setup(rng.key(0))
    params = hpo.get_init_params(state)
    assert params["algorithm.hp"].shape == (7, 2)
    fit, _ = hpo.evaluate(state, params)
    assert fit.shape == (7,)
    assert torch.isfinite(fit).all()


class RecordingMonitor(Monitor):
    """Test-only monitor that records every generation's raw fitness into a
    fixed-shape history buffer (works under vmap)."""

    def __init__(self, iterations: int, pop_size: int):
        self.iterations = iterations
        self.pop_size = pop_size

    def setup(self, key):
        return State(gen=torch.zeros((), dtype=torch.int64, device=key.device),
                     hist=torch.full((self.iterations, self.pop_size), float("nan"), device=key.device))

    def pre_tell(self, state, fitness):
        rows = torch.arange(self.iterations, device=fitness.device)[:, None]
        return state.replace(gen=state.gen + 1, hist=torch.where(rows == state.gen, fitness[None, :], state.hist))


def test_repeats_per_generation_semantics():
    """The ``num_repeats`` contract: each repeat lane's *algorithm* adapts on
    its own raw fitness (JaDE: adaptive F/CR, so lanes diverge), while the
    monitor aggregates fitness across repeats *within every generation*
    (mean) before taking the min over the population and the running best.
    Oracle: the same lanes with a recording monitor, folded the same way."""
    iterations, num_instances, num_repeats, pop = 6, 3, 4, 8
    lb, ub = -10 * torch.ones(2), 10 * torch.ones(2)

    def build(monitor):
        return StdWorkflow(algorithms.JaDE(pop, lb, ub, device=CPU), Sphere(), monitor=monitor)

    key = rng.key(0)
    hpo = HPOProblemWrapper(iterations=iterations, num_instances=num_instances, workflow=build(HPOFitnessMonitor()),
                            num_repeats=num_repeats, aggregation="per_generation")
    state = hpo.setup(key)
    fit, _ = hpo.evaluate(state, hpo.get_init_params(state))

    wf = build(RecordingMonitor(iterations, pop))
    keys = torch.stack(rng.split_keys(key, num_instances * num_repeats))
    stacked = vmap(wf.setup)(keys)
    leaves, spec = graph.flatten(stacked)
    stacked = graph.unflatten(spec, [x.reshape((num_instances, num_repeats) + x.shape[1:]) for x in leaves])

    def run_one(ws):
        ws = wf.init_step(ws)
        for _ in range(iterations - 2):
            ws = wf.step(ws)
        return wf.final_step(ws)

    final = vmap(vmap(run_one))(stacked)
    hist = final.monitor.hist  # (instances, repeats, iterations, pop)
    assert not hist.isnan().any()
    per_gen_mean = hist.mean(dim=1)
    expected = per_gen_mean.amin(dim=(1, 2))
    torch.testing.assert_close(fit, expected, rtol=1e-5, atol=0)

    hpo_final = HPOProblemWrapper(iterations=iterations, num_instances=num_instances,
                                  workflow=build(HPOFitnessMonitor()), num_repeats=num_repeats, aggregation="final")
    state_f = hpo_final.setup(key)
    fit_final, _ = hpo_final.evaluate(state_f, hpo_final.get_init_params(state_f))
    expected_final = hist.amin(dim=(2, 3)).mean(dim=1)
    torch.testing.assert_close(fit_final, expected_final, rtol=1e-5, atol=0)


def test_outer_workflow():
    # Full meta-optimization: PSO searches the inner algorithm's `hp`.
    # Smaller |hp[0]| shrinks the random-search envelope around 0 and thus
    # the attainable Sphere fitness: the outer optimizer must discover it.
    hpo = _make_hpo(Sphere(), HPOFitnessMonitor(), iterations=6, num_instances=8)
    outer_wf = StdWorkflow(algorithms.PSO(8, lb=0.05 * torch.ones(2), ub=3.0 * torch.ones(2), device=CPU), hpo,
                           solution_transform=lambda x: {"algorithm.hp": x})
    state = outer_wf.init_step(outer_wf.init(rng.key(0)))
    for _ in range(10):
        state = outer_wf.step(state)
    assert torch.isfinite(state.algorithm.fit).all()
    best_hp = state.algorithm.global_best_location
    assert abs(float(best_hp[0])) < 1.0, best_hp


DIM_WL = 4


def make_inner_es(pop):
    return algorithms.OpenES(pop, torch.zeros(DIM_WL), learning_rate=0.05, noise_stdev=0.1, device=CPU)


def _leaves(state):
    return {name: leaf for name, leaf in _leaves_with_path(state)}


def test_nested_prng_is_identity_keyed():
    """A candidate's inner instance is a function of (outer key, candidate
    uid) alone: invariant under the ladder width, and ``base_uid`` offsets
    the identity."""
    key = rng.key(0)
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    w = _leaves(NestedProblem(inner, iterations=4, num_candidates=4).setup(key).instances)
    n = _leaves(NestedProblem(inner, iterations=4, num_candidates=2).setup(key).instances)
    for name in w:
        assert torch.equal(w[name][:2], n[name]), name
    o = _leaves(NestedProblem(inner, iterations=4, num_candidates=2, base_uid=2).setup(key).instances)
    for name in w:
        assert torch.equal(w[name][2:4], o[name]), name


def test_nested_telemetry_series():
    """The evaluation batches each candidate's per-generation inner
    best-fitness series out as state telemetry."""
    candidates, iterations, repeats = 3, 6, 2
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=iterations, num_candidates=candidates, num_repeats=repeats)
    state = nested.setup(rng.key(0))
    assert "telemetry" in state and "uids" in state
    tel = state.telemetry
    assert tel.best_fitness.shape == (candidates, repeats, iterations - 2)
    assert (tel.best_fitness == 0.0).all()  # zeros until evaluated
    fit, state = nested.evaluate(state, nested.get_init_params(state))
    assert fit.shape == (candidates,)
    series = state.telemetry.best_fitness
    assert series.shape == (candidates, repeats, iterations - 2)
    assert torch.isfinite(series).all()
    assert state.telemetry.executed.shape == (candidates, repeats)
    assert (state.telemetry.executed == iterations - 2).all()


def test_shim_is_nested_problem():
    """The back-compat wrapper is the nest, with the split key schedule and
    the lean state."""
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    shim = HPOProblemWrapper(iterations=4, num_instances=3, workflow=inner)
    assert isinstance(shim, NestedProblem)
    assert shim.prng == "split" and shim.telemetry is False
    assert shim.num_instances == shim.num_candidates == 3
    state = shim.setup(rng.key(0))
    assert "telemetry" not in state


# ---------------------------------------------------------------------------
# (e) Refusals, and the rest of the surface
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares the errors
        return type(e), str(e)
    raise AssertionError("no error")


BAD_ARGS = {
    "iterations": dict(iterations=1),
    "num_candidates": dict(num_candidates=0),
    "num_repeats": dict(num_repeats=0),
    "aggregation": dict(aggregation="median"),
    "prng": dict(prng="threefry"),
    "base_uid": dict(base_uid=-1),
}


@pytest.mark.parametrize("arg", list(BAD_ARGS))
def test_constructor_refuses_what_jax_refuses(arg):
    kw = dict(iterations=4, num_candidates=2)
    kw.update(BAD_ARGS[arg])
    jwf = JWorkflow(JSweep(), JSphere(), monitor=JHPOFitnessMonitor())
    wf = StdWorkflow(Sweep(), Sphere(), monitor=HPOFitnessMonitor())
    assert _error(lambda: NestedProblem(wf, **kw)) == _error(lambda: JNestedProblem(jwf, **kw))


def test_constructor_refuses_a_non_hpo_monitor_and_a_workflow_without_segments():
    jgot = _error(lambda: JNestedProblem(JWorkflow(JSweep(), JSphere(), monitor=JEvalMonitor()), 4, 2))
    got = _error(lambda: NestedProblem(StdWorkflow(Sweep(), Sphere(), monitor=EvalMonitor()), 4, 2))
    assert got[0] is jgot[0] is ValueError
    assert got[1].split(", got")[0] == jgot[1].split(", got")[0] == "Expect workflow monitor to be `HPOMonitor`"
    assert "EvalMonitor" in got[1] and "EvalMonitor" in jgot[1]

    # A workflow without `_segment_program`, of one class name on both sides.
    bare, jbare = type("Bare", (), {"monitor": HPOFitnessMonitor()}), type("Bare", (), {"monitor": JHPOFitnessMonitor()})
    assert _error(lambda: NestedProblem(bare(), 4, 2)) == _error(lambda: JNestedProblem(jbare(), 4, 2))
    assert _error(lambda: HPOFitnessMonitor(multi_obj_metric=3)) == _error(lambda: JHPOFitnessMonitor(multi_obj_metric=3))
    assert _error(lambda: HPOMonitor().tell_fitness(State())) == _error(
        lambda: jmonitor.HPOMonitor().tell_fitness(JState())
    )


def test_hpo_modules_import_no_jax():
    """The HPO modules of the port name neither ``jax`` nor the JAX package
    in any import."""
    root = Path(algorithms.__file__).resolve().parent.parent
    files = sorted((root / "hpo").glob("*.py")) + [root / "problems" / "hpo_wrapper.py",
                                                    root / "problems" / "__init__.py", root / "__init__.py"]
    assert len(files) == 8  # hpo/: __init__, elastic, monitor, nested, runner
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert not (n == "jax" or n.startswith("jax.") or n.startswith("evox_tpu.") or n == "evox_tpu"), (f, n)


def test_public_names_match_jax():
    import evox_tpu
    import evox_tpu.hpo
    import evox_tpu.problems
    import evox_tpu_torch
    import evox_tpu_torch.hpo
    import evox_tpu_torch.problems

    assert set(evox_tpu_torch.problems.__all__) == set(evox_tpu.problems.__all__)
    for name in ("HPOFitnessMonitor", "HPOMonitor", "HPOProblemWrapper", "hpo_wrapper"):
        assert hasattr(evox_tpu_torch.problems, name)
    assert evox_tpu_torch.hpo is evox_tpu_torch.hpo and "hpo" in evox_tpu_torch.__all__
    assert HPO_REPEAT_AXIS == JHPO_REPEAT_AXIS
    assert set(evox_tpu_torch.hpo.__all__) == set(evox_tpu.hpo.__all__)
    for name in ("HPORunner", "GrowthLadder", "HPOGrowPolicy", "grow_evidence", "validate_ladder_window"):
        assert getattr(evox_tpu_torch.hpo, name).__module__.startswith("evox_tpu_torch.hpo.")


def test_find_nested_walks_wrapper_chains_and_candidate_series_reads_telemetry():
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=5, num_candidates=3, num_repeats=2, base_uid=7)

    class Wrapper:
        def __init__(self, problem):
            self.problem = problem

    assert find_nested(nested) is nested and find_nested(Wrapper(Wrapper(nested))) is nested
    assert find_nested(Sphere()) is None
    cyclic = Wrapper(None)
    cyclic.problem = cyclic
    assert find_nested(cyclic) is None
    state = nested.setup(rng.key(1))
    _, state = nested.evaluate(state, nested.get_init_params(state))
    series = candidate_series(state)
    assert sorted(series) == [7, 8, 9]
    want = state.telemetry.best_fitness.numpy().mean(axis=1)
    for i, uid in enumerate((7, 8, 9)):
        np.testing.assert_array_equal(series[uid], want[i])
    assert candidate_series(None) == {} and candidate_series(State(uids=state.uids)) == {}


def test_pickling_drops_graph_caches_and_the_copy_evaluates_alike():
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=4, num_candidates=2)
    nested._graphs.graphs["stale"] = object()  # stands for a captured graph
    inner._graphs.graphs["stale"] = object()
    copy = pickle.loads(pickle.dumps(nested))
    assert len(copy._graphs) == 0 and len(copy.workflow._graphs) == 0 and copy._seg_cfg is None
    assert len(nested._graphs) == 1 and len(inner._graphs) == 1  # the original keeps its caches
    s, s2 = nested.setup(rng.key(4)), copy.setup(rng.key(4))
    f, _ = nested.evaluate(s, nested.get_init_params(s))
    f2, _ = copy.evaluate(s2, copy.get_init_params(s2))
    assert torch.equal(f, f2)


def test_growth_keeps_the_configuration_precision_and_key_impl():
    from evox_tpu_torch.precision import PrecisionPolicy

    policy = PrecisionPolicy()
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor(), precision=policy, key_impl="rbg")
    nested = NestedProblem(inner, iterations=5, num_candidates=3, num_repeats=2, aggregation="final", base_uid=4)
    grown = nested.with_inner_pop(8, make_inner_es)
    assert type(grown) is NestedProblem and grown.inner_pop == 8
    assert (grown.iterations, grown.num_candidates, grown.num_repeats, grown.aggregation, grown.prng, grown.base_uid) == (
        5, 3, 2, "final", "uid", 4)
    assert grown.workflow.precision is policy and grown.workflow.key_impl == "rbg"
    assert grown.workflow.monitor is inner.monitor and grown.workflow.problem is inner.problem
    shim = HPOProblemWrapper(5, 3, inner, num_repeats=2).with_inner_pop(8, make_inner_es)
    assert type(shim) is HPOProblemWrapper and shim.prng == "split" and shim.num_instances == 3


def test_regrow_state_is_a_function_of_the_old_state_and_salt():
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=4, num_candidates=3)
    old = nested.setup(rng.key(11))
    grown = nested.with_inner_pop(8, make_inner_es)
    a, b = grown.regrow_state(old, 1), grown.regrow_state(old, 1)
    same_tree(a, b, "the same salt")
    assert torch.equal(a.uids, old.uids)
    c = grown.regrow_state(old, 2)
    assert not torch.equal(a.instances.algorithm.key, c.instances.algorithm.key)
    # The first key leaf of the old state, the candidate 0 algorithm key.
    first = old.instances.algorithm.key.reshape(-1, 2)[0]
    same_tree(a, grown.setup(rng.fold_in(first, torch.tensor(1))), "regrown from the first key")


def test_is_prng_names_port_keys_by_their_path():
    state = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor()).setup(rng.key(0))
    keys = [name for name, leaf in _leaves_with_path(state) if _is_prng(leaf, name)]
    assert keys == ["algorithm/key"]
    assert not _is_prng(state.algorithm.key)  # without a path, as before
    assert not _is_prng(torch.zeros(3, 2, dtype=torch.int64), "algorithm/pairs")


def test_a_nest_is_capturable_when_its_inner_problem_is():
    """The outer workflow's fused run on the card asks the nest's problem:
    a nest over a problem that calls the host on every evaluation is not
    capturable either (and evaluates eagerly)."""

    class HostBound(Problem):
        capturable = False

        def evaluate(self, state, pop):
            return (pop * pop).sum(-1), state

    for problem, want in ((Sphere(), True), (HostBound(), False)):
        inner = StdWorkflow(make_inner_es(4), problem, monitor=HPOFitnessMonitor())
        assert NestedProblem(inner, iterations=3, num_candidates=2).capturable is want


def test_zero_telemetry_runs_no_inner_code(monkeypatch):
    """The setup's zero telemetry is built from the state alone: a setup
    whose inner steps would fail still builds it, of the evaluated
    telemetry's structure."""
    inner = StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=5, num_candidates=2)
    with monkeypatch.context() as m:
        for which in ("init_step", "step", "final_step"):
            m.setattr(inner, which, lambda *_: (_ for _ in ()).throw(AssertionError("ran the inner program")))
        state = nested.setup(rng.key(0))
    _, evaluated = nested.evaluate(state, nested.get_init_params(state))
    assert graph.structure(evaluated.telemetry) == graph.structure(state.telemetry)


# ---------------------------------------------------------------------------
# The float64 refusal on the card (checked here without one) and the CPU
# ---------------------------------------------------------------------------


def test_kernel_dtypes_are_refused_on_the_card_only():
    pso = algorithms.PSO(8, -torch.ones(3), torch.ones(3), device=CPU)
    nsga2 = algorithms.NSGA2(8, 2, torch.zeros(3), torch.ones(3), device=CPU)
    cuda = torch.device("cuda")
    with pytest.raises(TypeError, match=r"PSO on cuda computes in float64.*fused_pso_move takes float32 or bfloat16"):
        check_kernel_dtypes(pso, cuda, torch.float64)
    with pytest.raises(TypeError, match=r"fused_pso_move takes float32 or bfloat16"):
        check_kernel_dtypes(pso, cuda, torch.float16)
    with pytest.raises(TypeError, match=r"NSGA2 on cuda computes in float64.*crowding_neighbors takes float32"):
        check_kernel_dtypes(nsga2, cuda, torch.float64)
    for dtype in (torch.float32, torch.bfloat16):
        check_kernel_dtypes(pso, cuda, dtype)
    check_kernel_dtypes(nsga2, cuda, torch.float32)
    for dtype in (torch.float64, torch.float16):
        check_kernel_dtypes(pso, CPU, dtype)
        check_kernel_dtypes(nsga2, CPU, dtype)
    # Algorithms without kernels declare none.
    check_kernel_dtypes(algorithms.DE(8, -torch.ones(3), torch.ones(3), device=CPU), cuda, torch.float64)


def test_float64_compute_still_runs_on_the_cpu():
    from evox_tpu_torch.precision import PrecisionPolicy

    for algo in (algorithms.PSO(8, -torch.ones(3), torch.ones(3), device=CPU),
                 algorithms.NSGA2(8, 2, torch.zeros(3), torch.ones(3), device=CPU)):
        problem = Sphere() if isinstance(algo, algorithms.PSO) else DTLZ1(d=3, m=2, device=CPU)
        wf = StdWorkflow(algo, problem, precision=PrecisionPolicy(compute="float64"))
        state = wf.step(wf.init_step(wf.init(0)))
        assert state.algorithm.pop.dtype == torch.bfloat16 and torch.isfinite(state.algorithm.pop.float()).all()
