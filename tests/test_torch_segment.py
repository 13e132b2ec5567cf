"""Fused multi-generation runs of the port (``StdWorkflow.run`` /
``run_segment`` / ``flush_telemetry`` / ``health_metrics``,
``resilience.health.scan_state``) against the JAX package's, on the CPU.

The CPU runs the segment's generations eagerly (the plain version of the
CUDA graph replays, which ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold against it on the card).  Random streams differ
between the frameworks, so what is compared with JAX is what does not
depend on them: the health metrics of the same state (carried across with
``state_from_numpy``), the telemetry's keys, shapes, dtypes and
``sink_meta``, and where an early stop trips.  Against the port's own
stepping, states and histories must be equal bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu import core as jcore  # noqa: E402
from evox_tpu.algorithms import NSGA2 as JNSGA2  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience.health import scan_state as jscan_state  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import NSGA2, PSO  # noqa: E402
from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2, Sphere  # noqa: E402
from evox_tpu_torch.resilience import scan_state  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

N, D, M = 16, 5, 3


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


def _pair(kind, monitor=True):
    """(JAX workflow, port workflow) of one configuration, with monitors."""
    if kind == "pso":
        jmon = JEvalMonitor(full_fit_history=True) if monitor else None
        mon = EvalMonitor(full_fit_history=True) if monitor else None
        jwf = JWorkflow(JPSO(N, -jnp.ones(D), jnp.ones(D)), JSphere(), monitor=jmon)
        wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(), monitor=mon)
    else:
        jmon = JEvalMonitor(multi_obj=True) if monitor else None
        mon = EvalMonitor(multi_obj=True) if monitor else None
        jwf = JWorkflow(JNSGA2(N, M, jnp.zeros(D), jnp.ones(D)), JDTLZ2(d=D, m=M), monitor=jmon)
        wf = StdWorkflow(NSGA2(N, M, torch.zeros(D), torch.ones(D), device="cpu"), DTLZ2(d=D, m=M, device="cpu"),
                         monitor=mon)
    return jwf, wf


def _states(kind, poison=False):
    """The same state in both frameworks: JAX's after init_step and two
    steps, carried across (the port's key is made from a seed)."""
    jwf, wf = _pair(kind)
    js = jwf.init_step(jwf.init(jax.random.key(3)))
    js = jwf.step(jwf.step(js))
    if poison:
        algo = js.algorithm
        pop = algo.pop.at[0, 1].set(jnp.nan).at[2, 0].set(jnp.inf)
        fit = algo.fit.at[1].set(-jnp.inf)
        js = js.replace(algorithm=algo.replace(pop=pop, fit=fit))
    return jwf, wf, js, state_from_numpy(to_numpy(js), device="cpu")


def _same_numbers(got, want, what):
    """Counts exactly, floats to rtol 1e-6 (sums in another order)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("kind,poison", [("pso", False), ("nsga2", False), ("pso", True)])
def test_health_metrics_match_jax(kind, poison):
    jwf, wf, js, ts = _states(kind, poison)
    want = jwf.health_metrics(js)
    got = wf.health_metrics(ts)
    assert list(got) == list(want)
    for k in want:
        _same_numbers(got[k], want[k], k)
    if poison:
        assert int(got["nonfinite_state_values"]) == 3


@pytest.mark.parametrize("kind,poison", [("pso", False), ("nsga2", False), ("pso", True)])
def test_scan_state_matches_jax(kind, poison):
    """Every metric, and the per-leaf non-finite counts under the JAX
    package's leaf-path names."""
    _, _, js, ts = _states(kind, poison)
    kw = dict(diversity=True, step_size=True)
    want, got = jscan_state(js, **kw), scan_state(ts, **kw)
    assert set(got) == set(want)
    assert list(got["nonfinite"]) == list(want["nonfinite"])
    for name, count in want["nonfinite"].items():
        _same_numbers(got["nonfinite"][name], count, name)
    for k in set(want) - {"nonfinite"}:
        _same_numbers(got[k], want[k], k)
    skipped = scan_state(ts, nonfinite_skip=("monitor",))["nonfinite"]
    assert list(skipped) == [n for n in want["nonfinite"] if "monitor" not in n]


def _layout(tree):
    """Keys, shapes and dtypes of a telemetry nest, framework-neutral."""
    if isinstance(tree, (dict, jcore.State, State)):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_layout(v) for v in tree)
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("kind", ["pso", "nsga2"])
@pytest.mark.parametrize("capture", [True, False])
def test_run_segment_telemetry_matches_jax(kind, capture):
    jwf, wf, js, ts = _states(kind)
    _, jtel = jwf.run_segment(js, 4, capture_history=capture)
    _, tel = wf.run_segment(ts, 4, capture_history=capture)
    assert list(tel) == list(jtel)
    assert _layout(tel) == _layout(jtel)
    assert wf.sink_meta_pairs(tel) == jwf.sink_meta_pairs(jtel)
    assert bool(tel.stopped) is False and int(tel.executed) == int(jtel.executed) == 4


class _Poisoned(Problem):
    """Sphere whose ``at``-th evaluation (counting from 0) is NaN."""

    def __init__(self, at):
        self.at = at

    def setup(self, key):
        return State(evals=torch.tensor(0, dtype=torch.int32))

    def evaluate(self, state, pop):
        fit = torch.sum(pop * pop, dim=1)
        fit = torch.where(state.evals == self.at, torch.full_like(fit, float("nan")), fit)
        return fit, state.replace(evals=state.evals + 1)


class _JPoisoned(jcore.Problem):
    def __init__(self, at):
        self.at = at

    def setup(self, key):
        return jcore.State(evals=jnp.int32(0))

    def evaluate(self, state, pop):
        fit = jnp.sum(pop * pop, axis=1)
        fit = jnp.where(state.evals == self.at, jnp.nan, fit)
        return fit, state.replace(evals=state.evals + 1)


@pytest.mark.parametrize("at", [2, 4, 20])
def test_stop_on_unhealthy_matches_jax(at):
    """A problem that poisons its ``at``-th evaluation (quarantine off): the
    segment stops where JAX's does, and its state is the port's own
    stepping up to that generation, bit for bit."""
    jwf = JWorkflow(JPSO(N, -jnp.ones(D), jnp.ones(D)), _JPoisoned(at), monitor=JEvalMonitor(),
                    quarantine_nonfinite=False)
    wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), _Poisoned(at),
                     monitor=EvalMonitor(), quarantine_nonfinite=False)
    js = jwf.init_step(jwf.init(jax.random.key(0)))
    _, jtel = jwf.run_segment(js, 8, stop_on_unhealthy=True)
    ts = wf.init_step(wf.init(1))
    final, tel = wf.run_segment(ts, 8, stop_on_unhealthy=True)
    assert (bool(tel.stopped), int(tel.executed)) == (bool(jtel.stopped), int(jtel.executed))
    assert _layout({k: v for k, v in tel.items() if k != "sinks"}) == \
        _layout({k: v for k, v in jtel.items() if k != "sinks"})
    # Rows past the stop are zeros, as JAX's frozen generations report.
    assert not bool(tel.best_fitness[int(tel.executed):].any())
    wf.flush_telemetry(tel)
    assert len(wf.monitor.fitness_history) == 1 + int(tel.executed)
    want = ts
    for _ in range(int(tel.executed)):
        want = wf.step(want)
    _same_state(final, want)


def _same_state(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(x, y) or torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
            torch.nan_to_num(x), torch.nan_to_num(y))


@pytest.mark.parametrize("kind", ["pso", "nsga2"])
def test_segment_and_run_equal_steps_and_history(kind):
    """run_segment + flush_telemetry and run leave the state and the
    history that stepping leaves, entry for entry, on the same device."""
    _, wf_a = _pair(kind)
    _, wf_b = _pair(kind)
    _, wf_c = _pair(kind)
    sa = wf_a.init_step(wf_a.init(5))
    sb = wf_b.init_step(wf_b.init(5))
    for _ in range(6):
        sa = wf_a.step(sa)
    sb, tel = wf_b.run_segment(sb, 6)
    _same_state(sb, sa)
    assert len(wf_b.monitor.fitness_history) == 1  # until the flush
    wf_b.flush_telemetry(tel)
    sc = wf_c.run(wf_c.init(5), 7, unroll=3)
    _same_state(sc, sa)
    for wf in (wf_b, wf_c):
        hist = wf.monitor._history
        ref = wf_a.monitor._history
        for t in ref:
            assert len(hist[t]) == len(ref[t])
            # Entries are (generation, instance, slot, data).
            for (gx, ix, sx, x), (gy, iy, sy, y) in zip(hist[t], ref[t]):
                assert (int(gx), int(ix), sx) == (int(gy), int(iy), sy)
                assert x.device == y.device and torch.equal(x, y)


def test_segment_refusals_and_not_ported_options():
    _, wf = _pair("pso")
    s = wf.init(0)
    with pytest.raises(ValueError, match="init_step"):
        wf.run_segment(s, 2)  # the monitor's top-k appears in the first generation
    s = wf.init_step(s)
    # flight=True is ported (obs/flight.py): the signals ride as outputs and
    # the state is the flight-off segment's bit for bit.
    s_flight, tel = wf.run_segment(s, 2, flight=True)
    s_plain, _ = wf.run_segment(s, 2)
    _same_state(s_flight, s_plain)
    assert tel.flight["best_fitness"].shape == (2,) and "_pop_sumsq" in tel.flight
    # frozen= is ported (the service's lane freeze): a frozen segment keeps
    # its state and executes nothing; a thawed one equals the plain segment.
    s_frozen, tel = wf.run_segment(s, 2, frozen=torch.tensor(True))
    _same_state(s_frozen, s)
    assert int(tel.executed) == 0 and bool(tel.stopped)
    s_thawed, tel = wf.run_segment(s, 2, frozen=False)
    _same_state(s_thawed, s_plain)
    assert int(tel.executed) == 2 and not bool(tel.stopped)

    # The per-shard metrics are ported (parallel/): a probe's shards reach
    # the segment's metrics, and scan_state takes shards=.
    class Probe:
        shards = 4

    _, tel = wf.run_segment(s, 2, health=Probe())
    assert tel.metrics["shard_rows"].sum() == s.algorithm.fit.shape[0]
    assert scan_state(s, shards=2)["shard_nonfinite"].tolist() == [0, 0]
    with pytest.raises(ValueError):
        wf.run_segment(s, 0)
    # barrier is accepted and changes nothing.
    a, _ = wf.run_segment(s, 2, barrier=False)
    b, _ = wf.run_segment(s, 2)
    _same_state(a, b)


def test_health_config_sets_the_early_stop_floors():
    class Probe:
        check_nonfinite = True
        nonfinite_skip = ("monitor",)
        diversity_floor = 1e9  # every state is "collapsed"
        step_size_range = None

    _, wf = _pair("pso")
    cfg = wf.segment_config(health=Probe(), stop_on_unhealthy=True)
    assert cfg.diversity and not cfg.step_size and cfg.diversity_floor == 1e9
    s = wf.init_step(wf.init(0))
    final, tel = wf.run_segment(s, 5, health=Probe(), stop_on_unhealthy=True)
    assert bool(tel.stopped) and int(tel.executed) == 1
    _same_state(final, wf.step(s))
    assert set(tel.metrics) == {"nonfinite", "diversity", "best_fitness"}
    assert not any("monitor" in k for k in tel.metrics["nonfinite"])


def test_graph_tree_roundtrip():
    tree = (State(a=torch.ones(2), b={"c": torch.zeros(3), "d": None}, _param_keys=frozenset({"a"})),
            [torch.arange(3), 7])
    leaves, spec = graph.flatten(tree)
    assert len(leaves) == 3
    back = graph.unflatten(spec, leaves)
    assert back[0].param_keys == frozenset({"a"}) and back[1][1] == 7 and back[0].b["d"] is None
    assert graph.structure(back) == graph.structure(tree)


@pytest.mark.parametrize("kind", ["pso", "nsga2"])
def test_segment_keeps_no_earlier_generation_alive(kind):
    """A segment's generations free the state they replace as stepping
    does, with the cycle collector off: a capture on the card records what
    the program holds, so a leaked generation would grow its memory pool
    with every generation."""
    import gc
    import weakref

    _, wf = _pair(kind, monitor=False)
    s = wf.step(wf.init_step(wf.init(0)))
    seen = []
    step = wf._step

    def spy(state, which):
        new = step(state, which)
        seen.append(weakref.ref(new.algorithm.pop))
        return new

    wf._step = spy
    gc.disable()
    try:
        final, _ = wf.run_segment(s, 5)
        alive = [r() is not None for r in seen]
    finally:
        gc.enable()
    assert alive == [False] * 4 + [True]
    del final


def test_early_stop_scans_only_what_it_reads(monkeypatch):
    """Without health thresholds the per-generation predicate counts
    non-finite values only; the end-of-segment metrics keep the full set."""
    from evox_tpu_torch.workflows import std_workflow

    calls = []

    def recording(state, **kw):
        calls.append((kw["diversity"], kw["step_size"]))
        return scan_state(state, **kw)

    monkeypatch.setattr(std_workflow, "scan_state", recording)
    _, wf = _pair("pso")
    s = wf.init_step(wf.init(0))
    _, tel = wf.run_segment(s, 3, stop_on_unhealthy=True)
    assert calls == [(False, False)] * 3 + [(True, True)]
    assert {"diversity", "nonfinite"} <= set(tel.metrics)


def test_graph_cache_keeps_the_last_captures():
    """At most MAX_GRAPHS captures, the least recently added dropped first,
    and the static buffers of a structure go with its last capture."""

    class Fake:
        def __init__(self, struct):
            self.struct = struct

    cache = graph.Cache()
    for struct, n in [("a", 1)] + [("b", n) for n in range(graph.MAX_GRAPHS)]:
        cache.inputs.setdefault(struct, [torch.zeros(1)])  # as run() makes them
        cache._add(("k", struct, n), Fake(struct))
    assert len(cache) == graph.MAX_GRAPHS
    assert all(c.struct == "b" for c in cache.graphs.values())
    assert list(cache.inputs) == ["b"]
