"""The port's resilient runner (``evox_tpu_torch/resilience/runner.py``),
health probe and restart policies against the JAX package's, and the JAX
package's runner tests mirrored for the port's bit-equality claims.

Against the JAX package (the two packages draw different random numbers,
so a whole run is compared by what the supervisor does, not by values):

* one ``FaultyProblem`` schedule (NaN rows, a retried backend error, a
  state corruption the probe catches, a rollback) through both runners
  gives the same sequence of events at the same generations, the same
  ``RunStats`` counters and restart lineage, the same checkpoint file
  names and the same ``evox_runner_*`` counters; a bit-flipped newest
  checkpoint is then quarantined and resumed past by both;
* ``HealthProbe`` verdicts on the same states (thresholds and messages;
  the spreads within ``SPREAD_RTOL``);
* ``RollbackToCheckpoint`` on the same checkpoints, ``incumbent_best``,
  and ``PerturbAroundBest`` with the JAX package's normal draws injected
  through its ``_normal`` seam (bit for bit);
* ``EvalMonitor.record_restart`` / ``record_preemption`` /
  ``truncate_history``.

The port alone (the JAX package's ``test_resilience.py``,
``test_health_restart.py``, ``test_preemption.py`` and
``test_fused_segment.py`` claims): the runner's final state equals
``workflow.run`` and eager steps bit for bit, fused or not; kill and
resume, a retried error, a watchdog trip and a real SIGTERM under an
installed guard each end bit-equal to the clean run; a torn newest
checkpoint is quarantined; the CPU fallback counts and renews the budget;
the flight recorder feeds on the segments and dumps on a restart.

Sizes: PSO 32 x 8, segments of 5, backoff 1 ms, watchdogs 0.4 s."""

import json
import os
import pickle
import signal
import threading
import warnings

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from evox_tpu import obs as jobs  # noqa: E402
from evox_tpu import resilience as jr  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.problems.numerical import Ackley as JAckley  # noqa: E402
from evox_tpu.utils import checkpoint as jckpt  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch import obs  # noqa: E402
from evox_tpu_torch import resilience as pr  # noqa: E402
from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import State  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley  # noqa: E402
from evox_tpu_torch.resilience import (  # noqa: E402
    FaultyProblem,
    FaultyStore,
    HealthProbe,
    PerturbAroundBest,
    Preempted,
    PreemptionGuard,
    ReinitLargerPopulation,
    ResilienceError,
    ResilientRunner,
    RetryPolicy,
    RollbackToCheckpoint,
)
from evox_tpu_torch.utils import graph, read_manifest, save_state  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

POP, DIM, CHUNK = 32, 8, 5
FAST = dict(backoff_base=0.001, backoff_factor=1.0)
# Relative tolerance of a spread (a std over 32 rows) computed in another
# reduction order than the JAX package's.
SPREAD_RTOL = 1e-5


def _wf(problem=None, pop=POP, monitor=True, **kw):
    return StdWorkflow(
        PSO(pop, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"),
        problem if problem is not None else Ackley(),
        monitor=EvalMonitor() if monitor else None,
        **kw,
    )


def _jwf(problem=None):
    return JStdWorkflow(
        JPSO(POP, -32.0 * jnp.ones(DIM), 32.0 * jnp.ones(DIM)),
        problem if problem is not None else JAckley(),
        monitor=JEvalMonitor(),
    )


def _same(a, b, skip=()):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    names = [n for n, _ in pr.health._leaves_with_path(a)]
    for name, x, y in zip(names, la, lb):
        if name in skip:
            continue
        assert x.dtype == y.dtype and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)), name
        if x.is_floating_point():
            assert torch.equal(x.isnan(), y.isnan()), name


# ---------------------------------------------------------------------------
# the whole runner against the JAX package's
# ---------------------------------------------------------------------------

PLAN = dict(nan_generations=(2,), nan_rows=3, error_generations=(7,), corrupt_generations=(15,))


def _supervise(pkg, directory, n_steps, fresh):
    if pkg == "jax":
        wf, R = _jwf(jr.FaultyProblem(JAckley(), **PLAN)), jr
        state = wf.init(jax.random.key(0))
        plane = jobs.Observability(registry=jobs.MetricsRegistry(), run_id="parity")
    else:
        wf, R = _wf(FaultyProblem(Ackley(), **PLAN)), pr
        state = wf.init(0)
        plane = obs.Observability(registry=obs.MetricsRegistry(), run_id="parity")
    runner = R.ResilientRunner(
        wf,
        directory,
        checkpoint_every=CHUNK,
        keep_checkpoints=0,
        async_checkpoints=False,
        retry=R.RetryPolicy(**FAST),
        health=R.HealthProbe(),
        restart=R.RollbackToCheckpoint(),
        obs=plane,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(state, n_steps, fresh=fresh)
    events = [
        (e.category, e.severity, e.payload.get("generation"), e.message.split(" (")[0].split(":")[0])
        for e in plane.ring.events()
    ]
    s = runner.stats
    stats = dict(
        completed=s.completed_generations, resumed=s.resumed_from_generation, segments=s.segments_run,
        retries=s.retries, watchdog=s.watchdog_timeouts, cpu_fallbacks=s.cpu_fallbacks,
        written=s.checkpoints_written, health_checks=s.health_checks, unhealthy=s.unhealthy_probes,
        restarts=[e.to_manifest() for e in s.restarts], chunks=s.chunk_sizes, early_stops=s.early_stops,
        skips=[(os.path.basename(k.path), k.quarantined) for k in s.checkpoint_skips], failures=len(s.failures),
        write_failures=s.checkpoint_write_failures, preempted=s.preempted,
    )
    counters = {
        k: v for k, v in plane.registry.snapshot().items()
        if (k.startswith("evox_runner_") and k.endswith("_total") and "block_seconds" not in k
            and "compiles" not in k) or k.startswith("evox_monitor_")
    }
    return events, stats, sorted(os.listdir(directory)), counters


def test_whole_runner_matches_the_jax_packages_supervision(tmp_path):
    mine = _supervise("torch", tmp_path / "p", 20, fresh=True)
    theirs = _supervise("jax", tmp_path / "j", 20, fresh=True)
    assert mine[0] == theirs[0]
    assert mine[1] == theirs[1]
    assert mine[2] == theirs[2] == [f"ckpt_{g:08d}.npz" for g in (1, 6, 11, 16, 20)]
    assert mine[3] == theirs[3]
    assert mine[1]["restarts"][0]["detail"] == {"rolled_back_to": 11} and mine[1]["retries"] == 1
    assert mine[3]['evox_monitor_num_nonfinite{run_id="parity"}'] == 3.0

    # A bit-flipped newest checkpoint: both quarantine it and resume from
    # the one before.
    for d in ("p", "j"):
        path = tmp_path / d / "ckpt_00000020.npz"
        data = bytearray(path.read_bytes())
        data[len(data) // 3] ^= 0x01
        path.write_bytes(bytes(data))
    mine = _supervise("torch", tmp_path / "p", 25, fresh=False)
    theirs = _supervise("jax", tmp_path / "j", 25, fresh=False)
    assert mine[0] == theirs[0] and mine[1] == theirs[1] and mine[2] == theirs[2] and mine[3] == theirs[3]
    assert mine[1]["skips"] == [("ckpt_00000020.npz", True)] and mine[1]["resumed"] == 16
    assert "ckpt_00000020.npz.corrupt" in mine[2]


# ---------------------------------------------------------------------------
# the probe and the restart policies against the JAX package's
# ---------------------------------------------------------------------------


def _probe_tree(kind, seed=0):
    g = np.random.default_rng(seed)
    pop = g.standard_normal((32, 8)).astype(np.float32)
    fit = (g.standard_normal(32) ** 2).astype(np.float32)
    algo = {"pop": pop, "fit": fit, "velocity": np.zeros_like(pop)}
    mon = {"topk_fitness": np.sort(fit)[:1], "topk_solutions": pop[:1].copy(), "num_nonfinite": np.int32(0)}
    if kind == "nan_pop":
        algo["pop"][3, 2] = np.nan
        algo["fit"][5] = np.inf
    elif kind == "collapsed":
        algo["pop"] = np.ones_like(pop) + 1e-9 * pop
    elif kind == "sigma_low":
        algo["sigma"] = np.full(8, 1e-14, np.float32)
    elif kind == "sigma_nan":
        algo["sigma"] = np.array([1.0, np.nan], np.float32)
    elif kind == "dead_shard":
        algo["fit"][8:16] = np.nan
        mon.pop("topk_fitness")
        mon.pop("topk_solutions")
    return {"algorithm": algo, "monitor": mon}


def _both(tree):
    def port(node):
        return State(**{k: port(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in node.items()})

    def jax_(node):
        return JState(**{k: jax_(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in node.items()})

    return port(tree), jax_(tree)


def _report(r):
    """A report's fields but the spreads, NaN-aware (as JSON text)."""
    d = dict(vars(r))
    for k in ("diversity", "shard_diversity"):
        d.pop(k)
    return json.dumps(d, sort_keys=True)


PROBES = [
    dict(),
    dict(diversity_floor=1e-3),
    dict(diversity_floor=1e-3, shards=4),
    dict(step_size_range=(1e-12, 1e6), nonfinite_skip=("fit",)),
    dict(stagnation_window=2, stagnation_tol=1e-3, check_nonfinite=False),
    dict(shards=4, step_size_range=None),
]


@pytest.mark.parametrize("kind", ["clean", "nan_pop", "collapsed", "sigma_low", "sigma_nan", "dead_shard"])
@pytest.mark.parametrize("cfg", PROBES, ids=[",".join(c) or "default" for c in PROBES])
def test_health_probe_verdicts_equal_the_jax_packages(kind, cfg):
    mine, theirs = HealthProbe(**cfg), jr.HealthProbe(**cfg)
    for gen, seed in ((5, 0), (10, 0), (15, 1)):
        p, j = _both(_probe_tree(kind, seed))
        a, b = mine.check(p, generation=gen), theirs.check(j, generation=gen)
        assert _report(a) == _report(b)
        for x, y in ((a.diversity, b.diversity),):
            assert (x is None) == (y is None)
            assert x is None or x == pytest.approx(y, rel=SPREAD_RTOL, nan_ok=True)
        if a.shard_diversity is not None:
            assert a.shard_diversity == pytest.approx(b.shard_diversity, rel=SPREAD_RTOL, nan_ok=True)
    assert json.dumps(mine.window) == json.dumps(theirs.window)


def test_probe_validation_and_window_restore_equal_the_jax_packages():
    for bad in (dict(stagnation_window=1), dict(stagnation_window=-1), dict(step_size_range=(2, 1)), dict(shards=0)):
        with pytest.raises(ValueError) as a:
            HealthProbe(**bad)
        with pytest.raises(ValueError) as b:
            jr.HealthProbe(**bad)
        assert str(a.value) == str(b.value)
    p, j = HealthProbe(stagnation_window=3), jr.HealthProbe(stagnation_window=3)
    p.restore([5, 4, 3, 2])
    j.restore([5, 4, 3, 2])
    assert p.window == j.window == (4.0, 3.0, 2.0)
    r = p.check(State(algorithm=State(fit=torch.tensor([1.5, 2.0]))), 1).with_trend(["trend"])
    assert not r.healthy and r.trend and r.reasons[-1] == "trend"


class _Ctx:
    """The part of a runner a restart policy reads."""

    def __init__(self, directory):
        self.checkpoint_dir = directory
        self.verify_resume = True
        self.events = []

    def _event(self, msg, warn=False):
        self.events.append(msg)

    def _rebind_workflow(self):
        pass


def _pso_tree(seed):
    g = np.random.default_rng(seed)
    pop = g.uniform(-32, 32, (POP, DIM)).astype(np.float32)
    fit = g.uniform(0, 20, POP).astype(np.float32)
    return {
        "algorithm": {"pop": pop, "fit": fit, "velocity": g.standard_normal((POP, DIM)).astype(np.float32),
                      "local_best_location": pop.copy(), "local_best_fit": fit.copy()},
        "monitor": {"topk_fitness": np.array([0.5], np.float32), "topk_solutions": pop[4:5].copy(),
                    "num_restarts": np.int32(0)},
    }


def _with_keys(tree):
    p, j = _both(tree)
    p = p.replace(algorithm=p.algorithm.replace(key=torch.tensor([11, 0])))
    j = j.replace(algorithm=j.algorithm.replace(key=jax.random.key(11)))
    return p, j


def _non_key_leaves(state):
    if isinstance(state, JState):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
            name = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
            if not name.endswith("key"):
                out[name] = np.asarray(leaf)
        return out
    return {n: v.numpy() for n, v in pr.health._leaves_with_path(state) if not n.endswith("key")}


def test_rollback_yields_the_jax_packages_state(tmp_path):
    for d in ("p", "j"):
        (tmp_path / d).mkdir()
    for gen, seed in ((5, 1), (10, 2), (15, 3)):
        p, j = _with_keys(_pso_tree(seed))
        save_state(tmp_path / "p" / f"ckpt_{gen:08d}.npz", p, generation=gen)
        jckpt.save_state(tmp_path / "j" / f"ckpt_{gen:08d}.npz", j, generation=gen)
    p_now, j_now = _with_keys(_pso_tree(9))
    for back in (1, 2, 5):
        a = RollbackToCheckpoint(back=back).apply(pr.RestartContext(_Ctx(tmp_path / "p"), None, p_now, 20, None, 0))
        b = jr.RollbackToCheckpoint(back=back).apply(jr.RestartContext(_Ctx(tmp_path / "j"), None, j_now, 20, None, 0))
        assert a[1:] == b[1:]
        la, lb = _non_key_leaves(a[0]), _non_key_leaves(b[0])
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        assert not torch.equal(a[0].algorithm.key, p_now.algorithm.key)  # perturbed


def test_incumbent_best_and_perturb_around_best_equal_the_jax_packages():
    tree = _pso_tree(4)
    tree["algorithm"]["fit"][7] = np.nan
    p, j = _with_keys(tree)
    bp, fp = pr.incumbent_best(p)
    bj, fj = jr.incumbent_best(j)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert float(fp) == float(fj)
    # Without a monitor: the best finite row.
    p2 = p.replace(monitor=State())
    j2 = j.replace(monitor=JState())
    np.testing.assert_array_equal(pr.incumbent_best(p2)[0].numpy(), np.asarray(jr.incumbent_best(j2)[0]))

    class Algo:
        lb = -32.0 * torch.ones(DIM)
        ub = 32.0 * torch.ones(DIM)

    class JAlgo:
        lb = -32.0 * jnp.ones(DIM)
        ub = 32.0 * jnp.ones(DIM)

    class WF:
        algorithm = Algo()

    class JWF:
        algorithm = JAlgo()

    theirs = jr.PerturbAroundBest(scale=0.2).apply(jr.RestartContext(None, JWF(), j, 12, None, 2))
    # The JAX package's normals, drawn as it draws them: from the first key
    # of the perturbed state, folded with the restart index + 1.
    jkey = jax.random.fold_in(jax.random.fold_in(j.algorithm.key, 0xBE57 + 2), 3)
    drawn = np.asarray(jax.random.normal(jkey, (POP, DIM), dtype=jnp.float32))

    class Injected(PerturbAroundBest):
        def _normal(self, key, shape, dtype):
            assert tuple(shape) == (POP, DIM)
            return torch.from_numpy(drawn.copy())

    mine = Injected(scale=0.2).apply(pr.RestartContext(None, WF(), p, 12, None, 2))
    assert mine[1:] == theirs[1:]
    la, lb = _non_key_leaves(mine[0]), _non_key_leaves(theirs[0])
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    # With the port's own draws: the cloud around the best, clipped.
    own = PerturbAroundBest(scale=0.2).apply(pr.RestartContext(None, WF(), p, 12, None, 2))[0]
    assert torch.equal(own.algorithm.pop[0], bp) and own.algorithm.pop.abs().max() <= 32
    assert torch.isinf(own.algorithm.fit).all()


def test_restart_event_and_policy_validation_equal_the_jax_packages():
    ev = pr.RestartEvent(generation=4, policy="rollback", restart_index=1, reasons=["r"], detail={"x": 1})
    assert ev.to_manifest() == jr.RestartEvent(**vars(ev)).to_manifest()
    assert pr.RestartEvent.from_manifest(json.loads(json.dumps(ev.to_manifest()))) == ev
    for mine, theirs in (
        (lambda: RollbackToCheckpoint(back=0), lambda: jr.RollbackToCheckpoint(back=0)),
        (lambda: ReinitLargerPopulation(lambda n: n, growth_factor=1.0),
         lambda: jr.ReinitLargerPopulation(lambda n: n, growth_factor=1.0)),
        (lambda: ReinitLargerPopulation(lambda n: n, max_pop_size=0),
         lambda: jr.ReinitLargerPopulation(lambda n: n, max_pop_size=0)),
        (lambda: PerturbAroundBest(scale=0), lambda: jr.PerturbAroundBest(scale=0)),
    ):
        with pytest.raises(ValueError) as a:
            mine()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)
    assert ReinitLargerPopulation(lambda n: n, max_pop_size=50)._new_pop_size(32) == 50
    assert ReinitLargerPopulation(lambda n: n, growth_factor=1.01)._new_pop_size(32) == 33


def test_eval_monitor_restart_preemption_and_truncation():
    wf = _wf()
    s = wf.init_step(wf.init(0))
    for _ in range(5):
        s = wf.step(s)
    mon = wf.monitor
    m = mon.record_preemption(mon.record_restart(mon.record_restart(s.monitor)))
    assert (int(m.num_restarts), int(m.num_preemptions)) == (2, 1)
    assert mon.record_restart(State()) == State()
    assert len(mon.get_fitness_history()) == 6
    mon.truncate_history(3)
    assert len(mon.get_fitness_history()) == 3
    jm = JEvalMonitor()
    js = jm.setup(jax.random.key(0))
    assert int(jm.record_preemption(jm.record_restart(js)).num_restarts) == 1


# ---------------------------------------------------------------------------
# the port's bit-equality claims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n_steps", [1, 2, 13])
def test_runner_equals_run_and_eager_steps(tmp_path, fused, n_steps):
    wf = _wf()
    out = ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK, fused=fused).run(wf.init(0), n_steps)
    # No checkpoint-writer thread outlives the run.
    assert not [t for t in threading.enumerate() if t.name == "evox-tpu-torch-ckpt-writer"]
    ref_wf = _wf()
    _same(out, ref_wf.run(ref_wf.init(0), n_steps))
    eager = ref_wf.init_step(ref_wf.init(0))
    for _ in range(n_steps - 1):
        eager = ref_wf.step(eager)
    _same(out, eager)
    # A second call resumes at the end and does no work.
    again = ResilientRunner(_wf(), tmp_path, checkpoint_every=CHUNK)
    _same(again.run(_wf().init(0), n_steps), out)
    assert again.stats.segments_run == 0 and again.stats.resumed_from_generation == n_steps


def test_kill_and_resume_is_bit_identical(tmp_path):
    prob = FaultyProblem(Ackley(), fatal_generations=(8,))
    wf = _wf(prob)
    with pytest.raises(pr.faults.InjectedFatalError):
        ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK).run(wf.init(0), 17)
    assert pr.latest_checkpoint(tmp_path).name == "ckpt_00000006.npz"
    runner = ResilientRunner(_wf(prob), tmp_path, checkpoint_every=CHUNK)
    out = runner.run(_wf(prob).init(0), 17)
    assert runner.stats.resumed_from_generation == 6
    clean = _wf(FaultyProblem(Ackley(), fatal_generations=(8,), fatal_times=0))
    _same(out, ResilientRunner(clean, tmp_path / "c", checkpoint_every=CHUNK).run(clean.init(0), 17))


@pytest.mark.parametrize("fault", ["error", "delay"])
def test_retry_and_watchdog_end_bit_equal_to_the_clean_run(tmp_path, fault):
    schedule = (
        dict(error_generations=(7,), error_times=2)
        if fault == "error"
        else dict(delay_generations=(7,), delay_seconds=0.6, delay_times=1)
    )
    wf = _wf(FaultyProblem(Ackley(), **schedule))
    runner = ResilientRunner(
        wf, tmp_path / "f", checkpoint_every=CHUNK, retry=RetryPolicy(**FAST),
        watchdog_timeout=0.4 if fault == "delay" else None,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(wf.init(0), 16)
    s = runner.stats
    assert (s.retries, s.watchdog_timeouts) == ((2, 0) if fault == "error" else (1, 1))
    assert s.cpu_fallbacks == 0 and len(wf.monitor.get_fitness_history()) == 16
    times = "error_times" if fault == "error" else "delay_times"
    clean = _wf(FaultyProblem(Ackley(), **dict(schedule, **{times: 0})))
    _same(out, ResilientRunner(clean, tmp_path / "c", checkpoint_every=CHUNK).run(clean.init(0), 16))


def test_retry_budget_exhaustion_and_cpu_fallback(tmp_path):
    wf = _wf(FaultyProblem(Ackley(), error_generations=(3,), error_times=10))
    with pytest.raises(ResilienceError), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ResilientRunner(wf, tmp_path / "a", checkpoint_every=CHUNK,
                        retry=RetryPolicy(max_retries=1, **FAST)).run(wf.init(0), 10)
    wf = _wf(FaultyProblem(Ackley(), error_generations=(3,), error_times=2))
    runner = ResilientRunner(wf, tmp_path / "b", checkpoint_every=CHUNK, cpu_fallback=True,
                             retry=RetryPolicy(max_retries=1, **FAST))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(wf.init(0), 10)
        assert runner.stats.cpu_fallbacks == 1 and runner.stats.completed_generations == 10
        runner.run(wf.init(0), 12, fresh=True)  # a new run: fresh budget, no fallback
    assert runner.stats.cpu_fallbacks == 0


def test_torn_newest_checkpoint_is_quarantined(tmp_path):
    store = FaultyStore(torn_saves=[3])  # saves: gen 1, 6, 11, 16(torn)
    wf = _wf()
    ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK, store=store, async_checkpoints=False).run(wf.init(0), 16)
    runner = ResilientRunner(_wf(), tmp_path, checkpoint_every=CHUNK)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(_wf().init(0), 21)
    assert runner.stats.resumed_from_generation == 11
    assert [k.quarantined for k in runner.stats.checkpoint_skips] == [True]
    assert (tmp_path / "ckpt_00000016.npz.corrupt").exists()
    ref = _wf()
    _same(out, ref.run(ref.init(0), 21))


def test_sigterm_under_an_installed_guard_resumes_bit_identically(tmp_path):
    prob = FaultyProblem(Ackley(), sigterm_generations=(7,))
    wf = _wf(prob)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(Preempted) as e, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK, preemption=True).run(wf.init(0), 17)
    assert signal.getsignal(signal.SIGTERM) == previous  # the handlers are restored
    assert e.value.generation == 11 and e.value.checkpoint.name == "ckpt_00000011.npz"
    manifest = read_manifest(e.value.checkpoint)
    assert manifest["preempted"] and manifest["preemption_reason"] == "signal SIGTERM"
    runner = ResilientRunner(_wf(prob), tmp_path, checkpoint_every=CHUNK, preemption=True)
    out = runner.run(_wf(prob).init(0), 17)
    assert runner.stats.resumed_after_preemption and int(out.monitor.num_preemptions) == 1
    clean = _wf(FaultyProblem(Ackley(), sigterm_generations=(7,), sigterm_times=0))
    ref = ResilientRunner(clean, tmp_path / "c", checkpoint_every=CHUNK).run(clean.init(0), 17)
    _same(out, ref, skip=("monitor/num_preemptions",))


def test_preemption_guard_contract():
    guard = PreemptionGuard()
    with guard:
        assert guard.installed and not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.triggered and guard.reason == "signal SIGTERM"
    assert not guard.installed
    guard.reset()
    assert not guard.triggered
    hook = PreemptionGuard(provider_hook=lambda: "maintenance at 12:00")
    assert hook.triggered and hook.reason == "maintenance at 12:00"

    def broken():
        raise RuntimeError("poller down")

    bad = PreemptionGuard(provider_hook=broken)
    with pytest.warns(UserWarning, match="disabling the hook"):
        assert not bad.triggered
    assert bad.provider_hook is None


def test_emergency_write_failure_still_raises_preempted(tmp_path):
    runner = ResilientRunner(_wf(), tmp_path, checkpoint_every=CHUNK, store=FaultyStore(enospc_saves=[1]),
                             preemption=PreemptionGuard())
    runner.preemption.trip("test")
    with pytest.raises(Preempted) as e, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(_wf().init(0), 10)
    assert e.value.checkpoint is None and runner.stats.checkpoint_write_failures == 1
    assert pr.latest_checkpoint(tmp_path).name == "ckpt_00000001.npz"


def test_nan_rows_are_quarantined_inside_the_segment(tmp_path):
    wf = _wf(FaultyProblem(Ackley(), nan_generations=(2, 8), nan_rows=3, inf_generations=(9,), inf_rows=2))
    assert wf.problem.capturable
    out = ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK).run(wf.init(0), 12)
    assert int(out.monitor.num_nonfinite) == 8 and torch.isfinite(out.monitor.topk_fitness).all()


def test_restart_policies_through_the_runner(tmp_path):
    # ReinitLargerPopulation on a plateau: the population grows, the state
    # is captured anew (the graphs were dropped), the elite survives.
    wf = _wf(FaultyProblem(Ackley(), plateau_from=3, plateau_floor=50.0))
    factory = lambda n: PSO(n, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu")  # noqa: E731
    runner = ResilientRunner(
        wf, tmp_path / "r", checkpoint_every=CHUNK, health=HealthProbe(stagnation_window=2),
        restart=ReinitLargerPopulation(factory, growth_factor=2.0, max_pop_size=64), max_restarts=1,
    )
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(wf.init(0), 20)
    assert [e.policy for e in runner.stats.restarts] == ["reinit_larger_population"]
    assert out.algorithm.pop.shape == (64, DIM) and int(out.monitor.num_restarts) == 1
    # Resume replays the lineage and rebuilds the template.
    again = ResilientRunner(
        _wf(FaultyProblem(Ackley(), plateau_from=3, plateau_floor=50.0)), tmp_path / "r", checkpoint_every=CHUNK,
        health=HealthProbe(stagnation_window=2),
        restart=ReinitLargerPopulation(factory, growth_factor=2.0, max_pop_size=64), max_restarts=1,
    )
    _same(again.run(_wf().init(0), 20), out)


def test_flight_recorder_feeds_on_segments_and_dumps_on_a_restart(tmp_path):
    rec = obs.FlightRecorder(tmp_path / "pm", window=64)
    plane = obs.Observability(flight=rec, tracer=obs.Tracer())
    wf = _wf(FaultyProblem(Ackley(), corrupt_generations=(10,)))
    runner = ResilientRunner(wf, tmp_path / "ck", checkpoint_every=CHUNK, health=HealthProbe(),
                             restart=RollbackToCheckpoint(), obs=plane)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(wf.init(0), 16)
    assert [b.name.split("_", 2)[2] for b in rec.bundles] == ["restart"]
    rows = rec.rows()
    assert {"best_fitness", "pop_diversity", "velocity_norm", "num_nonfinite"} <= rows[-1].keys()
    assert rows[-1]["generation"] == 16
    names = {s.name for s in plane.tracer.spans()}
    assert {"run", "execute", "health-probe", "checkpoint-submit", "telemetry-flush"} <= names
    clean = _wf(FaultyProblem(Ackley(), corrupt_generations=(10,)))
    ref = ResilientRunner(clean, tmp_path / "c", checkpoint_every=CHUNK, health=HealthProbe(),
                          restart=RollbackToCheckpoint(), obs=False).run(clean.init(0), 16)
    _same(out, ref)


def test_fused_early_stop_freezes_a_poisoned_segment(tmp_path):
    wf = _wf(FaultyProblem(Ackley(), corrupt_generations=(7,)))
    runner = ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK, fused_early_stop=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(wf.init(0), 11)
    assert runner.stats.early_stops == 1 and runner.stats.chunk_sizes[1] == 2


def test_wall_interval_adapts_the_chunk(tmp_path):
    runner = ResilientRunner(_wf(), tmp_path, checkpoint_every=8, checkpoint_wall_interval=1e-9)
    runner._adapt_chunk(4, 1.0)
    assert runner._next_chunk() == 1
    runner.checkpoint_wall_interval = 1e6
    runner._adapt_chunk(4, 1.0)
    assert runner._next_chunk() == 8
    with pytest.raises(ValueError, match="checkpoint_wall_interval"):
        ResilientRunner(_wf(), tmp_path, checkpoint_wall_interval=0)


@pytest.mark.parametrize(
    "kw, item",
    [(dict(exec_cache=True), "13.2"), (dict(primary=True), "13.7"), (dict(heartbeat=object()), "13.7")],
)
def test_not_ported_runner_arguments_are_refused_by_name(tmp_path, kw, item):
    """The arguments once refused by name, and what each does now that its
    item is ported.  ``exec_cache`` came with the program cache (13.2): a
    second runner's segment program is a load, and its bits are the
    first's.  ``primary`` and ``heartbeat`` came with the fleet layer
    (13.7).  A non-primary runner mutates nothing and computes the
    primary's bits; a heartbeat is beaten at every boundary with the
    generation and segment seconds."""
    name = next(iter(kw))
    if name == "exec_cache":
        from evox_tpu_torch.utils import ExecutableCache

        cache = ExecutableCache(tmp_path / "exec")
        wf = _wf()
        want = ResilientRunner(wf, tmp_path / "a", checkpoint_every=CHUNK, exec_cache=cache).run(wf.init(0), 9)
        programs = cache.stats.saves
        assert programs >= 1 and (cache.stats.misses, cache.stats.hits) == (programs, 0)
        wf = _wf()
        runner = ResilientRunner(wf, tmp_path / "b", checkpoint_every=CHUNK, exec_cache=cache)
        got = runner.run(wf.init(0), 9)
        assert cache.stats.hits == programs and len(runner._cached_programs) == programs
        assert all(runner._cached_programs.values())
        for a, b in zip(graph.flatten(got)[0], graph.flatten(want)[0]):
            assert torch.equal(a, b)
        return
    if name == "primary":
        wf = _wf()
        want = ResilientRunner(wf, tmp_path / "rw", checkpoint_every=CHUNK).run(wf.init(0), 9)
        runner = ResilientRunner(_wf(), tmp_path / "ro", checkpoint_every=CHUNK, primary=False)
        assert runner._writer is None and not runner.primary
        got = runner.run(runner.workflow.init(0), 9)
        assert not (tmp_path / "ro").exists() and runner.stats.checkpoints_written == 0
        assert ResilientRunner(_wf(), tmp_path, **kw).primary
        for a, b in zip(graph.flatten(got)[0], graph.flatten(want)[0]):
            assert torch.equal(a, b)
        return
    beats = []

    class Beats:
        def beat(self, generation=None, segment_seconds=None, **fields):
            beats.append((generation, segment_seconds))

    wf = _wf()
    runner = ResilientRunner(wf, tmp_path, checkpoint_every=CHUNK, heartbeat=Beats())
    runner.run(wf.init(0), 9)
    assert [g for g, _ in beats] == [1] + list(range(1 + CHUNK, 9, CHUNK)) + [9]
    assert [s for _, s in beats] == [t.execute_seconds for t in runner.stats.segment_timings]


def test_runner_validation_and_pickled_fault_plans(tmp_path):
    for kw, match in ((dict(checkpoint_every=0), "checkpoint_every"), (dict(keep_checkpoints=-1), "keep"),
                      (dict(max_restarts=-1), "max_restarts"), (dict(restart=RollbackToCheckpoint()), "health probe"),
                      (dict(verify_resume="deep"), "verify_resume")):
        with pytest.raises(ValueError, match=match):
            ResilientRunner(_wf(), tmp_path, **kw)
    with pytest.raises(ValueError, match="n_steps"):
        ResilientRunner(_wf(), tmp_path).run(_wf().init(0), 0)
    with pytest.raises(ValueError, match="beyond"):
        ResilientRunner(_wf(), tmp_path, checkpoint_every=CHUNK).run(_wf().init(0), 7)
        ResilientRunner(_wf(), tmp_path, checkpoint_every=CHUNK).run(_wf().init(0), 3)
    p = pickle.loads(pickle.dumps(FaultyProblem(Ackley(), nan_generations=(1,))))
    assert p.nan_generations == (1,)
