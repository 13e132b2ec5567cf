"""The resilient runner's CPU fallback from the card
(``ResilientRunner(cpu_fallback=True)``, ``evox_tpu_torch/resilience/runner.py``)
and the twin it runs on (``evox_tpu_torch/utils/relocate.py``).

There is no card here, so the card's side is mocked: the workflow holds one
component bound to the card (``CardBound``: a problem wrapper whose
``device`` is ``torch.device("cuda")``, which builds no tensor there), so
the fallback really builds a CPU twin of the workflow; the refusal of a
sharded evaluation reads the state's device through
``runner._state_device``, pointed at "cuda".  Against the JAX package: its two
fallback tests (``tests/test_resilience.py``) run through both runners on
the same schedule and give the same counters.  The port alone: the run
that falls back equals, bit for bit, a CPU-built workflow resumed from the
segment's input checkpoint; the fault injector's attempt counts and the
monitor's history are carried across; nothing moves without
``cpu_fallback=True``; a sharded evaluation is refused by name.  The
relocation itself is held on the ``meta`` device (every tensor and device
moved, host state shared, the original untouched).

Sizes: the JAX tests' PSO 16 x 8 on Sphere, segments of 4, 8 generations.
"""

import functools
import threading
import warnings
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience import FaultyProblem as JFaultyProblem  # noqa: E402
from evox_tpu.resilience import ResilientRunner as JResilientRunner  # noqa: E402
from evox_tpu.resilience import RetryPolicy as JRetryPolicy  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch import obs  # noqa: E402
from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.resilience import FaultyProblem, ResilienceError, ResilientRunner, RetryPolicy  # noqa: E402
from evox_tpu_torch.resilience import runner as runner_mod  # noqa: E402
from evox_tpu_torch.utils import graph, load_state  # noqa: E402
from evox_tpu_torch.utils.relocate import relocate  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

DIM, POP, CHUNK, N_STEPS = 8, 16, 4, 8
FAST = dict(backoff_base=0.001, backoff_factor=1.0)
CUDA = torch.device("cuda")
FALLBACK_WARNING = "retry budget exhausted; falling back to the CPU backend"


class CardBound(Problem):
    """A problem wrapper bound to the card the way the port's components
    are (a ``device`` attribute set at build), computing nothing there."""

    def __init__(self, problem, device=CUDA):
        self.problem = problem
        self.device = device

    def setup(self, key):
        return self.problem.setup(key)

    def evaluate(self, state, pop):
        return self.problem.evaluate(state, pop)


def _wf(error_times=2, card=True, generation=3):
    inner = CardBound(Sphere()) if card else Sphere()
    prob = FaultyProblem(inner, error_generations=[generation], error_times=error_times)
    algo = PSO(POP, -10.0 * torch.ones(DIM), 10.0 * torch.ones(DIM), device="cpu")
    return StdWorkflow(algo, prob, monitor=EvalMonitor())


def _runner(wf, directory, **kw):
    return ResilientRunner(wf, directory, checkpoint_every=CHUNK, cpu_fallback=True,
                           retry=RetryPolicy(max_retries=1, **FAST), keep_checkpoints=0, **kw)


def _same(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def _jax_runner(tmp_path):
    prob = JFaultyProblem(JSphere(), error_generations=[3], error_times=2)
    wf = JStdWorkflow(JPSO(POP, -10.0 * jnp.ones(DIM), 10.0 * jnp.ones(DIM)), prob)
    runner = JResilientRunner(wf, tmp_path / "jax", checkpoint_every=CHUNK, cpu_fallback=True,
                              retry=JRetryPolicy(max_retries=1, backoff_base=0.01))
    return wf, runner


# ---------------------------------------------------------------------------
# JAX's two fallback tests, through both runners
# ---------------------------------------------------------------------------


def test_cpu_fallback_completes_after_budget_exhaustion_as_jax(tmp_path):
    """``test_cpu_fallback_completes_after_budget_exhaustion``: with the
    segment's retry budget spent, the fallback runs it again on the CPU with
    a fresh budget and the run completes: 8 generations, one fallback,
    finite fitness, the same counters and failures as the JAX runner's, and
    one warning in JAX's words; the state returned is on the CPU."""
    jwf, jrunner = _jax_runner(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jfinal = jrunner.run(jwf.init(jax.random.key(42)), N_STEPS)
    wf = _wf()
    runner = _runner(wf, tmp_path / "port")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        final = runner.run(wf.init(0), N_STEPS)
    s, js = runner.stats, jrunner.stats
    assert s.completed_generations == js.completed_generations == N_STEPS
    assert s.cpu_fallbacks == js.cpu_fallbacks == 1
    assert (s.retries, s.segments_run, s.checkpoints_written) == (js.retries, js.segments_run, js.checkpoints_written)
    assert [f.split(":")[0] for f in s.failures] == [f.split(":")[0] for f in js.failures]
    assert bool(jnp.all(jnp.isfinite(jfinal.algorithm.fit))) and bool(torch.isfinite(final.algorithm.fit).all())
    assert [str(w.message) for w in caught if FALLBACK_WARNING in str(w.message)] == [
        f"segment (generations 2..5): {FALLBACK_WARNING}"]
    assert {t.device.type for t in graph.flatten(final)[0]} == {"cpu"}
    assert runner.workflow is not wf and runner._card_workflow is wf


def test_cpu_fallback_resets_between_runs_as_jax(tmp_path):
    """``test_cpu_fallback_resets_between_runs``: a fallback in one run()
    does not pin the next to the CPU — both runners end the first run
    forced onto the CPU and the next ``run(fresh=True)`` (the fault's
    attempts consumed) off it, with no fallback; the port's next run is
    back on the card workflow."""
    jwf, jrunner = _jax_runner(tmp_path)
    wf = _wf()
    runner = _runner(wf, tmp_path / "port")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jrunner.run(jwf.init(jax.random.key(42)), N_STEPS)
        runner.run(wf.init(0), N_STEPS)
    assert jrunner._forced_cpu and runner._forced_cpu
    assert runner.workflow is not wf
    jrunner.run(jwf.init(jax.random.key(42)), N_STEPS, fresh=True)
    runner.run(wf.init(0), N_STEPS, fresh=True)
    assert not jrunner._forced_cpu and not runner._forced_cpu
    assert jrunner.stats.cpu_fallbacks == runner.stats.cpu_fallbacks == 0
    assert runner.workflow is wf and runner._card_workflow is None


# ---------------------------------------------------------------------------
# the port's own claims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_fallback_equals_a_cpu_workflow_resumed_from_the_checkpoint(tmp_path, fused):
    """The run that falls back ends, bit for bit, where a workflow built on
    the CPU ends when it resumes from the failed segment's input checkpoint
    (generation 1) to the same 8 generations; the generations before the
    fallback (that checkpoint) equal a fault-free run's.  The twin carried
    the fault injector's attempt counts (a fresh copy would have failed
    again on the CPU and spent the budget) and shares the monitor: its
    history holds each generation once, those of the card and of the CPU,
    also where the failed attempts recorded theirs generation by generation
    (``fused=False``, as a host-fault run on the card records them)."""
    wf = _wf()
    runner = _runner(wf, tmp_path / "f", fused=fused)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        final = runner.run(wf.init(0), N_STEPS)
    twin = runner.workflow
    assert twin.monitor is wf.monitor and twin.algorithm is wf.algorithm
    assert twin.problem is not wf.problem and twin.problem._attempts is wf.problem._attempts
    assert wf.problem.problem.device == CUDA and twin.problem.problem.device == torch.device("cpu")
    assert wf.problem.attempts("error", 3) == 3
    assert len(wf.monitor.get_fitness_history()) == N_STEPS

    cpu = _wf(error_times=0, card=False)
    resumed = load_state(tmp_path / "f" / "ckpt_00000001.npz", cpu.init(5))
    for _ in range(N_STEPS - 1):
        resumed = cpu.step(resumed)
    _same(final, resumed)
    clean = _wf(error_times=0, card=False)
    _same(load_state(tmp_path / "f" / "ckpt_00000001.npz", clean.init(5)), clean.init_step(clean.init(0)))


def test_a_late_fallback_reloads_the_segment_input_and_counts_once(tmp_path):
    """A fault in the second segment (evaluation 6): generations 1..5 ran on
    the card, the fallback reloads generation 5's checkpoint into a CPU
    template, the run ends bit-equal to the CPU workflow resumed from it,
    ``evox_runner_cpu_fallbacks_total`` reads 1, and the obs registry is the
    runner's own throughout."""
    plane = obs.Observability(registry=obs.MetricsRegistry(), run_id="fallback")
    wf = _wf(generation=6)
    runner = _runner(wf, tmp_path / "f", obs=plane)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        final = runner.run(wf.init(0), N_STEPS + 4)
    assert runner.stats.cpu_fallbacks == 1 and runner.stats.retries == 1
    assert runner.obs is plane
    assert plane.registry.snapshot()["evox_runner_cpu_fallbacks_total"] == 1
    events = [e.message for e in plane.ring.events() if FALLBACK_WARNING in e.message]
    assert events == [f"segment (generations 6..9): {FALLBACK_WARNING}"]
    cpu = _wf(error_times=0, card=False, generation=6)
    resumed = load_state(tmp_path / "f" / "ckpt_00000005.npz", cpu.init(5))
    for _ in range(N_STEPS + 4 - 5):
        resumed = cpu.step(resumed)
    _same(final, resumed)
    assert len(wf.monitor.get_fitness_history()) == N_STEPS + 4


def test_nothing_moves_without_cpu_fallback(tmp_path):
    """Without ``cpu_fallback=True`` the exhausted budget raises, on the
    card workflow: no twin, no fallback counted."""
    wf = _wf(error_times=5)
    runner = ResilientRunner(wf, tmp_path / "n", checkpoint_every=CHUNK, retry=RetryPolicy(max_retries=1, **FAST))
    with pytest.raises(ResilienceError, match="failed after 1 retries$"), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        runner.run(wf.init(0), N_STEPS)
    assert runner.workflow is wf and runner._card_workflow is None and runner.stats.cpu_fallbacks == 0


def test_a_fallback_past_its_fresh_budget_raises_as_jax(tmp_path):
    """A fault that outlasts the fallback's fresh budget too raises the
    JAX package's message ("... and a CPU fallback")."""
    wf = _wf(error_times=10)
    runner = _runner(wf, tmp_path / "r")
    with pytest.raises(ResilienceError, match="failed after 1 retries and a CPU fallback$"), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        runner.run(wf.init(0), N_STEPS)
    assert runner.stats.cpu_fallbacks == 1


def test_sharded_evaluation_on_the_card_is_refused_with_cpu_fallback(tmp_path, monkeypatch):
    from evox_tpu_torch.parallel import ShardedProblem, make_pop_mesh

    mesh = make_pop_mesh(device="cpu")
    try:
        wf = StdWorkflow(PSO(POP, -torch.ones(DIM), torch.ones(DIM), device="cpu"), ShardedProblem(Sphere(), mesh))
        runner = _runner(wf, tmp_path / "s")
        monkeypatch.setattr(runner_mod, "_state_device", lambda state: CUDA)
        with pytest.raises(NotImplementedError, match="cpu_fallback=True\\) with a ShardedProblem on the card"):
            runner.run(wf.init(0), N_STEPS)
        monkeypatch.undo()
        assert ResilientRunner(wf, tmp_path / "c", cpu_fallback=True).run(wf.init(0), 2) is not None
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the relocation
# ---------------------------------------------------------------------------


class Pair(NamedTuple):
    a: torch.Tensor
    b: int


class Slotted:
    __slots__ = ("x", "device")

    def __init__(self):
        self.x = torch.ones(2)
        self.device = torch.device("cpu")


class Holder:
    def __init__(self):
        self.lb = torch.zeros(3)
        self.w = torch.nn.Parameter(torch.ones(2))
        self.device = torch.device("cpu")
        self.pair = Pair(torch.arange(3), 7)
        self.slotted = Slotted()
        self.items = [torch.ones(1), "x", {"k": torch.zeros(1)}]
        self.counts = {("error", 3): 2}
        self.lock = threading.Lock()
        self.fn = functools.partial(torch.add, torch.ones(1))
        self.cache = graph.Cache()
        self.full = graph.Cache(7)
        self.full.inputs[("s",)] = [torch.zeros(1)]
        self.me = self  # a cycle
        self.bound = self.method

    def method(self):
        return self.lb


def test_relocate_moves_every_tensor_and_device_and_shares_host_state():
    h = Holder()
    monitor = EvalMonitor()
    h.monitor = monitor
    t = relocate(h, "meta", share=[monitor])
    assert t is not h and t.me is t and t.bound.__self__ is t and t.bound() is t.lb
    assert t.lb.device.type == "meta" and t.device == torch.device("meta") and t.pair.a.device.type == "meta"
    assert isinstance(t.pair, Pair) and t.pair.b == 7
    assert isinstance(t.w, torch.nn.Parameter) and t.w.requires_grad and t.w.device.type == "meta"
    assert t.slotted.x.device.type == "meta" and t.slotted.device == torch.device("meta")
    assert t.items[0].device.type == "meta" and t.items[1] == "x" and t.items[2]["k"].device.type == "meta"
    assert t.fn.args[0].device.type == "meta" and t.fn.func is torch.add
    assert t.counts is h.counts and t.lock is h.lock and t.monitor is monitor and t.cache is h.cache
    assert t.full is not h.full and len(t.full.inputs) == 0 and t.full.max_graphs == 7
    # The original is untouched; a twin relocated onto its own device is
    # itself.
    assert h.lb.device.type == "cpu" and h.device == torch.device("cpu") and h.full.inputs
    assert relocate(t, "meta", share=[monitor]) is t
    # Onto the CPU only the captured cache moves (tensors already there
    # are shared).
    c = relocate(h, "cpu", share=[monitor])
    assert c is not h and c.full is not h.full and c.lb is h.lb and c.slotted is h.slotted and c.me is c


def test_relocate_a_workflow_and_its_state():
    wf = _wf(card=False)
    state = wf.init(0)
    twin = relocate(wf, "meta", share=[wf.monitor])
    assert twin.algorithm is not wf.algorithm and twin.algorithm.lb.device.type == "meta"
    assert twin.algorithm.device == torch.device("meta") and wf.algorithm.device == torch.device("cpu")
    assert twin.monitor is wf.monitor and twin.problem is wf.problem  # nothing of Sphere's to move
    moved = relocate(state, "meta")
    leaves, spec = graph.flatten(moved)
    assert spec == graph.flatten(state)[1] and {t.device.type for t in leaves} == {"meta"}
    assert isinstance(moved, State) and moved._param_keys == state._param_keys
    np.testing.assert_array_equal(state.algorithm.pop.numpy(), wf.init(0).algorithm.pop.numpy())
