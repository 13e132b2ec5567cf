"""The port's HPO runner and growth ladder (``evox_tpu_torch/hpo/runner.py``,
``evox_tpu_torch/hpo/elastic.py``) against the JAX package's
(``evox_tpu/hpo``), on the CPU.

The two packages draw different random numbers, so the whole-run
comparisons use a **draw-free meta-run** written in both frameworks: an
outer :class:`Grid` whose population walks a fixed dyadic path, over
inner :class:`Walk` runs whose population moves by ``pop/2 + grid * hp``
(``hp`` the candidate's hyper-parameters).  Every product is exact at
these sizes (dyadic values of few bits), so XLA's fused multiply-adds and
torch's separate roundings agree to the bit.  The JAX outer state is
carried into the port by :func:`~evox_tpu_torch.utils.convert.state_from_numpy`
(nested instances, uids, telemetry, keys), and both runners run from it:
the same ``candidate_history``, restart lineage, ``manifest["hpo"]``
(but the bucket digest, which each package derives its own way), metrics,
decisions and final values.  On a plateau the ladder grows in both at the
same boundary, the growth is journaled, each package's journal replays
through the other's ``replay_decisions``, and a resume across the growth is
bit-identical.  The port alone: a SIGTERM mid-meta-run resumes
bit-identically (``candidate_history`` included), and the runner's
boundary reads the nest's telemetry in its one copy of a segment's
scalars.

Sizes are the JAX package's tests' (``tests/test_hpo_workload.py``): 4
candidates, inner populations of 8, 8 inner generations, segments of 2."""

import os
import signal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evox_tpu import control as jcontrol  # noqa: E402
from evox_tpu import core as jcore  # noqa: E402
from evox_tpu import hpo as jhpo  # noqa: E402
from evox_tpu.service import RequestJournal as JRequestJournal  # noqa: E402
from evox_tpu.utils.checkpoint import read_manifest as jread_manifest  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch import control, hpo  # noqa: E402
from evox_tpu_torch.algorithms import OpenES  # noqa: E402
from evox_tpu_torch.core import Algorithm, Parameter, Problem, State, get_params  # noqa: E402
from evox_tpu_torch.obs import MetricsRegistry, Observability  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.resilience import Preempted, latest_checkpoint  # noqa: E402
from evox_tpu_torch.service import RequestJournal  # noqa: E402
from evox_tpu_torch.utils import graph, read_manifest  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402

from evox_tpu.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from evox_tpu.obs import Observability as JObservability  # noqa: E402

CANDIDATES, INNER_POP, ITERATIONS, EVERY = 4, 8, 8, 2
# The outer path: pop <- pop / 2 + OFFSET, from START (dyadic values).
START = (np.arange(CANDIDATES * 2, dtype=np.float32).reshape(CANDIDATES, 2) / 4.0 + 0.25).astype(np.float32)
OFFSET = (np.asarray([[0.5, 0.25]], np.float32) + np.arange(CANDIDATES, dtype=np.float32)[:, None] / 8.0)


def walk_grid(pop):
    return ((np.arange(pop * 2, dtype=np.float32).reshape(pop, 2) % 8) / 8.0 - 0.5).astype(np.float32)


# -- the draw-free meta-run, in both frameworks ----------------------------------


class JGrid(jcore.Algorithm):
    def __init__(self):
        self.pop_size, self.dim, self.offset = CANDIDATES, 2, jnp.asarray(OFFSET)

    def setup(self, key):
        return jcore.State(key=key, pop=jnp.asarray(START), fit=jnp.full((CANDIDATES,), jnp.inf, jnp.float32))

    def step(self, state, evaluate):
        pop = state.pop * 0.5 + self.offset
        return state.replace(pop=pop, fit=evaluate(pop))


class JWalk(jcore.Algorithm):
    def __init__(self, pop):
        self.pop_size, self.dim, self.grid = pop, 2, jnp.asarray(walk_grid(pop))

    def setup(self, key):
        return jcore.State(key=key, hp=jcore.Parameter(jnp.ones(2, jnp.float32)),
                           pop=jnp.zeros((self.pop_size, 2), jnp.float32),
                           fit=jnp.full((self.pop_size,), jnp.inf, jnp.float32))

    def step(self, state, evaluate):
        pop = state.pop * 0.5 + self.grid * state.hp
        return state.replace(pop=pop, fit=evaluate(pop))


class JDiff(jcore.Problem):
    def evaluate(self, state, pop):
        return pop[:, 0] - pop[:, 1], state


class JFlat(jcore.Problem):
    def evaluate(self, state, pop):
        return jnp.ones(pop.shape[0], jnp.float32), state


# The manifest records the inner algorithm's class name: the twins share it.
JGrid.__name__, JWalk.__name__ = "Grid", "Walk"


class Grid(Algorithm):
    def __init__(self):
        self.pop_size, self.dim, self.offset = CANDIDATES, 2, torch.from_numpy(OFFSET.copy())

    def setup(self, key):
        return State(key=key, pop=torch.from_numpy(START.copy()), fit=torch.full((CANDIDATES,), float("inf")))

    def step(self, state, evaluate):
        pop = state.pop * 0.5 + self.offset
        return state.replace(pop=pop, fit=evaluate(pop))


class Walk(Algorithm):
    def __init__(self, pop):
        self.pop_size, self.dim, self.grid = pop, 2, torch.from_numpy(walk_grid(pop))

    def setup(self, key):
        return State(key=key, hp=Parameter(torch.ones(2)), pop=torch.zeros((self.pop_size, 2)),
                     fit=torch.full((self.pop_size,), float("inf")))

    def step(self, state, evaluate):
        pop = state.pop * 0.5 + self.grid * state.hp
        return state.replace(pop=pop, fit=evaluate(pop))


class Diff(Problem):
    def evaluate(self, state, pop):
        return pop[:, 0] - pop[:, 1], state


class Flat(Problem):
    def evaluate(self, state, pop):
        return torch.ones(pop.shape[0]), state


def transform(x):
    return {"algorithm.hp": x}


def build(pkg, flat=False):
    if pkg == "jax":
        inner = JStdWorkflow(JWalk(INNER_POP), JFlat() if flat else JDiff(), monitor=jhpo.HPOFitnessMonitor())
        nested = jhpo.NestedProblem(inner, iterations=ITERATIONS, num_candidates=CANDIDATES)
        return JStdWorkflow(JGrid(), nested, solution_transform=transform)
    inner = StdWorkflow(Walk(INNER_POP), Flat() if flat else Diff(), monitor=hpo.HPOFitnessMonitor())
    nested = hpo.NestedProblem(inner, iterations=ITERATIONS, num_candidates=CANDIDATES)
    return StdWorkflow(Grid(), nested, solution_transform=transform)


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


def start_states():
    jwf = build("jax")
    jstate = jwf.init(jax.random.key(0))
    return jstate, state_from_numpy(to_numpy(jstate), device="cpu", params=jcore.get_params(jstate))


def values(state, pkg):
    """Every non-key leaf by dotted path, as numpy."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, (State, jcore.State)):
                walk(v, prefix + k + ".")
            elif k != "key":
                out[prefix + k] = v.numpy() if pkg == "torch" else np.asarray(v)

    walk(state, "")
    return out


def same_values(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k].astype(np.float64), b[k].astype(np.float64),
                                                           equal_nan=True), (what, k)


def run(pkg, root, state, n_steps=8, flat=False, grow=False, journal=None, **kw):
    wf = build(pkg, flat=flat)
    if pkg == "jax":
        mod, c, plane = jhpo, jcontrol, JObservability(registry=JMetricsRegistry(), run_id="meta")
    else:
        mod, c, plane = hpo, control, Observability(registry=MetricsRegistry(), run_id="meta")
    if grow:
        factory = JWalk if pkg == "jax" else Walk
        kw.update(grow=mod.GrowthLadder(inner_factory=factory, stagnation_window=4, stagnation_tol=0.0,
                                        max_inner_pop=32),
                  controller=c.Controller(journal=journal, grace=2), max_restarts=3)
    runner = mod.HPORunner(wf, root, checkpoint_every=EVERY, obs=plane, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        final = runner.run(state, n_steps)
    return runner, final, plane


def hpo_block(manifest):
    block = dict(manifest["hpo"])
    bucket = block.pop("bucket")
    assert len(bucket) == 16 and int(bucket, 16) >= 0
    return block


def metrics(plane):
    return {k: v for k, v in plane.registry.snapshot().items() if k.startswith("evox_hpo_")}


# ---------------------------------------------------------------------------
# the converter: a JAX HPO outer state becomes the port's
# ---------------------------------------------------------------------------


def test_converter_carries_a_nested_outer_state():
    jstate, tstate = start_states()
    twf = build("torch")
    native = twf.init(0)
    # The converted state has the port's own structure (uid-keyed instance
    # keys, int64 uids, the telemetry) and the JAX state's values.
    assert graph.structure(tstate) == graph.structure(native)
    same_values(values(tstate, "torch"), values(jstate, "jax"), "converted vs JAX")
    same_values(values(native, "torch"), values(jstate, "jax"), "port's own init vs JAX")
    assert tstate.problem.uids.dtype == torch.int64 and tstate.problem.instances.algorithm.key.shape == (CANDIDATES, 2)
    keys = tstate.problem.instances.algorithm.key
    assert len({tuple(k) for k in keys.tolist()}) == CANDIDATES  # one stream a candidate
    assert "problem.instances.algorithm.hp" in get_params(tstate)


# ---------------------------------------------------------------------------
# the whole runner against the JAX package's
# ---------------------------------------------------------------------------


def test_hpo_runner_matches_the_jax_packages(tmp_path):
    jstate, tstate = start_states()
    jr, jfinal, jplane = run("jax", tmp_path / "j", jstate)
    tr, tfinal, tplane = run("torch", tmp_path / "t", tstate)
    assert tr.candidate_history == jr.candidate_history
    assert sorted(tr.candidate_history) == list(range(CANDIDATES))
    assert [g for g, _ in tr.candidate_history[0]] == [1, 3, 5, 7, 8]
    assert len(tr.candidate_history[0][0][1]) == ITERATIONS - 2
    assert tr.inner_history(2) == jr.inner_history(2)
    same_values(values(tfinal, "torch"), values(jfinal, "jax"), "final states")
    assert sorted(p.name for p in (tmp_path / "t").glob("ckpt_*")) == sorted(p.name for p in (tmp_path / "j").glob("ckpt_*"))
    tman = read_manifest(latest_checkpoint(tmp_path / "t"))
    jman = jread_manifest(latest_checkpoint(tmp_path / "j"))
    assert hpo_block(tman) == hpo_block(jman)
    assert tman["hpo"]["inner_algorithm"] == "Walk" and tman["hpo"]["inner_pop"] == INNER_POP
    assert metrics(tplane) == metrics(jplane)
    assert metrics(tplane)["evox_hpo_inner_generations_total"] == 8 * CANDIDATES * ITERATIONS
    # The runner's final state equals run(8) of the same workflow.
    twf = build("torch")
    ref = twf.run(tstate, 8)
    la, sa = graph.flatten(tfinal)
    lb, sb = graph.flatten(ref)
    assert sa == sb and all(torch.equal(a, b) for a, b in zip(la, lb))


def test_growth_matches_the_jax_packages_and_replays(tmp_path):
    jstate, tstate = start_states()
    jjournal = JRequestJournal(tmp_path / "j.jsonl")
    tjournal = RequestJournal(tmp_path / "t.jsonl")
    jr, jfinal, _ = run("jax", tmp_path / "jg", jstate, flat=True, grow=True, journal=jjournal)
    tr, tfinal, _ = run("torch", tmp_path / "tg", tstate, flat=True, grow=True, journal=tjournal)
    grows = [e.to_manifest() for e in tr.stats.restarts]
    assert grows == [e.to_manifest() for e in jr.stats.restarts]
    assert grows and all(e["policy"] == "hpo-grow" and e["detail"]["grown"] for e in grows)
    assert [e["detail"]["inner_pop"] for e in grows] == [16, 32]
    assert hpo.find_nested(tr.workflow.problem).inner_pop == 32
    assert tfinal.problem.instances.algorithm.fit.shape == (CANDIDATES, 32)
    # The outer algorithm's leaves are untouched by a growth: the outer
    # path is the same as without one.
    _, plain, _ = run("torch", tmp_path / "plain", tstate, flat=True)
    same_values(values(tfinal.algorithm, "torch"), values(plain.algorithm, "torch"), "outer algorithm")
    same_values(values(tfinal, "torch"), values(jfinal, "jax"), "grown final states")
    assert tr.candidate_history == jr.candidate_history
    decisions = [d.to_manifest() for d in tr.controller.decisions]
    assert decisions == [d.to_manifest() for d in jr.controller.decisions]
    assert [d["kind"] for d in decisions] == ["hpo-grow", "hpo-grow"]
    assert decisions[0]["evidence"]["candidate_uid"] in range(CANDIDATES)
    # Each package's journal replays through either package's deciders.
    for records in (tjournal.replay()[0], jjournal.replay()[0], RequestJournal(tmp_path / "j.jsonl").replay()[0]):
        assert [d.to_manifest() for d in control.Controller.replay_decisions(records)] == decisions
        assert [d.to_manifest() for d in jcontrol.Controller.replay_decisions(records)] == decisions
    assert hpo_block(read_manifest(latest_checkpoint(tmp_path / "tg"))) == hpo_block(
        jread_manifest(latest_checkpoint(tmp_path / "jg")))

    # A fresh supervisor (fresh workflow, same directory) replays the
    # lineage, rebuilds the grown template and lands on the same state.
    again, final2, _ = run("torch", tmp_path / "tg", build("torch", flat=True).init(0), flat=True, grow=True)
    assert again.stats.resumed_from_generation == 8 and again.stats.segments_run == 0
    la, sa = graph.flatten(tfinal)
    lb, sb = graph.flatten(final2)
    assert sa == sb and all(torch.equal(a, b) for a, b in zip(la, lb))
    assert again.candidate_history == tr.candidate_history


def test_resume_across_a_growth_is_bit_identical(tmp_path):
    """A run stopped at a boundary of the uninterrupted run after its first
    growth (n_steps 5) and resumed by a fresh runner (and a fresh
    controller) to 8 equals the uninterrupted run to 8: the second growth
    fires at the same boundary, and the lineage differs only in the
    decisions' sequence numbers, which count each controller's own."""
    _, tstate = start_states()
    ref, ref_final, _ = run("torch", tmp_path / "ref", tstate, flat=True, grow=True)
    first, _, _ = run("torch", tmp_path / "cut", tstate, n_steps=5, flat=True, grow=True)
    assert [e.detail["inner_pop"] for e in first.stats.restarts] == [16]
    resumed, final, _ = run("torch", tmp_path / "cut", build("torch", flat=True).init(0), flat=True, grow=True)
    assert resumed.stats.resumed_from_generation == 5
    assert hpo.find_nested(resumed.workflow.problem).inner_pop == 32
    la, sa = graph.flatten(final)
    lb, sb = graph.flatten(ref_final)
    assert sa == sb and all(torch.equal(a, b) for a, b in zip(la, lb))

    def lineage(runner):
        return [{**e.to_manifest(), "detail": {k: v for k, v in e.detail.items() if k != "decision_seq"}}
                for e in runner.stats.restarts]

    assert lineage(resumed) == lineage(ref) and [e.generation for e in ref.stats.restarts] == [1, 5]
    assert resumed.candidate_history == ref.candidate_history


def test_regrow_state_keeps_the_jax_packages_instances():
    """The regrown ladder's instances equal the JAX package's for the same
    salt (their values; the keys are each package's own stream)."""
    jstate, tstate = start_states()
    jn = jhpo.find_nested(build("jax").problem).with_inner_pop(16, JWalk)
    tn = hpo.find_nested(build("torch").problem).with_inner_pop(16, Walk)
    jp, tp = jn.regrow_state(jstate.problem, 0x6B0B), tn.regrow_state(tstate.problem, 0x6B0B)
    same_values(values(tp, "torch"), values(jp, "jax"), "regrown instances")
    assert torch.equal(tp.uids, tstate.problem.uids)
    again = tn.regrow_state(tstate.problem, 0x6B0B)
    assert all(torch.equal(a, b) for a, b in zip(graph.flatten(again)[0], graph.flatten(tp)[0]))


# ---------------------------------------------------------------------------
# the ladder's validation and evidence, against the JAX package's
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kw", [dict(growth_factor=1.0), dict(max_inner_pop=0), dict(stagnation_window=0)])
def test_growth_ladder_errors_match_jax(kw):
    mine = _error(lambda: hpo.GrowthLadder(inner_factory=Walk, **kw))
    assert mine is not None and mine == _error(lambda: jhpo.GrowthLadder(inner_factory=JWalk, **kw))


@pytest.mark.parametrize("iterations, window", [(6, 8), (10, 8), (11, 8), (5, 2)])
def test_validate_ladder_window_matches_jax(iterations, window):
    tn = hpo.NestedProblem(StdWorkflow(Walk(4), Diff(), monitor=hpo.HPOFitnessMonitor()), iterations, 2)
    jn = jhpo.NestedProblem(JStdWorkflow(JWalk(4), JDiff(), monitor=jhpo.HPOFitnessMonitor()), iterations, 2)
    mine = _error(lambda: hpo.validate_ladder_window(hpo.GrowthLadder(Walk, stagnation_window=window), tn))
    assert mine == _error(lambda: jhpo.validate_ladder_window(jhpo.GrowthLadder(JWalk, stagnation_window=window), jn))
    assert (mine is None) == (iterations >= window + 3)
    if mine is not None:
        outer = StdWorkflow(Grid(), tn, solution_transform=transform)
        with pytest.raises(ValueError, match="never fire"):
            hpo.HPORunner(outer, "/nonexistent/unused", grow=hpo.GrowthLadder(Walk, stagnation_window=window))


SERIES = {
    "flat": {0: [1.0] * 6, 1: [5.0, 4.0, 3.0, 2.0, 1.0, 0.0], 2: [3.0, 3.0, 2.5, 2.5, 2.5, 2.5]},
    "nan": {0: [float("nan")] * 6, 1: [2.0, float("nan"), 1.0, 1.0, float("inf"), 1.0]},
    "short": {7: [1.0], 9: []},
    "ties": {3: [2.0, 1.0, 0.0], 1: [4.0, 3.0, 2.0]},
    "rising": {0: [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0], 5: [0.0] * 7},
}


@pytest.mark.parametrize("case", sorted(SERIES))
@pytest.mark.parametrize("window", [1, 3, 8])
def test_grow_evidence_matches_jax(case, window):
    """The most stagnant candidate triggers, with the JAX package's
    evidence (slope over the windowed tail, span, thresholds)."""
    tl = hpo.GrowthLadder(Walk, stagnation_window=window, max_inner_pop=64)
    jl = jhpo.GrowthLadder(JWalk, stagnation_window=window, max_inner_pop=64)
    series = {u: np.asarray(v, np.float32) for u, v in SERIES[case].items()}
    mine = hpo.grow_evidence(tl, series, 8)
    assert mine == jhpo.grow_evidence(jl, series, 8)
    if mine is not None:
        assert control.decide_hpo_grow(mine) == jcontrol.decide_hpo_grow(mine)
    assert [tl.next_pop(p) for p in (1, 8, 40, 64)] == [jl.next_pop(p) for p in (1, 8, 40, 64)]


def test_hpo_runner_validation():
    outer = build("torch")
    with pytest.raises(ValueError, match="NestedProblem"):
        hpo.HPORunner(StdWorkflow(OpenES(8, torch.zeros(2), 0.1, 0.1, device="cpu"), Sphere()), "/nonexistent/x")
    ladder = hpo.GrowthLadder(Walk, stagnation_window=4)
    with pytest.raises(ValueError, match="not both"):
        hpo.HPORunner(outer, "/nonexistent/x", grow=ladder, restart=hpo.HPOGrowPolicy(ladder))
    with pytest.raises(ValueError, match="history_limit"):
        hpo.HPORunner(outer, "/nonexistent/x", history_limit=0)
    runner = hpo.HPORunner(outer, "/nonexistent/x")
    assert runner.health.nonfinite_skip == ("instances",) and runner.candidate_history == {}


# ---------------------------------------------------------------------------
# the port alone: SIGTERM and resume, and the boundary's one read
# ---------------------------------------------------------------------------


def test_sigterm_resume_is_bit_identical(tmp_path):
    """A real SIGTERM after the second checkpoint publish; a fresh runner
    resumes the emergency checkpoint and equals the uninterrupted run,
    ``candidate_history`` included (re-ingested from the manifest ring)."""
    _, tstate = start_states()
    ref, ref_final, _ = run("torch", tmp_path / "ref", tstate, preemption=True, async_checkpoints=False)
    published = {"n": 0}

    def on_event(msg):
        if msg.startswith("checkpoint written"):
            published["n"] += 1
            if published["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(Preempted):
        run("torch", tmp_path / "cut", tstate, preemption=True, on_event=on_event, async_checkpoints=False)
    resumed, final, _ = run("torch", tmp_path / "cut", build("torch").init(0), preemption=True)
    assert resumed.stats.resumed_from_generation is not None and resumed.stats.resumed_after_preemption
    la, sa = graph.flatten(final)
    lb, sb = graph.flatten(ref_final)
    names = [n for n, _ in __import__("evox_tpu_torch").resilience.health._leaves_with_path(final)]
    assert sa == sb and all(torch.equal(a, b) for n, a, b in zip(names, la, lb) if "num_preemptions" not in n)
    assert resumed.candidate_history == ref.candidate_history


def test_the_boundary_reads_the_nest_in_its_one_copy(tmp_path, monkeypatch):
    """The nest's series and uids ride in ``_complete``'s copy: the ingest
    reads the card only for a state no segment produced (a resume), and
    what the boundary read equals ``candidate_series`` of the state (the
    repeats' mean)."""
    _, tstate = start_states()
    wf = build("torch")
    runner = hpo.HPORunner(wf, tmp_path, checkpoint_every=EVERY, obs=False)
    fallback, mismatched = [], []
    real = hpo.HPORunner._series

    def spy(self, state, done):
        if self._boundary_series is None or self._boundary_series[0] != done:
            fallback.append(done)
        got = real(self, state, done)
        want = hpo.candidate_series(state.problem)
        if {u: s.tolist() for u, s in got.items()} != {u: s.tolist() for u, s in want.items()}:
            mismatched.append(done)
        return got

    monkeypatch.setattr(hpo.HPORunner, "_series", spy)
    runner.run(tstate, 8)
    assert not fallback and not mismatched and len(runner.candidate_history[0]) == 5
    assert runner._boundary_series is None
