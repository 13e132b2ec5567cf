"""The port's control plane (``evox_tpu_torch/control``) and the runner's
controller hooks against the JAX package's, on the CPU.

* **the pure deciders**: every ``decide_*`` on the JAX package's evidence
  grids (``tests/test_control.py``, ``tests/test_telemetry.py``) and on a
  seeded fuzz grid gives the JAX package's action;
* **the controller**: the same flight windows and timings give the same
  journaled decisions (manifests equal); the latch (one ``degrade`` and one
  warning), the quiet window, advisory journal appends, and
  ``replay_decisions`` over journals of either package, a torn tail
  included;
* **the runner** (``ResilientRunner(controller=)``): a trend restart on an
  injected plateau fires at the JAX runner's generation with its lineage
  and decisions; self-tuned cadence picks, for the timings the port
  measured, the chunks the JAX runner's controller picks for them; a
  controller that fires nothing leaves the run bit-identical to
  ``controller=None`` (PSO and OpenES, the JAX package's solo cases).

Sizes are the JAX package's tests' own (PSO 16 x 4, segments of 4)."""

import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evox_tpu import control as jcontrol  # noqa: E402
from evox_tpu import obs as jobs  # noqa: E402
from evox_tpu import resilience as jr  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience.runner import SegmentTiming as JSegmentTiming  # noqa: E402
from evox_tpu.service.journal import RequestJournal as JRequestJournal  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch import control, obs, resilience  # noqa: E402
from evox_tpu_torch.algorithms import PSO, OpenES  # noqa: E402
from evox_tpu_torch.control import Controller, Decision  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.resilience import (  # noqa: E402
    FaultyProblem,
    FaultyStore,
    HealthProbe,
    ResilientRunner,
    RollbackToCheckpoint,
    SegmentTiming,
)
from evox_tpu_torch.service import RequestJournal  # noqa: E402
from evox_tpu_torch.utils import graph, read_manifest  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

POP, DIM = 16, 4
NAN = float("nan")


def _rows(values, signal="best_fitness", start_gen=1):
    return [{"generation": start_gen + i, signal: v} for i, v in enumerate(values)]


# ---------------------------------------------------------------------------
# the pure deciders: the JAX package's grids, and a seeded fuzz grid
# ---------------------------------------------------------------------------

TREND = {"span": 10.0, "stagnation_window": 8.0, "stagnation_tol": 0.0, "best_slope": 0.0}
COLLAPSE = {"diversity_floor": 1e-3, "diversity_ema": 2e-3, "diversity_slope": -5e-4, "collapse_horizon": 4.0}
STORM = {"storm_rate": 2.0, "nonfinite_slope": 3.0}
CADENCE = {"per_gen_seconds": 0.01, "boundary_seconds": 0.0, "target_seconds": 0.05, "overhead_cap": None,
           "checkpoint_every": 64}
BROWNOUT = {"pressure": 0.1, "enter": 0.75, "exit": 0.375, "active": False}
BURN = {**BROWNOUT, "burn_rate": 3.0, "burn_enter": 2.0, "burn_exit": 1.0}
SHED = {"queue_budget": 100, "slo_wait_seconds": 10.0, "segment_seconds": 2.0, "lanes": 4}
COMPACT = {"journal_records": 100, "live_tenants": 10, "journal_bytes": 10_000, "replay_seconds": 0.5,
           "compact_records": None, "compact_bytes": None, "max_replay_seconds": None}
GROW = {"candidate_uid": 2, "best_slope": 0.0, "span": 8.0, "stagnation_window": 8.0, "stagnation_tol": 0.0,
        "inner_pop": 1024, "growth_factor": 2.0, "max_inner_pop": 2048}
AUTOSCALE = {"members": 3, "shed_sustain": 3, "shed_rounds": 0, "burn_enter": 2.0, "burn_rate": 0.5,
             "max_members": 4, "drained_member": None, "idle_member": None, "draining": 0, "min_members": 1,
             "queued": 0}

GRIDS = {
    "trend": [TREND, {**TREND, "best_slope": -1.0}, {**TREND, "span": 4.0}, {**TREND, "best_slope": None},
              COLLAPSE, {**COLLAPSE, "diversity_slope": 5e-4}, STORM, {**STORM, "nonfinite_slope": 1.0},
              {**TREND, **COLLAPSE, **STORM}, {}, {**TREND, "stagnation_window": 0.0}],
    "cadence": [CADENCE, {**CADENCE, "checkpoint_every": 2}, {**CADENCE, "boundary_seconds": 1.0, "overhead_cap": 0.5},
                {"per_gen_seconds": 0.01, "boundary_seconds": 0.02, "target_seconds": None, "overhead_cap": 0.4,
                 "checkpoint_every": 64}, {}, {**CADENCE, "checkpoint_every": 25, "target_seconds": 1e-6},
                {**CADENCE, "checkpoint_every": 25, "target_seconds": 10.0}],
    "brownout": [{"pressure": 0.8, "enter": 0.75, "exit": 0.375, "active": False},
                 {"pressure": 0.5, "enter": 0.75, "exit": 0.375, "active": True},
                 {"pressure": 0.3, "enter": 0.75, "exit": 0.375, "active": True},
                 {"pressure": None, "enter": 0.75, "exit": 0.375, "active": False},
                 BROWNOUT, {**BROWNOUT, "pressure": 0.8}, {**BROWNOUT, "pressure": 0.2, "active": True},
                 BURN, {**BURN, "active": True, "pressure": 0.1}, {**BURN, "active": True, "burn_rate": 0.5},
                 {**BURN, "active": True, "burn_rate": 0.5, "pressure": 0.9}],
    "shed-threshold": [SHED, {**SHED, "segment_seconds": None}, {**SHED, "slo_wait_seconds": None},
                       {**SHED, "segment_seconds": 1e6}, {**SHED, "budget_remaining": 0.5},
                       {**SHED, "budget_remaining": 0.0}, {**SHED, "budget_remaining": -2.0},
                       {"queue_budget": 16, "slo_wait_seconds": 4.0, "segment_seconds": 1.0, "lanes": 4,
                        "budget_remaining": -1.0}],
    "tenant": [{"verdict": "stagnation", "restarts_used": 0, "max_restarts": 1},
               {"verdict": "stagnation", "restarts_used": 1, "max_restarts": 1},
               {"verdict": "stagnation+storm", "restarts_used": 0, "max_restarts": 1, "evict_on_storm": True},
               {"verdict": "storm", "restarts_used": 0, "max_restarts": 1}],
    "compact": [COMPACT, {**COMPACT, "compact_records": 100}, {**COMPACT, "compact_records": 101},
                {**COMPACT, "compact_bytes": 10_000}, {**COMPACT, "compact_bytes": 10_001},
                {**COMPACT, "max_replay_seconds": 0.5}, {**COMPACT, "max_replay_seconds": 0.6},
                {**COMPACT, "journal_records": 10, "compact_records": 1},
                {**COMPACT, "journal_records": 0, "compact_records": 1},
                {**COMPACT, "replay_seconds": None, "max_replay_seconds": 0.1}, {}],
    "hpo-grow": [GROW, {**GROW, "best_slope": -0.5}, {**GROW, "span": 4.0}, {**GROW, "inner_pop": 2048},
                 {**GROW, "max_inner_pop": None}, {**GROW, "growth_factor": 1.5, "inner_pop": 3},
                 {**GROW, "best_slope": None}, {**GROW, "inner_pop": 0}, {}],
    "autoscale": [AUTOSCALE, {**AUTOSCALE, "shed_rounds": 3}, {**AUTOSCALE, "burn_rate": 2.5},
                  {**AUTOSCALE, "shed_rounds": 3, "members": 4}, {**AUTOSCALE, "drained_member": 2},
                  {**AUTOSCALE, "idle_member": 1}, {**AUTOSCALE, "idle_member": 1, "queued": 3},
                  {**AUTOSCALE, "idle_member": 1, "draining": 2}, {"members": 0}],
    "degrade": [{"plane": "trend", "reason": "x"}],
}
DECIDERS = {"trend": "decide_trend", "cadence": "decide_cadence", "brownout": "decide_brownout",
            "shed-threshold": "decide_shed", "tenant": "decide_tenant", "compact": "decide_compact",
            "hpo-grow": "decide_hpo_grow", "autoscale": "decide_autoscale"}


def _fuzz(kind, n=48, seed=0):
    """Seeded evidence dicts around each grid's keys: values from a small
    pool (None, 0, negatives, NaN, thresholds' neighbours)."""
    g = np.random.default_rng(seed)
    pool = [None, 0.0, -1.0, 0.5, 1.0, 2.0, 3.0, 8.0, 64.0, 1e-6, -5e-4, NAN, 1024.0]
    keys = sorted({k for e in GRIDS[kind] for k in e})
    out = []
    for _ in range(n):
        e = {k: pool[g.integers(len(pool))] for k in keys if g.random() < 0.8}
        for k in ("active", "evict_on_storm"):
            if k in e:
                e[k] = bool(g.integers(2))
        if "verdict" in e:
            e["verdict"] = ["stagnation", "storm", "collapse+storm", ""][g.integers(4)]
        for k in ("drained_member", "idle_member"):
            if e.get(k) is not None and not math.isnan(e[k]):
                e[k] = int(abs(e[k]))
            elif k in e:
                e[k] = None
        out.append(e)
    return out


def _safe(fn, e):
    try:
        return ("ok", fn(e))
    except (ValueError, TypeError, OverflowError) as err:
        return ("raises", type(err).__name__)


@pytest.mark.parametrize("kind", sorted(GRIDS))
def test_deciders_match_jax(kind):
    cases = GRIDS[kind] + (_fuzz(kind) if kind != "degrade" else [])
    for e in cases:
        assert _safe(lambda x: control.decide(kind, x), e) == _safe(lambda x: jcontrol.decide(kind, x), e), (kind, e)
        if kind in DECIDERS:
            mine, theirs = getattr(control, DECIDERS[kind]), getattr(jcontrol, DECIDERS[kind])
            assert _safe(mine, e) == _safe(theirs, e), (kind, e)


def test_decider_grid_values():
    """The JAX package's hand-set expectations, on the port."""
    assert control.decide_trend(TREND) == "stagnation"
    assert control.decide_trend({**TREND, **COLLAPSE, **STORM}) == "stagnation+collapse+storm"
    assert control.decide_cadence(CADENCE) == 4
    assert control.decide_cadence({**CADENCE, "boundary_seconds": 1.0, "overhead_cap": 0.5}) == 64
    assert control.decide_brownout(BURN) == "enter"
    assert control.decide_shed(SHED) == 20
    assert control.decide_shed({**SHED, "budget_remaining": 0.0}) == 10
    assert control.decide_compact({**COMPACT, "compact_records": 100}) == "compact"
    assert control.decide_hpo_grow(GROW) == "2048" and control.decide_hpo_grow({**GROW, "inner_pop": 2048}) == "hold"
    assert control.decide_autoscale({**AUTOSCALE, "idle_member": 1}) == "drain:1"
    with pytest.raises(ValueError):
        control.decide("no-such-kind", {})
    assert set(control.__all__) == set(jcontrol.__all__)
    assert control.DECISION_SCHEMA_VERSION == jcontrol.DECISION_SCHEMA_VERSION


def test_decision_manifest_round_trip():
    d = Decision(seq=3, kind="trend", generation=42, action="stagnation+storm", policy="trend",
                 evidence={"best_slope": -0.0, "span": 12.0, "storm_rate": 2.0}, tenant_id="alice")
    assert Decision.from_manifest(d.to_manifest()) == d
    assert Decision.from_manifest({**d.to_manifest(), "future_field": 1}) == d
    assert d.to_manifest() == jcontrol.Decision(**vars(d)).to_manifest()


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

WINDOWS = [
    _rows([1.0] * 8),
    _rows([10.0, 8.0, 6.0, 4.0, 2.0, 0.5, 0.25, 0.1]),
    _rows([1.0, NAN, 1.0, float("inf"), 1.0, 1.0, 1.0, 1.0]),
    [{**r, "pop_diversity": 2e-3 - 3e-4 * i, "num_nonfinite": 3.0 * i} for i, r in enumerate(_rows([5.0] * 6))],
]


def _consults(c):
    """One controller through trend windows, cadence timings, hpo-grow,
    brown-out, shed, tenant, autoscale and compaction consults."""
    ctl = c.Controller(stagnation_window=4, diversity_floor=1e-3, collapse_horizon=3, storm_rate=2.0, grace=2,
                       target_seconds=0.05, overhead_cap=0.5, slo_wait_seconds=10.0, evict_on_storm=True)
    for gen, rows in enumerate(WINDOWS):
        ctl.trend_verdict(rows, generation=8 + 4 * gen)
    timings = [(8, 0.3, 0.08, 0.01), (16, 0.0, 0.09, 0.02), (20, 0.0, 0.02, 0.4), (28, 0.2, 0.04, 0.0)]
    current = 8
    for n in range(1, len(timings) + 1):
        seq = [SegmentTiming(*t) for t in timings[:n]]
        current = ctl.next_chunk(seq, checkpoint_every=16, generation=timings[n - 1][0], current=current) or current
    ctl.hpo_grow(evidence=GROW, generation=30)
    ctl.hpo_grow(evidence=GROW, generation=31)  # quiet window
    ctl.brownout(pressure=0.9, active=False, enter=0.75)
    ctl.shed_threshold(queue_budget=100, segment_seconds=2.0, lanes=4)
    ctl.shed_threshold(queue_budget=100, segment_seconds=2.0, lanes=4)  # unchanged: silent
    trend = next(d for d in ctl.decisions if d.kind == "trend")
    ctl.tenant_action(trend, restarts_used=0, max_restarts=1, generation=40, tenant_id="t")
    ctl.autoscale(evidence={**AUTOSCALE, "shed_rounds": 3}, generation=41)
    ctl.compact(evidence={**COMPACT, "compact_records": 10}, generation=42)
    return [d.to_manifest() for d in ctl.decisions], ctl.degraded


def test_controller_decisions_match_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mine = _consults(control)
        assert mine == _consults(jcontrol)
    kinds = [d["kind"] for d in mine[0]]
    assert {"trend", "cadence", "hpo-grow", "brownout", "shed-threshold", "tenant", "autoscale", "compact"} <= set(kinds)
    assert kinds.count("hpo-grow") == 1 and kinds.count("shed-threshold") == 1 and not mine[1]


def test_controller_quiet_window_after_firing():
    ctl = Controller(stagnation_window=3, grace=10)
    flat = _rows([1.0] * 8)
    assert ctl.trend_verdict(flat, generation=8) is not None
    assert ctl.trend_verdict(flat, generation=9) is None
    assert ctl.trend_verdict(flat, generation=19) is not None
    assert ctl.grace == 10 and Controller(stagnation_window=12).grace == 12 and Controller().grace == 8


def test_controller_detached_rows_degrade_once():
    ctl = Controller(stagnation_window=3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert ctl.trend_verdict(None, generation=4) is None
        assert ctl.trend_verdict(None, generation=8) is None
    assert ctl.degraded and not ctl.trend_enabled
    assert [d.kind for d in ctl.decisions] == ["degrade"]
    assert ctl.decisions[0].action == "threshold-probes" and ctl.decisions[0].evidence["plane"] == "trend"
    assert sum("degraded" in str(w.message) for w in caught) == 1
    assert len(ctl.failures) == 1  # a latched plane is not consulted again


def test_controller_survives_broken_rows_and_publishes_through_obs():
    class Bomb:
        def __getitem__(self, k):
            raise RuntimeError("poisoned row")

        def __contains__(self, k):
            return True

    plane = obs.Observability(registry=obs.MetricsRegistry(), run_id="c")
    ctl = Controller(stagnation_window=3)
    ctl.bind(plane)
    ctl.bind(obs.Observability(registry=obs.MetricsRegistry()))  # first binder wins
    assert ctl.trend_verdict([Bomb()] * 8, generation=8) is None
    assert ctl.degraded and ctl.failures
    snap = plane.registry.snapshot()
    assert snap['evox_control_decisions_total{kind="degrade"}'] == 1.0 and snap["evox_control_degraded"] == 1.0
    assert any(e.category == "control" and e.severity == "warning" for e in plane.ring.events())


def test_controller_journal_append_failure_is_advisory(tmp_path):
    journal = RequestJournal(tmp_path / "j.jsonl", store=FaultyStore(enospc_saves=list(range(16))))
    ctl = Controller(stagnation_window=3, journal=journal)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        decision = ctl.trend_verdict(_rows([1.0] * 8), generation=8)
    assert decision is not None and ctl.journal_append_failures >= 1
    assert any("journal append failed" in str(w.message) for w in caught)


def test_controller_validation_matches_jax():
    for kw in (dict(stagnation_window=-1), dict(collapse_horizon=-1), dict(storm_rate=0.0),
               dict(target_seconds=0.0), dict(overhead_cap=1.0), dict(slo_wait_seconds=0.0),
               dict(brownout_burn=0.0)):
        with pytest.raises(ValueError) as mine:
            Controller(**kw)
        with pytest.raises(ValueError) as theirs:
            jcontrol.Controller(**kw)
        assert str(mine.value) == str(theirs.value)


def test_cadence_ema_skips_rollback_segments():
    timings = [SegmentTiming(8, 0.0, 0.8, 0.0), SegmentTiming(4, 0.0, 0.8, 0.0), SegmentTiming(12, 0.0, 0.8, 0.0)]
    per_gen, boundary = Controller._cadence_ema(timings)
    assert per_gen == pytest.approx(0.1) and boundary == 0.0
    jt = [JSegmentTiming(*t) for t in timings]
    assert (per_gen, boundary) == jcontrol.Controller._cadence_ema(jt)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_replay_decisions_over_either_packages_journal(tmp_path, writer):
    """Decisions journaled by one package replay through either package's
    ``replay_decisions`` to the same (kind, action) sequence and manifests;
    a torn decision record is healed away and the trusted prefix still
    replays."""
    c, J = (jcontrol, JRequestJournal) if writer == "jax" else (control, RequestJournal)
    path = tmp_path / "decisions.jsonl"
    ctl = c.Controller(stagnation_window=3, grace=2, target_seconds=0.05, journal=J(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for gen in (8, 12, 16):
            ctl.trend_verdict(_rows([1.0] * 8), generation=gen)
        ctl.next_chunk([SegmentTiming(8, 0.0, 0.8, 0.0)], checkpoint_every=16, generation=8, current=16)
        ctl.hpo_grow(evidence=GROW, generation=20)
    live = [d.to_manifest() for d in ctl.decisions]
    assert [d["kind"] for d in live] == ["trend", "trend", "trend", "cadence", "hpo-grow"]
    with open(path, "ab") as f:  # a crash tore a decision record mid-append
        f.write(b'{"body":{"seq":99,"kind":"decision","data":{"decisi')
    for replay_journal, replay in ((RequestJournal, Controller.replay_decisions),
                                   (JRequestJournal, jcontrol.Controller.replay_decisions)):
        copy = tmp_path / f"copy-{replay_journal.__module__.split('.')[0]}.jsonl"
        copy.write_bytes(path.read_bytes())
        records, damage = replay_journal(copy).replay()
        assert damage is not None and damage.truncated
        assert [d.to_manifest() for d in replay(records)] == live
        # Raw rows straight off the file replay alike.
        raw = [{"kind": r.kind, "data": r.data} for r in records] + [{"kind": "submit", "data": {}}]
        assert [d.to_manifest() for d in replay(raw)] == live


# ---------------------------------------------------------------------------
# the runner's controller hooks
# ---------------------------------------------------------------------------


def _plateau_run(pkg, tmp_path, tag, controller, n_steps=29):
    """The JAX package's chaos acceptance run: PSO wedged on an injected
    stagnation plateau (fitness clamped up to 1e6 from eval 0) with a NaN
    burst at eval 3."""
    if pkg == "jax":
        wf = JStdWorkflow(JPSO(POP, -32.0 * jnp.ones(DIM), 32.0 * jnp.ones(DIM)),
                          jr.FaultyProblem(JSphere(), plateau_from=0, plateau_floor=1e6, nan_generations=[3]),
                          monitor=JEvalMonitor(full_fit_history=True))
        o, R, state = jobs, jr, wf.init(jax.random.key(0))
    else:
        wf = StdWorkflow(PSO(POP, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"),
                         FaultyProblem(Sphere(), plateau_from=0, plateau_floor=1e6, nan_generations=[3]),
                         monitor=EvalMonitor(full_fit_history=True))
        o, R, state = obs, resilience, wf.init(0)
    plane = o.Observability(registry=o.MetricsRegistry(), flight=o.FlightRecorder(tmp_path / tag / "pm", window=64),
                            run_id=tag)
    runner = R.ResilientRunner(wf, tmp_path / tag, checkpoint_every=4,
                               health=R.HealthProbe(stagnation_window=5, stagnation_tol=0.0),
                               restart=R.RollbackToCheckpoint(), max_restarts=1, obs=plane, controller=controller)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        final = runner.run(state, n_steps)
    return runner, final, plane


def test_trend_restart_fires_as_the_jax_runners_and_is_journaled(tmp_path):
    journal = RequestJournal(tmp_path / "decisions.jsonl")
    ctl = Controller(stagnation_window=6, journal=journal)
    guided, _, plane = _plateau_run("torch", tmp_path, "ctl", ctl)
    baseline, _, _ = _plateau_run("torch", tmp_path, "base", None)
    jctl = jcontrol.Controller(stagnation_window=6)
    jguided, _, _ = _plateau_run("jax", tmp_path, "jctl", jctl)
    assert len(guided.stats.restarts) == len(baseline.stats.restarts) == 1
    # The trend verdict fires before the probe's window elapses, at the JAX
    # runner's generation, with its lineage.
    assert guided.stats.restarts[0].generation < baseline.stats.restarts[0].generation
    assert guided.stats.restarts[0].to_manifest() == jguided.stats.restarts[0].to_manifest()
    assert guided.stats.restarts[0].detail["trend"] == "stagnation"
    assert guided.stats.restarts[0].detail["decision_seq"] == 0
    assert guided.stats.completed_generations == 29
    assert [(d.kind, d.action, d.generation) for d in ctl.decisions] == [
        (d.kind, d.action, d.generation) for d in jctl.decisions]
    thresholds = ("stagnation_window", "stagnation_tol", "span", "rows", "collapse_horizon")
    assert [{k: d.evidence[k] for k in thresholds} for d in ctl.decisions] == [
        {k: d.evidence[k] for k in thresholds} for d in jctl.decisions]
    records, damage = journal.replay()
    assert damage is None
    assert [d.to_manifest() for d in Controller.replay_decisions(records)] == [d.to_manifest() for d in ctl.decisions]
    assert [d.to_manifest() for d in jcontrol.Controller.replay_decisions(records)] == [
        d.to_manifest() for d in ctl.decisions]
    # The restart's lineage rides in the manifest; the decision event and
    # counter are on the obs plane.
    newest = sorted((tmp_path / "ctl").glob("ckpt_*.npz"))[-1]
    assert read_manifest(newest)["restarts"][0]["detail"]["trend"] == "stagnation"
    trends = sum(d.kind == "trend" for d in ctl.decisions)
    assert plane.registry.snapshot()['evox_control_decisions_total{kind="trend"}'] == trends >= 1


def test_detached_flight_recorder_degrades_and_completes(tmp_path):
    ctl = Controller(stagnation_window=6)
    wf = StdWorkflow(PSO(POP, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"),
                     FaultyProblem(Sphere(), plateau_from=0, plateau_floor=1e6),
                     monitor=EvalMonitor(full_fit_history=True))
    plane = obs.Observability(registry=obs.MetricsRegistry(), flight=obs.FlightRecorder(tmp_path / "pm", window=64),
                              run_id="detach")
    runner = ResilientRunner(wf, tmp_path / "run", checkpoint_every=4, health=HealthProbe(stagnation_window=5),
                             restart=RollbackToCheckpoint(), max_restarts=1, obs=plane, controller=ctl)
    calls = {"n": 0}
    original_rows = plane.flight.rows

    def flaky_rows():
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("flight recorder detached")
        return original_rows()

    plane.flight.rows = flaky_rows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(wf.init(0), 29)
    assert runner.stats.completed_generations == 29
    assert ctl.degraded and [d.kind for d in ctl.decisions] == ["degrade"]
    # The threshold probe still fired the restart.
    assert len(runner.stats.restarts) == 1 and "trend" not in runner.stats.restarts[0].detail
    assert any("degraded" in e.message for e in plane.ring.events()
               if e.category == "control" and e.severity == "warning")


def test_trend_without_a_flight_recorder_degrades_once(tmp_path):
    ctl = Controller(stagnation_window=4)
    wf = StdWorkflow(PSO(POP, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"), Sphere())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ResilientRunner(wf, tmp_path, checkpoint_every=4, obs=False, controller=ctl).run(wf.init(0), 13)
    assert [d.kind for d in ctl.decisions] == ["degrade"] and ctl.decisions[0].evidence["plane"] == "trend"


def test_self_tuning_cadence_picks_the_jax_controllers_chunks(tmp_path):
    """A micro target forces the chunk down; every change is a journaled
    cadence decision, the graph cache is sized for every cadence length,
    and for the timings this run measured the JAX runner's controller picks
    the same chunks (``_next_chunk``'s consult, replayed)."""
    wf = StdWorkflow(PSO(POP, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"), Sphere(),
                     monitor=EvalMonitor())
    journal = RequestJournal(tmp_path / "j.jsonl")
    ctl = Controller(target_seconds=1e-6, journal=journal)
    runner = ResilientRunner(wf, tmp_path / "run", checkpoint_every=16, obs=False, controller=ctl)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runner.run(wf.init(0), 49)
    assert runner.stats.completed_generations == 49
    chunks = runner.stats.chunk_sizes
    assert all(c == 1 or (c & (c - 1)) == 0 for c in chunks) and 1 in chunks
    cadence = [d for d in ctl.decisions if d.kind == "cadence"]
    assert cadence and cadence[0].action == "1"
    records, _ = journal.replay()
    assert [d.to_manifest() for d in Controller.replay_decisions(records)] == [d.to_manifest() for d in ctl.decisions]
    assert wf._graphs.max_graphs == max(graph.MAX_GRAPHS, runner._cadence_lengths()) == 6

    # The JAX runner's consult over the same timings: the chunk before
    # each segment (the first is checkpoint_every, before any timing).
    jctl = jcontrol.Controller(target_seconds=1e-6)
    timings = [JSegmentTiming(*t) for t in runner.stats.segment_timings]
    current, picked = 16, []
    for i, done in enumerate(t.generation for t in timings[:-1]):
        chunk = jctl.next_chunk(timings[: i + 1], checkpoint_every=16, generation=done, current=current)
        current = chunk or current
        picked.append(min(current, 49 - done))
    assert picked == chunks
    assert [d.to_manifest() for d in jctl.decisions] == [d.to_manifest() for d in ctl.decisions]


def test_overhead_cap_grows_the_chunk_from_capture_and_checkpoint_seconds():
    """Capture seconds count as boundary overhead (the JAX package's
    compile): a heavy first capture grows the next chunk, and once every
    length is captured the overhead is the checkpoint block alone."""
    ctl = Controller(target_seconds=0.02, overhead_cap=0.5)
    cold = [SegmentTiming(8, 2.0, 0.08, 0.0)]
    warm = [SegmentTiming(8, 0.0, 0.08, 0.0)]
    assert ctl.next_chunk(cold, checkpoint_every=64, generation=8, current=8) == 64
    assert ctl.next_chunk(warm, checkpoint_every=64, generation=8, current=64) == 2
    assert [d.action for d in ctl.decisions] == ["64", "2"]


def _algorithms():
    return {
        "pso": lambda: PSO(POP, -32.0 * torch.ones(DIM), 32.0 * torch.ones(DIM), device="cpu"),
        "openes": lambda: OpenES(POP, torch.full((DIM,), 3.0), learning_rate=0.1, noise_stdev=0.1, optimizer="adam",
                                 device="cpu"),
    }


def _identity_run(tmp_path, tag, factory, controller):
    mon = EvalMonitor(full_fit_history=True)
    wf = StdWorkflow(factory(), Sphere(), monitor=mon)
    plane = obs.Observability(registry=obs.MetricsRegistry(), flight=obs.FlightRecorder(tmp_path / tag / "pm",
                                                                                          window=64), run_id=tag)
    runner = ResilientRunner(wf, tmp_path / tag, checkpoint_every=4, health=HealthProbe(stagnation_window=5),
                             restart=RollbackToCheckpoint(), obs=plane, controller=controller)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        final = runner.run(wf.init(0), 11)
    return final, mon


@pytest.mark.parametrize("algo", sorted(_algorithms()))
def test_bit_identity_controller_on_vs_off_solo(tmp_path, algo):
    """With every detector armed and none able to fire in an 11-generation
    healthy run, controller-on equals controller-off to the bit: final
    state, history, checkpoint leaf digests."""
    factory = _algorithms()[algo]
    ctl = Controller(stagnation_window=10_000, diversity_floor=1e-300, collapse_horizon=0, storm_rate=1e12)
    final_on, mon_on = _identity_run(tmp_path, f"{algo}-on", factory, ctl)
    final_off, mon_off = _identity_run(tmp_path, f"{algo}-off", factory, None)
    assert not ctl.decisions
    lon, son = graph.flatten(final_on)
    loff, soff = graph.flatten(final_off)
    assert son == soff and all(torch.equal(a, b) for a, b in zip(lon, loff))
    assert len(mon_on.fitness_history) == len(mon_off.fitness_history) > 0
    for a, b in zip(mon_on.fitness_history, mon_off.fitness_history):
        assert torch.equal(a, b)

    def newest(d):
        p = sorted(d.glob("ckpt_*.npz"))[-1]
        return p.name, read_manifest(p)["leaf_digests"]

    assert newest(tmp_path / f"{algo}-on") == newest(tmp_path / f"{algo}-off")


def test_control_modules_import_no_jax():
    import ast
    from pathlib import Path

    root = Path(control.__file__).resolve().parent.parent
    files = sorted((root / "control").glob("*.py")) + sorted((root / "service").glob("*.py"))
    # control: 3; service: client, daemon, gateway, journal, pack, service, tenant and __init__
    assert len(files) == 11
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "evox_tpu"), (f, n)
