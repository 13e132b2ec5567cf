"""The port's service HPO workload (``TenantSpec(workload="hpo")`` in
``evox_tpu_torch/service``) on the CPU, against the JAX package's
(``tests/test_hpo_workload.py``) at its sizes: inner populations of 8, 4
candidates, 5-8 inner generations, 4 lanes, segments of 2.

Against the JAX package, exactly: ``TenantSpec``'s validation (types and
messages), ``bucket_key``'s partition of transforms that differ only in
behaviour, and a whole packed service run on the draw-free meta-run of
``tests/test_torch_hpo_runner.py`` (an outer ``Grid`` over inner ``Walk``
runs, every product exact): the candidates' series, the final values, the
``evox_hpo_*`` counters and, on a plateau, the journaled ``hpo-grow``
decisions and the grown final state.

The port alone: the nested bulkhead (an HPO tenant beside a cotenant whose
inner runs burst NaN every generation finishes bit-equal to itself solo:
state, history, checkpoint digests; also with two repeats a candidate), the
growth's bucket re-key and its parking, readmission after a growth, a
daemon killed and restarted with an HPO tenant, the journal's spec
encoding, and the kernels' merged batching rules: one call of the plain
move or the plain draws an inner generation for the whole pack, each
instance drawing from its own key.  On the card the same pack is one
captured graph (``tests/test_torch_cuda.py``, ``chip_smoke.py``'s
``service_hpo_main_path``).
"""

import contextlib
import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from evox_tpu import control as jcontrol  # noqa: E402
from evox_tpu import hpo as jhpo  # noqa: E402
from evox_tpu import service as jservice  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.algorithms import OpenES as JOpenES  # noqa: E402
from evox_tpu.obs import MetricsRegistry as JMetricsRegistry  # noqa: E402
from evox_tpu.obs import Observability as JObservability  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience import HealthProbe as JHealthProbe  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch import control, hpo  # noqa: E402
from evox_tpu_torch.algorithms import CMAES, PSO, OpenES  # noqa: E402
from evox_tpu_torch.core import Problem  # noqa: E402
from evox_tpu_torch.hpo import GrowthLadder, HPOFitnessMonitor, NestedProblem, find_nested  # noqa: E402
from evox_tpu_torch.obs import MetricsRegistry, Observability  # noqa: E402
from evox_tpu_torch.ops import philox, pso_step  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley, Sphere  # noqa: E402
from evox_tpu_torch.resilience import FaultyProblem, HealthProbe  # noqa: E402
from evox_tpu_torch.resilience.testing import assert_states_equal, last_checkpoint_digests, silent  # noqa: E402
from evox_tpu_torch.service import (  # noqa: E402
    OptimizationService,
    RequestJournal,
    ServiceDaemon,
    TenantSpec,
    TenantStatus,
    bucket_key,
)
from evox_tpu_torch.service.daemon import _decode_spec, _encode_spec  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402

from test_torch_hpo_runner import CANDIDATES, Diff, Flat, Grid, JDiff, JFlat, JGrid, JWalk, Walk  # noqa: E402
from test_torch_hpo_runner import same_values, transform, values  # noqa: E402

DIM = 4
LANES, SEGMENT = 4, 2


# -- spec factories (module level: the daemon's journal pickles them by name) -----


def make_inner_es(pop):
    return OpenES(pop, torch.zeros(DIM), learning_rate=0.05, noise_stdev=0.1, device="cpu")


def make_inner_pso(pop):
    return PSO(pop, -5.0 * torch.ones(DIM), 5.0 * torch.ones(DIM), device="cpu")


def jmake_inner_es(pop):
    return JOpenES(pop, jnp.zeros(DIM), learning_rate=0.05, noise_stdev=0.1)


def es_transform(x):
    return {"algorithm.lr": torch.clip(x[:, 0], 1e-3, 1.0), "algorithm.noise_stdev": torch.clip(x[:, 1], 1e-3, 1.0)}


def jes_transform(x):
    return {"algorithm.lr": jnp.clip(x[:, 0], 1e-3, 1.0), "algorithm.noise_stdev": jnp.clip(x[:, 1], 1e-3, 1.0)}


def pso_transform(x):
    return {"algorithm.w": torch.clip(x[:, 0], 0.1, 1.0), "algorithm.phi_p": torch.clip(x[:, 1], 0.5, 3.0)}


class Plateau(Problem):
    """Constant fitness: every inner run stagnates by construction."""

    def evaluate(self, state, pop):
        return torch.ones(pop.shape[0]), state


def outer_pso():
    return PSO(CANDIDATES, lb=0.01 * torch.ones(2), ub=torch.ones(2), device="cpu")


def es_nest(problem=None, inner_pop=8, iterations=5, **kw):
    inner = StdWorkflow(make_inner_es(inner_pop), problem if problem is not None else Sphere(),
                        monitor=HPOFitnessMonitor())
    return NestedProblem(inner, iterations=iterations, num_candidates=CANDIDATES, **kw)


def es_spec(tenant_id, uid, n_steps=6, problem=None, **kw):
    """PSO(4) over 4 x OpenES(8) candidates, the JAX suite's tenant."""
    nest_kw = {k: kw.pop(k) for k in ("inner_pop", "iterations", "num_repeats", "aggregation") if k in kw}
    return TenantSpec(tenant_id, outer_pso(), es_nest(problem, **nest_kw), n_steps=n_steps, uid=uid, workload="hpo",
                      solution_transform=es_transform, **kw)


def cmaes_spec(tenant_id, uid, n_steps=6):
    """CMA-ES(4) over 4 x PSO(8) candidates (the JAX suite's second nest)."""
    inner = StdWorkflow(make_inner_pso(8), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=5, num_candidates=CANDIDATES)
    return TenantSpec(tenant_id, CMAES(torch.tensor([0.6, 2.0]), 0.3, pop_size=CANDIDATES, device="cpu"), nested,
                      n_steps=n_steps, uid=uid, workload="hpo", solution_transform=pso_transform)


def make_service(root, **kw):
    kwargs = dict(lanes_per_pack=LANES, segment_steps=SEGMENT, health=HealthProbe(nonfinite_skip=("instances",)),
                  max_restarts=1)
    kwargs.update(kw)
    return OptimizationService(root, **kwargs)


def run(svc, max_rounds=40):
    silent(svc.run, max_rounds=max_rounds)


def history(svc, tenant_id):
    return [np.asarray(x) for x in svc.tenant(tenant_id).monitor.fitness_history]


def newest_digests(root, tenant_id):
    return last_checkpoint_digests(root, tenant_id)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _spec_outcome(cls, **kw):
    try:
        spec = cls(**kw)
        return ("ok", spec.workload, spec.grow is not None)
    except Exception as e:  # noqa: BLE001 - the type and message are compared
        return (type(e).__name__, str(e))


def _validation_case(case, pkg):
    if pkg == "jax":
        lb, ub = -jnp.ones(2), jnp.ones(2)
        algo, prob, fac, tf = JPSO(2, lb, ub), JSphere(), jmake_inner_es, jes_transform
        nest = jhpo.NestedProblem(JStdWorkflow(jmake_inner_es(4), JSphere(), monitor=jhpo.HPOFitnessMonitor()),
                                  iterations=6, num_candidates=2)
        ladder_cls, spec_cls = jhpo.GrowthLadder, jservice.TenantSpec
    else:
        lb, ub = -torch.ones(2), torch.ones(2)
        algo, prob, fac, tf = PSO(2, lb, ub, device="cpu"), Sphere(), make_inner_es, es_transform
        nest = NestedProblem(StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor()), iterations=6,
                             num_candidates=2)
        ladder_cls, spec_cls = GrowthLadder, TenantSpec
    base = dict(tenant_id="t", algorithm=algo, n_steps=4)
    cases = {
        "no-nested-problem": dict(problem=prob, workload="hpo"),
        "unknown-workload": dict(problem=prob, workload="nas"),
        "grow-on-standard": dict(problem=prob, grow=ladder_cls(inner_factory=fac)),
        "window-never-fires": dict(problem=nest, workload="hpo", grow=ladder_cls(inner_factory=fac,
                                                                                 stagnation_window=8),
                                   solution_transform=tf),
        "window-fits": dict(problem=nest, workload="hpo", grow=ladder_cls(inner_factory=fac, stagnation_window=3),
                            solution_transform=tf),
        "hpo-without-grow": dict(problem=nest, workload="hpo", solution_transform=tf),
    }
    return _spec_outcome(spec_cls, **base, **cases[case])


VALIDATION_CASES = ["no-nested-problem", "unknown-workload", "grow-on-standard", "window-never-fires",
                    "window-fits", "hpo-without-grow"]


@pytest.mark.parametrize("case", VALIDATION_CASES)
def test_workload_validation_equals_jax(case):
    """``tests/test_hpo_workload.py:161-203``'s cases: the same exception
    types and messages (and the same admissions)."""
    got, want = _validation_case(case, "torch"), _validation_case(case, "jax")
    assert got == want
    assert (got[0] == "ok") == (case in ("window-fits", "hpo-without-grow"))


def test_transform_digest_splits_buckets_like_jax():
    """Transforms that differ only in a constant never share a bucket;
    identical ones do — in both packages."""

    def t_a(x):
        return {"algorithm.lr": x[:, 0]}

    def t_b(x):
        return {"algorithm.noise_stdev": x[:, 0]}

    def t_c(x):
        return {"algorithm.lr": x[:, 0]}

    t_b.__qualname__ = t_c.__qualname__ = t_a.__qualname__
    jalgo = JPSO(4, lb=0.01 * jnp.ones(2), ub=jnp.ones(2))
    jnest = jhpo.NestedProblem(JStdWorkflow(jmake_inner_es(4), JSphere(), monitor=jhpo.HPOFitnessMonitor()),
                               iterations=4, num_candidates=4)
    nest = NestedProblem(StdWorkflow(make_inner_es(4), Sphere(), monitor=HPOFitnessMonitor()), iterations=4,
                         num_candidates=4)
    partitions = []
    for spec_cls, key_fn, algo, nested in ((jservice.TenantSpec, jservice.bucket_key, jalgo, jnest),
                                           (TenantSpec, bucket_key, outer_pso(), nest)):
        keys = [key_fn(spec_cls(tid, algo, nested, n_steps=4, workload="hpo", solution_transform=fn))
                for tid, fn in (("a", t_a), ("b", t_b), ("c", t_c))]
        partitions.append([[keys[i] == keys[j] for j in range(3)] for i in range(3)])
    assert partitions[0] == partitions[1]
    assert partitions[1][0] == [True, False, True]


class CpuGrid(Grid):
    """The meta-run's outer ``Grid`` on the CPU: the service's monitors
    take the algorithm's device."""

    device = torch.device("cpu")


def _walk_spec(pkg, tenant_id, uid, flat, grow, n_steps=8):
    """The draw-free meta-run as a tenant: Grid over 4 x Walk(8), 8 inner
    generations (the HPO runner comparison's nest)."""
    if pkg == "jax":
        inner = JStdWorkflow(JWalk(8), JFlat() if flat else JDiff(), monitor=jhpo.HPOFitnessMonitor())
        nested = jhpo.NestedProblem(inner, iterations=8, num_candidates=CANDIDATES)
        ladder = jhpo.GrowthLadder(inner_factory=JWalk, stagnation_window=4, stagnation_tol=0.0, max_inner_pop=32)
        return jservice.TenantSpec(tenant_id, JGrid(), nested, n_steps=n_steps, uid=uid, workload="hpo",
                                   grow=ladder if grow else None, solution_transform=transform)
    inner = StdWorkflow(Walk(8), Flat() if flat else Diff(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=8, num_candidates=CANDIDATES)
    ladder = GrowthLadder(inner_factory=Walk, stagnation_window=4, stagnation_tol=0.0, max_inner_pop=32)
    return TenantSpec(tenant_id, CpuGrid(), nested, n_steps=n_steps, uid=uid, workload="hpo",
                      grow=ladder if grow else None, solution_transform=transform)


def _walk_service(pkg, root, flat, grow):
    if pkg == "jax":
        mod, probe = jservice, JHealthProbe(nonfinite_skip=("instances",))
        plane = JObservability(registry=JMetricsRegistry(), run_id="svc")
        journal = jservice.RequestJournal(os.path.join(root, "journal.jsonl")) if grow else None
        controller = jcontrol.Controller(journal=journal, grace=2) if grow else None
    else:
        mod, probe = None, HealthProbe(nonfinite_skip=("instances",))
        plane = Observability(registry=MetricsRegistry(), run_id="svc")
        journal = RequestJournal(os.path.join(root, "journal.jsonl")) if grow else None
        controller = control.Controller(journal=journal, grace=2) if grow else None
    cls = mod.OptimizationService if mod is not None else OptimizationService
    svc = cls(os.path.join(root, "svc"), lanes_per_pack=LANES, segment_steps=SEGMENT, health=probe, max_restarts=3,
              obs=plane, controller=controller, on_event=lambda msg: None)
    for tid, uid in (("meta-a", 0), ("meta-b", 1)):
        svc.submit(_walk_spec(pkg, tid, uid, flat, grow))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.run(max_rounds=40)
    counters = {k: v for k, v in plane.registry.snapshot().items() if k.startswith("evox_hpo_")}
    return svc, counters, controller, journal


@pytest.mark.parametrize("flat, grow", [(False, False), (True, True)], ids=["walk", "plateau-grow"])
def test_packed_service_matches_the_jax_service(tmp_path, flat, grow):
    """Two packed Walk tenants in each package's service: the candidates'
    series, the final outer and nested values, ``evox_hpo_*`` counters and,
    on the plateau, the growths and their journaled decisions (evidence and
    action) equal JAX's bit for bit (``same_values``: every product of the
    meta-run is exact)."""
    jsvc, jcounters, jcontroller, jjournal = _walk_service("jax", str(tmp_path / "j"), flat, grow)
    tsvc, tcounters, tcontroller, tjournal = _walk_service("torch", str(tmp_path / "t"), flat, grow)
    for tid in ("meta-a", "meta-b"):
        trec, jrec = tsvc.tenant(tid), jsvc.tenant(tid)
        assert trec.status.value == jrec.status.value == "completed"
        assert (trec.generations, trec.grows, trec.restarts) == (jrec.generations, jrec.grows, jrec.restarts)
        tfinal, jfinal = tsvc.result(tid), jsvc.result(tid)
        tseries, jseries = hpo.candidate_series(tfinal.problem), jhpo.candidate_series(jfinal.problem)
        assert sorted(tseries) == sorted(jseries) == list(range(CANDIDATES))
        for uid in tseries:
            assert np.array_equal(tseries[uid], np.asarray(jseries[uid]))
        same_values(values(tfinal.algorithm, "torch"), values(jfinal.algorithm, "jax"), f"{tid} outer state")
        same_values(values(tfinal.problem, "torch"), values(jfinal.problem, "jax"), f"{tid} nested state")
        assert find_nested(trec.spec.problem).inner_pop == jhpo.find_nested(jrec.spec.problem).inner_pop
    assert tcounters == jcounters
    inner = tcounters['evox_hpo_inner_generations_total{tenant_id="meta-a"}']
    assert inner == 8 * CANDIDATES * 8  # budget 8 outer generations, 4 candidates x 8 iterations
    if not grow:
        assert not any("grows" in k for k in tcounters)
        return
    assert tsvc.tenant("meta-a").grows >= 1
    assert tcounters['evox_hpo_grows_total{tenant_id="meta-a"}'] == tsvc.tenant("meta-a").grows
    decisions = [d.to_manifest() for d in tcontroller.decisions]
    assert decisions == [d.to_manifest() for d in jcontroller.decisions]
    assert decisions and all(d["kind"] == "hpo-grow" and d["action"].isdigit() for d in decisions)
    # Each package's journal replays through either package's deciders.
    for records in (tjournal.replay()[0], jjournal.replay()[0]):
        assert [d.to_manifest() for d in control.Controller.replay_decisions(records)] == decisions
        assert [d.to_manifest() for d in jcontrol.Controller.replay_decisions(records)] == decisions


# ---------------------------------------------------------------------------
# the port alone: the nested bulkhead
# ---------------------------------------------------------------------------

VICTIM_UID, BURSTER_UID = 5, 6
# Chaos on the INNER problem, keyed on the tenant uid the service stamps
# into every fault_lane leaf (nested instances included): only the
# burster's inner runs take NaN bursts.
INNER_LANE_FAULTS = {BURSTER_UID: {"nan_generations": tuple(range(1, 40)), "nan_rows": 8}}


def faulty_spec(tenant_id, uid, **kw):
    return es_spec(tenant_id, uid, problem=FaultyProblem(Sphere(), lane_faults=INNER_LANE_FAULTS), **kw)


@pytest.mark.parametrize("repeats", [{}, dict(num_repeats=2, aggregation="per_generation")],
                         ids=["one-repeat", "two-repeats"])
def test_hpo_tenant_isolated_from_nan_bursting_cotenant(tmp_path, repeats):
    """An HPO tenant packed beside an HPO cotenant whose inner runs burst NaN
    every generation finishes bit-equal to itself solo: final state,
    monitor history and newest checkpoint digests.  With two repeats the
    repeat reduction runs at the repeat level only, never across lanes."""
    packed = make_service(tmp_path / "packed")
    packed.submit(faulty_spec("victim", VICTIM_UID, **repeats))
    packed.submit(faulty_spec("burster", BURSTER_UID, **repeats))
    run(packed)
    solo = make_service(tmp_path / "solo")
    solo.submit(faulty_spec("victim", VICTIM_UID, **repeats))
    run(solo)
    for svc in (packed, solo):
        assert svc.tenant("victim").status is TenantStatus.COMPLETED
    assert_states_equal(packed.result("victim"), solo.result("victim"), "victim packed vs solo")
    hp, hs = history(packed, "victim"), history(solo, "victim")
    assert len(hp) == len(hs) > 0 and all(np.array_equal(a, b) for a, b in zip(hp, hs))
    assert newest_digests(tmp_path / "packed", "victim") == newest_digests(tmp_path / "solo", "victim")
    # The chaos was real (the burster's inner quarantine penalised it) and
    # nothing non-finite leaked into the burster's telemetry.
    burster = packed.result("burster").problem
    assert bool(torch.isfinite(burster.telemetry.best_fitness).all())
    assert not torch.equal(burster.telemetry.best_fitness, packed.result("victim").problem.telemetry.best_fitness)
    want = (CANDIDATES, 2, 3) if repeats else (CANDIDATES, 3)
    assert tuple(packed.result("victim").problem.telemetry.best_fitness.shape) == want


def test_fault_lane_reaches_every_nested_instance(tmp_path):
    """The service stamps the tenant's uid into the nested instances'
    ``fault_lane`` leaves (one a candidate): what keys the inner chaos."""
    svc = make_service(tmp_path / "svc")
    svc.submit(faulty_spec("burster", BURSTER_UID, n_steps=2))
    silent(svc.step)
    lane = svc.result("burster").problem.instances.problem.fault_lane
    assert lane.shape == (CANDIDATES,) and lane.tolist() == [BURSTER_UID] * CANDIDATES


# ---------------------------------------------------------------------------
# growth, readmission
# ---------------------------------------------------------------------------


def _grow_service(root, lanes=LANES):
    journal = RequestJournal(os.path.join(root, "journal.jsonl"))
    controller = control.Controller(journal=journal, grace=2)
    svc = make_service(os.path.join(root, "svc"), lanes_per_pack=lanes, controller=controller, max_restarts=2)
    return svc, controller, journal


def _grow_spec(uid=3):
    ladder = GrowthLadder(inner_factory=make_inner_es, stagnation_window=3, stagnation_tol=0.0, max_inner_pop=16)
    return es_spec("meta-grow", uid, problem=Plateau(), iterations=6, grow=ladder)


def test_service_hpo_grow_rekeys_bucket(tmp_path):
    """A stagnating packed ladder fires the journaled hpo-grow decision and
    regrows through the bucket re-key and lane surgery: a new bucket of
    inner population 16, uid, monitor and outer state kept, the run
    completes, and the journal replays the decisions bit for bit."""
    svc, controller, journal = _grow_service(str(tmp_path))
    record = svc.submit(_grow_spec())
    monitor = record.monitor
    grown_at = {}
    real = OptimizationService._grow_hpo

    def spying(self, bucket, rec, decision, state):
        grown_at["outer"] = state.algorithm
        out = real(self, bucket, rec, decision, state)
        grown_at["after"] = self._buckets[rec.bucket].pack.lane_state(rec.lane).algorithm
        return out

    OptimizationService._grow_hpo = spying
    try:
        run(svc)
    finally:
        OptimizationService._grow_hpo = real
    assert record.status is TenantStatus.COMPLETED and record.grows >= 1
    assert find_nested(record.spec.problem).inner_pop == 16 and record.uid == 3
    assert record.monitor is monitor and len(record.monitor.fitness_history) > 0
    assert_states_equal(grown_at["outer"], grown_at["after"], "outer state across the growth")
    assert svc.result("meta-grow").problem.instances.algorithm.center.shape == (CANDIDATES, DIM)
    assert sorted(find_nested(b.workflow.problem).inner_pop for b in svc._buckets.values()) == [8, 16]
    fired = [d for d in controller.decisions if d.kind == "hpo-grow"]
    assert fired and fired[0].tenant_id == "meta-grow" and fired[0].action == "16"
    records, damage = journal.replay()
    assert damage is None
    replayed = control.Controller.replay_decisions(records)
    assert [d.to_manifest() for d in replayed] == [d.to_manifest() for d in controller.decisions]
    counters = svc.obs.registry.snapshot()
    assert counters['evox_hpo_grows_total{tenant_id="meta-grow"}'] == record.grows


def test_growth_is_deterministic_and_parks_when_the_grown_bucket_is_full(tmp_path):
    """Two services with the same tenant grow at the same boundary to the
    same state; where the grown bucket has no free lane the tenant is
    parked on the grown checkpoint, and resubmitting its original spec
    resumes it there to the same final state."""
    a, _, _ = _grow_service(str(tmp_path / "a"))
    a.submit(_grow_spec())
    run(a)
    b, _, _ = _grow_service(str(tmp_path / "b"))
    b.submit(_grow_spec())
    run(b)
    assert_states_equal(a.result("meta-grow"), b.result("meta-grow"), "two runs of the growth")

    parked, _, _ = _grow_service(str(tmp_path / "p"))
    record = parked.submit(_grow_spec())
    grown_key = bucket_key(dataclasses.replace(_grow_spec(), problem=find_nested(_grow_spec().problem)
                                               .with_inner_pop(16, make_inner_es)))
    full = parked._bucket_for(dataclasses.replace(_grow_spec(), problem=find_nested(_grow_spec().problem)
                                                  .with_inner_pop(16, make_inner_es)))
    assert full.key == grown_key
    full.pack.occupants = [10**6] * full.pack.lanes  # no free lane in the grown bucket
    silent(parked.step)
    while record.grows == 0:
        silent(parked.step)
    assert record.status is TenantStatus.EVICTED and record.lane is None
    assert any("parked on the grown checkpoint" in e for e in record.events)
    full.pack.occupants = [None] * full.pack.lanes
    parked.submit(_grow_spec())  # the original (ungrown) spec
    assert find_nested(record.spec.problem).inner_pop == 16
    run(parked)
    assert record.status is TenantStatus.COMPLETED
    assert_states_equal(parked.result("meta-grow"), a.result("meta-grow"), "parked and resumed vs uninterrupted")


def test_readmission_preserves_applied_growth(tmp_path):
    """A growth-parked (EVICTED) tenant resubmitted with its original spec
    keeps the grown nest (the grown instance is the service's own); the
    resubmitted budget is still taken."""
    svc = make_service(tmp_path / "svc")
    spec = faulty_spec("meta", 9)
    record = svc.submit(spec)
    grown = find_nested(spec.problem).with_inner_pop(16, make_inner_es)
    record.spec = dataclasses.replace(record.spec, problem=grown)
    record.grows = 1
    record.status = TenantStatus.EVICTED
    svc._queue.clear()
    svc.submit(dataclasses.replace(spec, n_steps=8))
    assert find_nested(record.spec.problem) is grown
    assert record.spec.n_steps == 8
    # An ungrown tenant's readmission takes the resubmitted problem.
    other = svc.submit(faulty_spec("plain", 10))
    other.status = TenantStatus.EVICTED
    svc._queue.remove("plain")
    again = faulty_spec("plain", 10)
    svc.submit(again)
    assert other.spec.problem is again.problem


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def _daemon(root):
    return ServiceDaemon(root, lanes_per_pack=LANES, segment_steps=SEGMENT, seed=0,
                         health=HealthProbe(nonfinite_skip=("instances",)), exec_cache=None, preemption=False,
                         brownout_threshold=None, device="cpu")


def _daemon_submit_all(d):
    d.submit(es_spec("meta-1", 11))
    lb, ub = -10 * torch.ones(8), 10 * torch.ones(8)
    d.submit(TenantSpec("plain-1", PSO(16, lb, ub, device="cpu"), Ackley(), n_steps=6, uid=12))


def _drain(d, kill_after_rounds=None):
    rounds = 0
    while True:
        if kill_after_rounds is not None and rounds >= kill_after_rounds:
            return False  # SIGKILL model: abandoned mid-run, no close
        if not silent(d.step) and not d.service._queue:
            return True
        rounds += 1


def test_daemon_kill_restart_hpo_tenant_bit_identical(tmp_path):
    """An HPO tenant packed into a daemon beside an ordinary tenant survives
    a kill and restart (journal replay, the spec through the journal's
    encoding, namespace resume) bit-equal to an uninterrupted daemon:
    state, newest checkpoint digests and the restarted monitor's history
    tail."""
    ref = _daemon(tmp_path / "ref")
    ref.start()
    _daemon_submit_all(ref)
    assert _drain(ref)
    cut = _daemon(tmp_path / "cut")
    cut.start()
    _daemon_submit_all(cut)
    assert not _drain(cut, kill_after_rounds=2)
    restarted = _daemon(tmp_path / "cut")
    assert restarted.start() == 2
    spec = restarted.tenant("meta-1").spec
    assert spec.workload == "hpo" and find_nested(spec.problem) is not None
    assert spec.solution_transform is es_transform
    assert _drain(restarted)
    for tid in ("meta-1", "plain-1"):
        assert restarted.tenant(tid).status is TenantStatus.COMPLETED
        assert_states_equal(ref.result(tid), restarted.result(tid), tid)
        assert newest_digests(tmp_path / "ref", tid) == newest_digests(tmp_path / "cut", tid)
    hr, hc = history(ref.service, "meta-1"), history(restarted.service, "meta-1")
    assert hc and all(np.array_equal(a, b) for a, b in zip(hr[-len(hc):], hc))


def test_hpo_spec_round_trips_the_journal_encoding(tmp_path):
    """A journaled HPO spec decodes with its workload, nest, growth ladder
    (factory included) and transform, in the same bucket as before; its
    nest carries no captured graph across; a daemon prewarms its bucket
    with the nest inline in the bucket's programs."""
    ladder = GrowthLadder(inner_factory=make_inner_es, stagnation_window=2, max_inner_pop=32)
    spec = es_spec("meta", 4, grow=ladder)
    find_nested(spec.problem)._graphs.graphs["stale"] = object()  # a capture must not cross the journal
    back = _decode_spec(_encode_spec(spec), torch.device("cpu"))
    assert back.workload == "hpo" and back.grow.inner_factory is make_inner_es
    assert back.solution_transform is es_transform and back.grow.max_inner_pop == 32
    assert bucket_key(back) == bucket_key(spec)
    assert len(find_nested(back.problem)._graphs) == 0
    grown = dataclasses.replace(spec, problem=find_nested(spec.problem).with_inner_pop(16, make_inner_es))
    assert bucket_key(_decode_spec(_encode_spec(grown), torch.device("cpu"))) == bucket_key(grown) != bucket_key(spec)
    d = ServiceDaemon(tmp_path / "d", lanes_per_pack=LANES, segment_steps=SEGMENT, preemption=False,
                      brownout_threshold=None, device="cpu")
    d.start()
    d.submit(spec)
    labels = sorted(d.stats.prewarmed)
    assert len(labels) == 2 and labels[0].startswith("pack_init[PSO[4x2]") and "[n=2]" in labels[1]
    assert d.exec_cache.stats.saves == 2
    d.close()


# ---------------------------------------------------------------------------
# the kernels' batching rules under the nest's vmap inside the pack's
# ---------------------------------------------------------------------------


def _counting(monkeypatch):
    """Count the plain move's and the plain draws' calls (what ``_op`` runs
    on the CPU, once a merged launch) with each call's instances."""
    calls = {"move": [], "draws": []}
    move, draws = pso_step.fused_pso_move_batched_plain, philox.philox_draws_batched_plain

    def counting_move(pop, *a, **kw):
        calls["move"].append(int(pop.shape[0]))
        return move(pop, *a, **kw)

    def counting_draws(keys, *a, **kw):
        calls["draws"].append(int(keys.shape[0]))
        return draws(keys, *a, **kw)

    monkeypatch.setattr(pso_step, "fused_pso_move_batched_plain", counting_move)
    monkeypatch.setattr(philox, "philox_draws_batched_plain", counting_draws)
    return calls


@pytest.mark.parametrize("nest", ["pso_over_openes", "cmaes_over_pso"])
def test_packed_segment_merges_each_kernel_into_one_call_a_generation(tmp_path, monkeypatch, nest):
    """In a packed HPO segment the batching rules compose over both vmap
    levels: the plain draws (OpenES's normals) or the plain move (the inner
    PSO) run once an inner generation with lanes x candidates instances,
    never lanes x candidates times; the outer algorithm's kernel once an
    outer generation with one instance a lane."""
    svc = make_service(tmp_path / "svc")
    make = es_spec if nest == "pso_over_openes" else cmaes_spec
    for uid in range(2):
        svc.submit(make(f"t{uid}", uid))
    silent(svc.step)  # the admissions' setups and init programs, and one segment
    calls = _counting(monkeypatch)
    bucket = next(iter(svc._buckets.values()))
    silent(bucket.pack.run_segment, SEGMENT)
    iterations, merged = 5, LANES * CANDIDATES
    if nest == "pso_over_openes":
        # OpenES draws once a step (init_step, 3 segment steps, final_step);
        # the outer PSO moves once an outer generation, drawing in-kernel.
        assert calls["draws"] == [merged] * (SEGMENT * iterations)
        assert calls["move"] == [LANES] * SEGMENT
    else:
        # The inner PSO moves every step but its init_step; CMA-ES draws
        # its normals once an outer generation.
        assert calls["move"] == [merged] * (SEGMENT * (iterations - 1))
        assert calls["draws"] == [LANES] * SEGMENT


def test_merged_draws_keep_each_instances_own_key():
    """Philox under a vmap over lanes of a vmap over candidates draws what a
    solo call with each instance's key draws, and the move merged the same
    way equals each instance's own move: a packed tenant's draws are its
    solo run's."""
    base = rng.key(7, "cpu")
    keys = torch.stack([torch.stack([rng.fold_in(rng.fold_in(base, lane), c) for c in range(3)])
                        for lane in range(2)])
    seeds = torch.func.vmap(torch.func.vmap(lambda k: philox.philox_draws(rng.Seed(k, 1), 12, [torch.float32],
                                                                         "cpu")[0]))(keys)
    for lane in range(2):
        for c in range(3):
            solo = philox.philox_draws(rng.Seed(keys[lane, c], 1), 12, [torch.float32], "cpu")[0]
            assert torch.equal(seeds[lane, c], solo)
    assert len({tuple(r.tolist()) for r in seeds.reshape(6, 12)}) == 6


def test_pack_of_nests_equals_the_nest_run_alone(tmp_path):
    """A lane of a pack of nests equals its tenant's workflow stepped alone
    (outside any pack, the nest's own vmap only): the lane vmap adds no
    value of its own."""
    spec = es_spec("solo", 2)
    svc = make_service(tmp_path / "svc")
    svc.submit(spec)
    svc.submit(es_spec("other", 3))
    run(svc)
    bucket = next(iter(svc._buckets.values()))
    wf = bucket.workflow
    from evox_tpu_torch.service.pack import assign_fault_lane

    state = wf.init_step(assign_fault_lane(wf.setup(rng.fold_in(rng.key(0, "cpu"), 2), instance_id=2), 2))
    for _ in range(svc.tenant("solo").generations - 1):
        state = wf.step(state)
    got = svc.result("solo")
    assert_states_equal(got.algorithm, state.algorithm, "outer state, packed vs stepped alone")
    assert_states_equal(got.problem, state.problem, "nested state, packed vs stepped alone")


class _CpuCapture:
    """torch.cuda's stream and graph calls as ``graph._capture`` makes them,
    stood in for on the CPU: the warm-up runs the program eagerly, and the
    capture runs it again with ``is_current_stream_capturing()`` true."""

    def __init__(self, monkeypatch):
        self.capturing = False
        stream = type("Stream", (), {"wait_stream": lambda self, other: None})
        for name, value in {
            "current_stream": lambda device=None: stream(),
            "Stream": lambda device=None: stream(),
            "stream": lambda s: contextlib.nullcontext(),
            "synchronize": lambda device=None: None,
            "CUDAGraph": object,
            "graph": self._graph,
            "is_current_stream_capturing": lambda: self.capturing,
        }.items():
            monkeypatch.setattr(torch.cuda, name, value)

    @contextlib.contextmanager
    def _graph(self, g, pool=None):
        self.capturing = True
        try:
            yield
        finally:
            self.capturing = False


def test_pack_programs_run_their_nests_inline(tmp_path, monkeypatch):
    """A pack's init and segment programs captured as ``graph._capture``
    captures them (its torch.cuda calls stood in for on the CPU, and
    ``graph.replays`` judging as it would on the card) run the nest inline
    in the warm-up and in the capture: the nest calls ``graph.run`` never
    and captures no graph of its own beside the pack's."""
    from evox_tpu_torch.utils import graph

    svc = make_service(tmp_path / "svc")
    svc.submit(es_spec("t", 1, n_steps=2))
    silent(svc.step)
    pack = next(iter(svc._buckets.values())).pack
    nest = find_nested(pack.workflow.problem)
    real = graph.replays
    judged, nest_runs = [], []

    def on_the_card(device):
        judged.append(real(torch.device("cuda")))
        return judged[-1]

    monkeypatch.setattr(graph, "replays", on_the_card)
    monkeypatch.setattr(graph, "run", lambda *a, **kw: nest_runs.append(a) or pytest.fail("a nest replays"))
    capture = _CpuCapture(monkeypatch)
    for program, carry in (
        (pack._init_program, (pack.lane_state(0),)),
        (pack._segment_program, (pack._states, pack._frozen_dev, torch.zeros((LANES,), dtype=torch.int32))),
    ):
        leaves, spec = graph.flatten(carry)
        inputs = [t.clone() for t in leaves]
        graph._capture(program, inputs, spec, leaves, graph.structure(carry), SEGMENT, None)
    assert not capture.capturing
    # The init program's warm-up and capture (one evaluation each), the
    # segment's warm-up and capture (1 and SEGMENT evaluations).
    assert len(judged) == 2 + 1 + SEGMENT and not any(judged)
    assert nest_runs == [] and len(nest._graphs) == 0
