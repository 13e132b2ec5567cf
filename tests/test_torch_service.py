"""The port's multi-tenant service (``evox_tpu_torch/service``) on the CPU.

Against the JAX package, exactly: ``validate_tenant_id`` and
``TenantSpec``'s errors on a table of cases, ``bucket_key``'s equal/unequal
partition on the JAX tests' pairs (the digests themselves differ: each
package hashes its own objects), and ``retry_after_seconds``.

The port alone: one counterpart of each test of ``tests/test_service.py``
(the JAX package's service suite), at its sizes (POP 16, DIM 8, 4 lanes,
segments of 4).  The headline is the bulkhead: a PSO and an OpenES tenant
packed beside a NaN-bursting, a stagnating and an evicted-and-readmitted
cotenant finishes with the state, monitor counters, history and checkpoint
leaf digests of the same tenant alone, bit for bit.  The packs' captured
graphs are held on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import os
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Ackley as JAckley  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.service import TenantSpec as JTenantSpec  # noqa: E402
from evox_tpu.service import bucket_key as jbucket_key  # noqa: E402
from evox_tpu.service import retry_after_seconds as jretry_after_seconds  # noqa: E402
from evox_tpu.service import validate_tenant_id as jvalidate_tenant_id  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.algorithms.so.es_variants import OpenES  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley, Sphere  # noqa: E402
from evox_tpu_torch.resilience import FaultyProblem, HealthProbe, Preempted, PreemptionGuard  # noqa: E402
from evox_tpu_torch.resilience.runner import scan_checkpoints  # noqa: E402
from evox_tpu_torch.service import (  # noqa: E402
    AdmissionError,
    OptimizationService,
    Rejection,
    TenantSpec,
    TenantStatus,
    bucket_key,
    retry_after_seconds,
    static_signature,
    validate_tenant_id,
)
from evox_tpu_torch.utils import graph, read_manifest, rng, save_state  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

DIM = 8
POP = 16
LB = torch.full((DIM,), -32.0)
UB = torch.full((DIM,), 32.0)


def assert_states_equal(a, b, context=""):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb, context
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (context, i)
        assert torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
            and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        ), f"{context}: leaf {i} differs"


def make_service(root, **overrides):
    kwargs = dict(
        lanes_per_pack=4,
        segment_steps=4,
        seed=0,
        health=HealthProbe(stagnation_window=2, stagnation_tol=0.0),
        max_restarts=1,
    )
    kwargs.update(overrides)
    return OptimizationService(root, **kwargs)


# The JAX tests' tenant-keyed chaos plans: uid 1 = NaN burst, uid 2 =
# stagnation plateau.
LANE_FAULTS = {
    1: {"nan_generations": tuple(range(3, 40)), "nan_rows": POP},
    2: {"plateau_from": 2, "plateau_floor": 50.0},
}
ES_LANE_FAULTS = {
    1: {"nan_generations": tuple(range(3, 40)), "nan_rows": POP},
    2: {"plateau_from": 2, "plateau_floor": 600.0},
}


def pso(**kw):
    return PSO(POP, LB, UB, device="cpu", **kw)


def pso_spec(name, uid, n_steps=21):
    return TenantSpec(name, pso(), FaultyProblem(Ackley(), lane_faults=LANE_FAULTS), n_steps=n_steps, uid=uid)


def openes_spec(name, uid, n_steps=21):
    return TenantSpec(
        name,
        OpenES(POP, torch.full((DIM,), 8.0), learning_rate=0.1, noise_stdev=0.1, optimizer="adam", device="cpu"),
        FaultyProblem(Sphere(), lane_faults=ES_LANE_FAULTS),
        n_steps=n_steps,
        uid=uid,
    )


def last_checkpoint_digests(root, tenant_id):
    ns = os.path.join(root, "tenants", tenant_id)
    newest = sorted(f for f in os.listdir(ns) if f.endswith(".npz"))[-1]
    manifest = read_manifest(os.path.join(ns, newest))
    return newest, manifest["leaf_digests"]


def run_silently(svc, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.run(*args, **kwargs)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

IDS = ["ok-1", "a.b_c-D", "", ".", "..", "...", "a/b", "../x", "x%2f", "nul\x00", 7, None, "x" * 128, "x" * 129,
       "tenant id"]


@pytest.mark.parametrize("tenant_id", IDS, ids=[repr(i)[:12] for i in IDS])
def test_validate_tenant_id_equals_jax(tenant_id):
    outcomes = []
    for fn in (jvalidate_tenant_id, validate_tenant_id):
        try:
            outcomes.append(("ok", fn(tenant_id)))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


SPEC_CASES = [
    dict(tenant_id="ok", n_steps=4),
    dict(tenant_id="../up", n_steps=4),
    dict(tenant_id="ok", n_steps=0),
    dict(tenant_id="ok", n_steps=4, uid=-1),
    dict(tenant_id="ok", n_steps=4, workload="batch"),
    dict(tenant_id="ok", n_steps=4, grow=object()),
    dict(tenant_id="ok", n_steps=4, key_impl="rbg"),
    dict(tenant_id="ok", n_steps=4, key_impl="nonsense"),
]


@pytest.mark.parametrize("case", SPEC_CASES, ids=[str(i) for i in range(len(SPEC_CASES))])
def test_tenant_spec_errors_equal_jax(case):
    outcomes = []
    for cls, algo, prob in ((JTenantSpec, JPSO(POP, -jnp.ones(DIM), jnp.ones(DIM)), JAckley()),
                            (TenantSpec, pso(), Ackley())):
        try:
            spec = cls(algorithm=algo, problem=prob, **case)
            outcomes.append(("ok", spec.tenant_id, spec.key_impl))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]


def test_bucket_key_partition_equals_jax():
    """test_bucket_key_splits_on_static_config's pairs, and more: the two
    packages split buckets at the same places."""
    jlb, jub = -32 * jnp.ones(DIM), 32 * jnp.ones(DIM)

    def tf(x):
        return x * 2.0

    def tf2(x):
        return x * 3.0

    pairs = {
        "a": (JTenantSpec("a", JPSO(POP, jlb, jub), JAckley(), n_steps=4),
              TenantSpec("a", pso(), Ackley(), n_steps=4)),
        "b": (JTenantSpec("b", JPSO(POP, jlb, jub), JAckley(), n_steps=8),
              TenantSpec("b", pso(), Ackley(), n_steps=8)),
        "c": (JTenantSpec("c", JPSO(POP, jlb, jub, w=0.9), JAckley(), n_steps=4),
              TenantSpec("c", pso(w=0.9), Ackley(), n_steps=4)),
        "d": (JTenantSpec("d", JPSO(POP, jlb, jub), JSphere(), n_steps=4),
              TenantSpec("d", pso(), Sphere(), n_steps=4)),
        "e": (JTenantSpec("e", JPSO(2 * POP, jlb, jub), JAckley(), n_steps=4),
              TenantSpec("e", PSO(2 * POP, LB, UB, device="cpu"), Ackley(), n_steps=4)),
        "f": (JTenantSpec("f", JPSO(POP, 2 * jlb, jub), JAckley(), n_steps=4),
              TenantSpec("f", PSO(POP, 2 * LB, UB, device="cpu"), Ackley(), n_steps=4)),
        "g": (JTenantSpec("g", JPSO(POP, jlb, jub), JAckley(), n_steps=4, solution_transform=tf),
              TenantSpec("g", pso(), Ackley(), n_steps=4, solution_transform=tf)),
        "h": (JTenantSpec("h", JPSO(POP, jlb, jub), JAckley(), n_steps=4, solution_transform=tf2),
              TenantSpec("h", pso(), Ackley(), n_steps=4, solution_transform=tf2)),
        "i": (JTenantSpec("i", JPSO(POP, jlb, jub), JAckley(), n_steps=4, key_impl="rbg"),
              TenantSpec("i", pso(), Ackley(), n_steps=4, key_impl="rbg")),
        "j": (JTenantSpec("j", JPSO(POP, jlb, jub), JAckley(a=10.0), n_steps=4),
              TenantSpec("j", pso(), Ackley(a=10.0), n_steps=4)),
    }
    names = sorted(pairs)
    for x in names:
        for y in names:
            jsame = jbucket_key(pairs[x][0]) == jbucket_key(pairs[y][0])
            same = bucket_key(pairs[x][1]) == bucket_key(pairs[y][1])
            assert jsame == same, (x, y)
    assert bucket_key(pairs["a"][1]) == bucket_key(pairs["b"][1])
    # Over-splitting by device is the port's own (a CPU and a card
    # template are different programs).
    class Component:
        def __init__(self, device):
            self.device = torch.device(device)

    assert static_signature(Component("cpu")) != static_signature(Component("cuda"))
    assert static_signature(Component("cpu")) == static_signature(Component("cpu"))


@pytest.mark.parametrize("segments, seconds", [(None, 1.0), (3, None), (3, 0.0), (3, -1.0), (0, 2.5), (4, 0.25)])
def test_retry_after_seconds_equals_jax(segments, seconds):
    assert retry_after_seconds(segments, seconds) == jretry_after_seconds(segments, seconds)


def test_rejection_pickles_with_its_hints():
    r = Rejection("t", "queue-full", 3, 1.5)
    back = pickle.loads(pickle.dumps(r))
    assert back == ("t", "queue-full") and back.retry_after_segments == 3 and back.retry_after_seconds == 1.5


# ---------------------------------------------------------------------------
# the bulkhead proof (the JAX suite's acceptance test)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_fn", [pso_spec, openes_spec], ids=["pso", "openes"])
def test_bulkhead_bit_identity_solo_vs_hostile_pack(tmp_path, spec_fn):
    solo = make_service(tmp_path / "solo")
    solo.submit(spec_fn("tenant-T", 0))
    run_silently(solo)
    assert solo.tenant("tenant-T").status is TenantStatus.COMPLETED
    solo_final = solo.result("tenant-T")

    packed = make_service(tmp_path / "packed")
    packed.submit(spec_fn("tenant-T", 0))
    packed.submit(spec_fn("nan-burst", 1))
    packed.submit(spec_fn("stagnator", 2))
    packed.submit(spec_fn("victim", 3, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        packed.step()
        packed.step()
        packed.evict("victim")
        packed.step()
        packed.submit(spec_fn("victim", 3, n_steps=24))  # readmission
    run_silently(packed)

    assert packed.tenant("nan-burst").status is TenantStatus.QUARANTINED
    assert packed.tenant("stagnator").status is TenantStatus.QUARANTINED
    assert packed.tenant("stagnator").restarts == 1
    assert packed.tenant("victim").status is TenantStatus.COMPLETED
    assert packed.stats.restarts >= 1
    assert packed.stats.evictions == 1
    assert packed.stats.readmissions == 1

    packed_final = packed.result("tenant-T")
    assert_states_equal(solo_final, packed_final, "final state")
    for counter in ("num_nonfinite", "num_restarts", "num_preemptions"):
        assert int(solo_final["monitor"][counter]) == int(packed_final["monitor"][counter])
    solo_hist = solo.tenant("tenant-T").monitor.fitness_history
    packed_hist = packed.tenant("tenant-T").monitor.fitness_history
    assert len(solo_hist) == len(packed_hist) == 21
    for a, b in zip(solo_hist, packed_hist):
        assert torch.equal(a, b)
    name_a, digests_a = last_checkpoint_digests(tmp_path / "solo", "tenant-T")
    name_b, digests_b = last_checkpoint_digests(tmp_path / "packed", "tenant-T")
    assert name_a == name_b
    assert digests_a == digests_b


def test_packed_cotenant_counters_see_their_own_faults(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("tenant-T", 0))
    svc.submit(pso_spec("nan-burst", 1))
    run_silently(svc)
    t_mon = svc.result("tenant-T")["monitor"]
    rec = svc.tenant("nan-burst")
    nan_state = svc._buckets[rec.bucket].pack.lane_state(rec.lane)
    assert int(t_mon["num_nonfinite"]) == 0
    assert int(nan_state["monitor"]["num_nonfinite"]) > 0
    assert int(nan_state["monitor"]["instance_id"]) == 1
    assert int(t_mon["instance_id"]) == 0


# ---------------------------------------------------------------------------
# pack mechanics through the service
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_fn", [pso_spec, openes_spec], ids=["pso", "openes"])
def test_pack_width_invariance_bit_identical(tmp_path, spec_fn):
    finals = {}
    for lanes in (1, 4, 8):
        svc = make_service(tmp_path / f"w{lanes}", lanes_per_pack=lanes)
        svc.submit(spec_fn("t", 0))
        run_silently(svc)
        finals[lanes] = svc.result("t")
    assert_states_equal(finals[1], finals[4], "width 1 vs 4")
    assert_states_equal(finals[1], finals[8], "width 1 vs 8")


def test_frozen_lane_is_noop_and_thaw_resumes(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("a", 0, n_steps=40))
    svc.submit(pso_spec("b", 5, n_steps=40))
    svc.step()
    rec = svc.tenant("b")
    bucket = svc._buckets[rec.bucket]
    before = bucket.pack.lane_state(rec.lane)
    bucket.pack.set_frozen(rec.lane, True)
    gens_before = rec.generations
    svc.step()
    assert_states_equal(before, bucket.pack.lane_state(rec.lane), "frozen lane")
    assert rec.generations == gens_before
    bucket.pack.set_frozen(rec.lane, False)
    svc.step()
    assert rec.generations == gens_before + svc.segment_steps


def test_budget_quantized_to_segment_boundaries(tmp_path):
    svc = make_service(tmp_path, segment_steps=4)
    svc.submit(pso_spec("t", 0, n_steps=10))
    run_silently(svc)
    # init (1) + 3 segments of 4 = 13: the first boundary at or past it.
    assert svc.tenant("t").generations == 13
    assert svc.tenant("t").status is TenantStatus.COMPLETED


def test_different_shapes_land_in_different_buckets(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("p", 0))
    svc.submit(openes_spec("e", 10))
    svc.submit(TenantSpec("p2", PSO(32, LB, UB, device="cpu"), Ackley(), n_steps=9, uid=20))
    run_silently(svc)
    buckets = {svc.tenant(t).bucket for t in ("p", "e", "p2")}
    assert len(buckets) == 3
    assert all(svc.tenant(t).status is TenantStatus.COMPLETED for t in ("p", "e", "p2"))


def test_bucket_key_splits_on_static_config():
    a = TenantSpec("a", pso(), Ackley(), n_steps=4)
    b = TenantSpec("b", pso(), Ackley(), n_steps=8)
    c = TenantSpec("c", pso(w=0.9), Ackley(), n_steps=4)
    d = TenantSpec("d", pso(), Sphere(), n_steps=4)
    assert bucket_key(a) == bucket_key(b)
    assert bucket_key(a) != bucket_key(c)
    assert bucket_key(a) != bucket_key(d)


# ---------------------------------------------------------------------------
# continuous batching: admission, retirement, queueing
# ---------------------------------------------------------------------------


def test_queued_tenant_waits_for_free_lane_then_runs(tmp_path):
    svc = make_service(tmp_path, lanes_per_pack=2, segment_steps=4)
    svc.submit(pso_spec("a", 10, n_steps=9))
    svc.submit(pso_spec("b", 11, n_steps=9))
    svc.submit(pso_spec("c", 12, n_steps=5))
    svc.step()
    assert svc.tenant("c").status is TenantStatus.QUEUED
    run_silently(svc)
    assert svc.tenant("c").status is TenantStatus.COMPLETED
    assert svc.stats.admitted == 3


def test_overload_rejects_with_reason_never_silently(tmp_path):
    svc = make_service(tmp_path, max_queue=2)
    svc.submit(pso_spec("a", 0))
    svc.submit(pso_spec("b", 1))
    with pytest.raises(AdmissionError) as err:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            svc.submit(pso_spec("c", 2))
    assert err.value.reason == "queue-full" and err.value.retry_after_segments == 1
    assert ("c", "queue-full") in svc.stats.rejections
    with pytest.raises(KeyError):
        svc.tenant("c")


def test_readmission_with_conflicting_uid_rejected(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("t", 0, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.step()
        svc.evict("t")
        with pytest.raises(AdmissionError) as err:
            svc.submit(pso_spec("t", 7, n_steps=24))
    assert err.value.reason == "uid-mismatch"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.submit(pso_spec("t", 0, n_steps=24))
    run_silently(svc)
    assert svc.tenant("t").status is TenantStatus.COMPLETED


def test_id_collision_rejected(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("a", 0))
    with pytest.raises(AdmissionError) as err:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            svc.submit(pso_spec("a", 7))
    assert err.value.reason == "id-collision"


def test_eviction_readmission_resumes_bit_identically(tmp_path):
    base = make_service(tmp_path / "base")
    base.submit(pso_spec("t", 0, n_steps=24))
    run_silently(base)

    svc = make_service(tmp_path / "evicted")
    svc.submit(pso_spec("t", 0, n_steps=24))
    svc.submit(pso_spec("other", 9, n_steps=40))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.step()
        svc.evict("t")
        assert svc.tenant("t").status is TenantStatus.EVICTED
        svc.step()
        svc.submit(pso_spec("t", 0, n_steps=24))
    run_silently(svc)
    assert svc.tenant("t").status is TenantStatus.COMPLETED
    assert_states_equal(base.result("t"), svc.result("t"), "evict/readmit resume")


def test_readmission_after_process_death_resumes_from_namespace(tmp_path):
    first = make_service(tmp_path)
    first.submit(pso_spec("t", 0, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        first.step()
        first.step()
    gens = first.tenant("t").generations
    del first

    second = make_service(tmp_path)
    second.submit(pso_spec("t", 0, n_steps=24))
    run_silently(second)
    rec = second.tenant("t")
    assert rec.status is TenantStatus.COMPLETED
    assert any("resumed from" in e for e in rec.events)

    base = make_service(tmp_path / "base")
    base.submit(pso_spec("t", 0, n_steps=24))
    run_silently(base)
    assert_states_equal(base.result("t"), second.result("t"), "cross-process resume")
    assert gens < rec.generations


# ---------------------------------------------------------------------------
# per-tenant telemetry demux
# ---------------------------------------------------------------------------


def test_history_demux_matches_plain_solo_run_entry_for_entry(tmp_path):
    """The demuxed history equals a plain solo run's, entry for entry and
    bit for bit (the packed program is the solo generations under vmap)."""
    svc = make_service(tmp_path)
    svc.submit(pso_spec("t", 0, n_steps=13))
    svc.submit(pso_spec("noise", 7, n_steps=13))
    run_silently(svc)
    packed_hist = svc.tenant("t").monitor.fitness_history

    monitor = EvalMonitor(ordered=False)
    wf = StdWorkflow(pso(), FaultyProblem(Ackley(), lane_faults=LANE_FAULTS), monitor=monitor)
    key = rng.fold_in(rng.key(0), 0)
    state = wf.init_step(wf.init(key, 0))
    for _ in range(12):
        state = wf.step(state)
    plain_hist = monitor.fitness_history

    assert len(packed_hist) == len(plain_hist) == 13
    for a, b in zip(packed_hist, plain_hist):
        assert torch.equal(a, b)
    raw = svc.tenant("t").monitor._history[0]
    assert {int(inst) for (_, inst, _, _) in raw} == {0}


def test_ingest_sinks_lane_demux_requires_batched_telemetry():
    mon = EvalMonitor(ordered=False)
    with pytest.raises(ValueError, match="VMAPPED"):
        mon.ingest_sinks([(0, 0)], [(np.zeros((3, POP)), np.arange(3), np.zeros(3))], np.int32(3), lane=0)


# ---------------------------------------------------------------------------
# lane-aware health
# ---------------------------------------------------------------------------


def test_check_lanes_per_lane_verdicts_and_windows():
    probe = HealthProbe(stagnation_window=2, stagnation_tol=0.0)
    wf = StdWorkflow(pso(), Ackley(), monitor=EvalMonitor(ordered=False))
    keys = torch.stack([rng.fold_in(rng.key(1), i) for i in range(2)])
    states = torch.func.vmap(wf.init)(keys, torch.arange(2))
    states = torch.func.vmap(wf.init_step)(states)
    fit = states.algorithm.fit.clone()
    fit[1] = float("nan")
    states = states.replace(algorithm=states.algorithm.replace(fit=fit))
    reports = probe.check_lanes(states, lane_ids=[(0, 100), (1, 200)])
    assert reports[0].healthy
    assert not reports[1].healthy
    assert "non-finite" in reports[1].reasons[0]
    assert len(probe.lane_window(100)) == 1
    assert len(probe.lane_window(200)) == 1
    probe.reset_lane(200)
    assert probe.lane_window(200) == ()
    probe.restore_lane(100, [1.0, 0.5])
    assert probe.lane_window(100) == (1.0, 0.5)


def test_unhealthy_lane_restarts_then_quarantines_without_neighbors(tmp_path):
    svc = make_service(tmp_path / "packed", max_restarts=1)
    svc.submit(pso_spec("stagnator", 2, n_steps=60))
    svc.submit(pso_spec("healthy", 0, n_steps=60))
    run_silently(svc)
    stag = svc.tenant("stagnator")
    assert stag.restarts == 1
    assert stag.status is TenantStatus.QUARANTINED
    assert int(svc._buckets[stag.bucket].pack.lane_state(stag.lane)["monitor"]["num_restarts"]) == 1
    # The neighbour's fate is its own: the same verdicts, restarts and bits
    # as the same tenant alone (whether its own stream stalls on Ackley
    # within 60 generations is its trajectory's business, not the
    # stagnator's).
    alone = make_service(tmp_path / "alone", max_restarts=1)
    alone.submit(pso_spec("healthy", 0, n_steps=60))
    run_silently(alone)
    got, want = svc.tenant("healthy"), alone.tenant("healthy")
    assert (got.status, got.restarts, got.generations) == (want.status, want.restarts, want.generations)
    assert_states_equal(svc.result("healthy"), alone.result("healthy"), "neighbour vs alone")
    hist = stag.monitor.fitness_history
    assert len(hist) == stag.generations


# ---------------------------------------------------------------------------
# tenant-keyed chaos
# ---------------------------------------------------------------------------


def test_lane_faults_only_touch_their_lane(tmp_path):
    svc = make_service(tmp_path, health=HealthProbe(), max_restarts=0)
    svc.submit(pso_spec("clean", 0, n_steps=13))
    svc.submit(pso_spec("dirty", 1, n_steps=13))
    run_silently(svc)
    for name, expect_nan in (("clean", False), ("dirty", True)):
        rec = svc.tenant(name)
        state = rec.result if rec.result is not None else svc._buckets[rec.bucket].pack.lane_state(rec.lane)
        count = int(state["monitor"]["num_nonfinite"])
        assert (count > 0) is expect_nan, (name, count)


def test_lane_fault_validation_rejects_unknown_and_conflicting():
    with pytest.raises(ValueError, match="unknown fault field"):
        FaultyProblem(Ackley(), lane_faults={1: {"nan_gens": (1,)}})
    with pytest.raises(ValueError, match="lane_faults keys"):
        FaultyProblem(Ackley(), lane_faults={-3: {"nan_generations": (1,)}})
    with pytest.raises(ValueError, match="negative index"):
        FaultyProblem(Ackley(), nan_generations=(-1,))
    with pytest.raises(ValueError, match="plateau_until"):
        FaultyProblem(Ackley(), plateau_from=5, plateau_until=2)
    with pytest.raises(ValueError, match="plateau_until without"):
        FaultyProblem(Ackley(), plateau_until=4)
    with pytest.raises(ValueError, match="plateau_until without"):
        FaultyProblem(Ackley(), lane_faults={2: {"plateau_until": 5, "plateau_floor": 9.9}})
    with pytest.raises(ValueError, match="never fire"):
        FaultyProblem(Ackley(), dead_shards={9: (1,)}, shards=4)
    with pytest.raises(ValueError, match="eval_deadline"):
        FaultyProblem(Ackley(), eval_deadline=0.0)
    with pytest.raises(ValueError, match="must be >= 0"):
        FaultyProblem(Ackley(), error_times=-1)


def test_lane_delay_fires_only_for_scheduled_lane(tmp_path):
    prob = FaultyProblem(Ackley(), lane_faults={1: {"delay_generations": (2,), "delay_seconds": 0.01}})
    svc = make_service(tmp_path, health=HealthProbe())
    svc.submit(TenantSpec("a", pso(), prob, n_steps=9, uid=0))
    svc.submit(TenantSpec("b", pso(), prob, n_steps=9, uid=1))
    run_silently(svc)
    template = svc._buckets[svc.tenant("a").bucket].workflow.problem
    assert template.attempts("lane_delay1", 2) == 1
    assert template.attempts("lane_delay0", 2) == 0
    assert not svc._buckets[svc.tenant("a").bucket].pack.capturable


# ---------------------------------------------------------------------------
# checkpoint namespaces and the manifest-only scan
# ---------------------------------------------------------------------------


def test_per_tenant_namespaces_are_disjoint(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("a", 0, n_steps=9))
    svc.submit(pso_spec("b", 1, n_steps=9))
    run_silently(svc)
    ns_a = sorted(os.listdir(tmp_path / "tenants" / "a"))
    ns_b = sorted(os.listdir(tmp_path / "tenants" / "b"))
    assert ns_a and ns_b
    for f in ns_a + ns_b:
        assert f.startswith("ckpt_")
    manifest = read_manifest(tmp_path / "tenants" / "a" / ns_a[-1])
    assert manifest["tenant_id"] == "a"
    assert manifest["uid"] == 0
    assert "lane_health_window" in manifest


def test_manifest_scan_accepts_leaf_damage_full_load_rejects(tmp_path):
    state = {"a": torch.arange(4096.0), "key": rng.key(42)}
    d = tmp_path / "ns"
    d.mkdir()
    for gen in (4, 8):
        save_state(d / f"ckpt_{gen:08d}.npz", state, generation=gen)
    newest = d / "ckpt_00000008.npz"
    with open(newest, "r+b") as f:
        f.seek(2000)
        byte = f.read(1)
        f.seek(2000)
        f.write(bytes([byte[0] ^ 1]))
    valid, rejected = scan_checkpoints(d, verify="manifest")
    assert [g for g, _ in valid] == [4, 8]
    assert rejected == []
    full_valid, full_rejected = scan_checkpoints(d, verify=True)
    assert [g for g, _ in full_valid] == [4]
    assert len(full_rejected) == 1


def test_manifest_scan_still_quarantines_truncation(tmp_path):
    state = {"a": torch.arange(64.0)}
    d = tmp_path / "ns"
    d.mkdir()
    save_state(d / "ckpt_00000004.npz", state, generation=4)
    save_state(d / "ckpt_00000008.npz", state, generation=8)
    newest = d / "ckpt_00000008.npz"
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    valid, rejected = scan_checkpoints(d, verify="manifest", quarantine=True)
    assert [g for g, _ in valid] == [4]
    assert len(rejected) == 1 and rejected[0][2]
    assert not newest.exists()


def test_scan_checkpoints_rejects_unknown_verify_mode(tmp_path):
    with pytest.raises(ValueError, match="verify must be"):
        scan_checkpoints(tmp_path, verify="sometimes")


def test_service_resume_survives_corrupt_newest_checkpoint(tmp_path):
    svc = make_service(tmp_path)
    svc.submit(pso_spec("t", 0, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.step()
        svc.step()
        svc.evict("t")
    ns = tmp_path / "tenants" / "t"
    newest = sorted(ns.glob("ckpt_*.npz"))[-1]
    with open(newest, "r+b") as f:
        f.seek(os.path.getsize(newest) // 2)
        byte = f.read(1)
        f.seek(os.path.getsize(newest) // 2)
        f.write(bytes([byte[0] ^ 1]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.submit(pso_spec("t", 0, n_steps=24))
    run_silently(svc)
    rec = svc.tenant("t")
    assert rec.status is TenantStatus.COMPLETED
    assert any("resume" in e and "skipped" in e for e in rec.events) or any(
        ".corrupt" in str(p) for p in ns.glob("*.corrupt*")
    )
    # Resumed past the damaged archive, it still ends on the clean run's bits.
    base = make_service(tmp_path / "base")
    base.submit(pso_spec("t", 0, n_steps=24))
    run_silently(base)
    assert_states_equal(base.result("t"), svc.result("t"), "resume past a corrupt checkpoint")


# ---------------------------------------------------------------------------
# lifecycle: lane reclamation and same-service preemption resume
# ---------------------------------------------------------------------------


def test_forget_quarantined_tenant_releases_its_lane(tmp_path):
    svc = make_service(tmp_path, lanes_per_pack=1, max_restarts=0)
    svc.submit(pso_spec("bad", 1, n_steps=40))
    run_silently(svc)
    assert svc.tenant("bad").status is TenantStatus.QUARANTINED
    svc.forget("bad")
    svc.submit(pso_spec("good", 0, n_steps=9))
    run_silently(svc)
    assert svc.tenant("good").status is TenantStatus.COMPLETED


def test_same_service_resubmit_after_preempted_resumes(tmp_path):
    guard = PreemptionGuard()
    svc = make_service(tmp_path, preemption=guard)
    svc.submit(pso_spec("t", 0, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.step()
        guard.trip("drill")
        with pytest.raises(Preempted):
            svc.run()
    assert svc.tenant("t").status is TenantStatus.EVICTED
    assert svc.tenant("t").lane is None
    guard.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.submit(pso_spec("t", 0, n_steps=24))
    run_silently(svc)
    rec = svc.tenant("t")
    assert rec.status is TenantStatus.COMPLETED
    assert any("resumed from" in e for e in rec.events)
    assert int(svc.result("t")["monitor"]["num_preemptions"]) == 1


def test_preemption_resumes_in_a_new_service_bit_for_bit(tmp_path):
    """A preempted service's tenants resume in a fresh service over the same
    root and end on the bits of an uninterrupted run (the preemption
    counter apart)."""
    guard = PreemptionGuard()
    svc = make_service(tmp_path / "svc", preemption=guard)
    svc.submit(pso_spec("t", 0, n_steps=24))
    svc.submit(openes_spec("e", 7, n_steps=24))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        svc.step()
        svc.step()
        guard.trip("drill")
        with pytest.raises(Preempted):
            svc.step()
    fresh = make_service(tmp_path / "svc")
    fresh.submit(pso_spec("t", 0, n_steps=24))
    fresh.submit(openes_spec("e", 7, n_steps=24))
    run_silently(fresh)
    base = make_service(tmp_path / "base")
    base.submit(pso_spec("t", 0, n_steps=24))
    base.submit(openes_spec("e", 7, n_steps=24))
    run_silently(base)
    for name in ("t", "e"):
        got = fresh.result(name)
        assert int(got["monitor"]["num_preemptions"]) == 1
        got = got.replace(monitor=got["monitor"].replace(num_preemptions=base.result(name)["monitor"]["num_preemptions"]))
        assert_states_equal(base.result(name), got, f"preempted {name}")


def test_withdraw_forget_purge_and_events(tmp_path):
    from evox_tpu_torch.obs import MetricsRegistry, Observability

    events = []
    registry = MetricsRegistry()
    svc = make_service(tmp_path, on_event=events.append, lanes_per_pack=1, obs=Observability(registry=registry))
    svc.submit(pso_spec("a", 0, n_steps=5))
    svc.submit(pso_spec("q", 10, n_steps=5))
    svc.withdraw("q", to_status=TenantStatus.EVICTED)
    assert svc.tenant("q").status is TenantStatus.EVICTED
    svc.submit(pso_spec("w", 11, n_steps=5))
    svc.withdraw("w")
    with pytest.raises(KeyError):
        svc.tenant("w")
    with pytest.raises(RuntimeError, match="not QUEUED"):
        svc.withdraw("a2")
    svc.run()
    assert svc.tenant("a").status is TenantStatus.COMPLETED
    with pytest.raises(AdmissionError, match="forget"):
        svc.submit(pso_spec("a", 0, n_steps=5))
    assert (tmp_path / "tenants" / "a").is_dir()
    svc.forget("a", purge=True)
    assert not (tmp_path / "tenants" / "a").exists()
    assert any("new bucket PSO" in e for e in events) and any("completed at generation" in e for e in events)
    snap = registry.snapshot()
    assert snap["evox_service_submitted_total"] == 4 and snap["evox_service_segments_total"] >= 1
    # The retired tenant's labelled series left with its record.
    assert not any('tenant_id="a"' in k for k in snap)
