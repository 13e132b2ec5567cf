"""The service core's device layer on the CPU: the lane-freeze segment
(``StdWorkflow._generation`` under ``SegmentConfig(lane_freeze=True)``),
``run_segment`` under ``torch.func.vmap``, ``EvalMonitor.ingest_sinks
(lane=)``, the per-lane ``HealthProbe`` windows, ``FaultyProblem
(lane_faults=)`` and ``TenantPack``.

Against the JAX package on identical numpy inputs, exactly (what does not
depend on the random streams, which differ between the frameworks): the
lane-freeze body's ``executed``/``stopped`` for the same frozen mask and
NaN schedule, ``ingest_sinks(lane=)`` on the same telemetry arrays,
``check_lanes`` verdicts, reasons and windows on the same stacked states,
the lane faults' fitness (NaN and Inf places, plateau floors) and the
validation messages.

The port alone, bit for bit: a packed lane against the same tenant's solo
``init_step`` and ``step`` calls, ``torch.func.vmap(wf.run_segment)``
against per-instance segments and the pack's program, widths 1, 4 and 8,
freeze and thaw.  Sizes: the JAX service tests' (POP 16, DIM 8, 4 lanes,
segments of 4).  The pack's captured graph is held on the card in
``tests/test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience import FaultyProblem as JFaultyProblem  # noqa: E402
from evox_tpu.resilience import HealthProbe as JHealthProbe  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JStdWorkflow  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.algorithms.so.es_variants import OpenES  # noqa: E402
from evox_tpu_torch.core import State  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley, Sphere  # noqa: E402
from evox_tpu_torch.resilience import FaultyProblem, HealthProbe  # noqa: E402
from evox_tpu_torch.service import TenantPack, assign_fault_lane  # noqa: E402
from evox_tpu_torch.utils import graph, rng  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

POP, DIM, LANES, SEG = 16, 8, 4, 4
LB, UB = torch.full((DIM,), -32.0), torch.full((DIM,), 32.0)
vmap = torch.func.vmap


def same_state(a, b, what=""):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb, what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(x, y) or (
            x.is_floating_point() and torch.equal(torch.isnan(x), torch.isnan(y))
            and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
        ), (what, i)


def lane(state, i):
    leaves, spec = graph.flatten(state)
    return graph.unflatten(spec, [x[i] for x in leaves])


def pso_workflow(problem=None, monitor=None, **kw):
    return StdWorkflow(PSO(POP, LB, UB, device="cpu"), problem if problem is not None else Ackley(),
                       monitor=monitor, **kw)


def openes_workflow(problem=None, monitor=None):
    algo = OpenES(POP, torch.full((DIM,), 8.0), 0.1, 0.1, optimizer="adam", device="cpu")
    return StdWorkflow(algo, problem if problem is not None else Sphere(), monitor=monitor)


def tenant_state(wf, uid, seed=0):
    """The service's fresh tenant state: setup from fold_in(key(seed), uid),
    the uid as instance id and fault lane."""
    key = rng.fold_in(rng.key(seed), uid)
    return assign_fault_lane(wf.setup(key, instance_id=uid), uid)


def solo_steps(wf, state, n):
    state = wf.init_step(state)
    for _ in range(n):
        state = wf.step(state)
    return state


# ---------------------------------------------------------------------------
# the lane-freeze segment against the JAX package
# ---------------------------------------------------------------------------


def test_lane_freeze_config_normalizes_barrier_and_refuses_like_jax():
    wf = pso_workflow()
    jwf = JStdWorkflow(JPSO(POP, -32 * jnp.ones(DIM), 32 * jnp.ones(DIM)), JSphere())
    for w in (wf, jwf):
        cfg = w.segment_config(lane_freeze=True, barrier=True)
        assert cfg.lane_freeze and not cfg.barrier
        assert w.segment_config().barrier
    state = wf.init_step(wf.init(0))
    jstate = jax.jit(jwf.init_step)(jwf.init(jax.random.key(0)))
    msgs = []
    for run in (
        lambda: wf._run_segment(state, 2, wf.segment_config(lane_freeze=True)),
        lambda: jwf._segment_program(jstate, 2, jwf.segment_config(lane_freeze=True)),
        lambda: wf._run_segment(state, 2, wf.segment_config(), frozen=True),
        lambda: jwf._segment_program(jstate, 2, jwf.segment_config(), jnp.bool_(True)),
    ):
        with pytest.raises(ValueError) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "pass frozen=" in msgs[0]
    assert msgs[2] == msgs[3] and "lane_freeze=True" in msgs[2]


def _faulty_pair(quarantine):
    lane_faults = {1: {"nan_generations": (3,), "nan_rows": POP}, 3: {"nan_generations": (6,), "nan_rows": 2}}
    jwf = JStdWorkflow(
        JPSO(POP, -32 * jnp.ones(DIM), 32 * jnp.ones(DIM)),
        JFaultyProblem(JSphere(), lane_faults=lane_faults),
        quarantine_nonfinite=quarantine,
    )
    wf = StdWorkflow(PSO(POP, LB, UB, device="cpu"), FaultyProblem(Sphere(), lane_faults=lane_faults),
                     quarantine_nonfinite=quarantine)
    return jwf, wf


@pytest.mark.parametrize("early_stop", [True, False], ids=["early-stop", "pure-freeze"])
@pytest.mark.parametrize("frozen", [(False, False, True, False), (True, False, False, False)])
def test_lane_freeze_executed_and_stopped_equal_jax(early_stop, frozen):
    """Four lanes (uids 0..3), uid 1's fitness all NaN at evaluation 3 and
    uid 3's two rows at 6, quarantine off so the state turns non-finite:
    the vmapped lane-freeze segment's per-lane ``executed``/``stopped``
    equal JAX's ``jax.vmap`` of its segment program, and the port's pack
    program agrees."""
    jwf, wf = _faulty_pair(quarantine=False)
    uids = jnp.arange(4)
    jstates = jax.vmap(jwf.init)(jax.random.split(jax.random.key(0), 4), uids)
    jstates = jstates.replace(problem=jstates["problem"].replace(fault_lane=uids.astype(jnp.int32)))
    jstates = jax.jit(jax.vmap(jwf.init_step))(jstates)
    jcfg = jwf.segment_config(metrics=False, stop_on_unhealthy=early_stop, barrier=False, lane_freeze=True)
    _, jtel = jax.jit(
        jax.vmap(lambda s, f: jwf._segment_program(s, 8, jcfg, f))
    )(jstates, jnp.asarray(frozen))

    keys = torch.stack(rng.split_keys(rng.key(0), 4))
    states = vmap(wf.init)(keys, torch.arange(4))
    states = states.replace(problem=states.problem.replace(fault_lane=torch.arange(4, dtype=torch.int32)))
    states = vmap(wf.init_step)(states)
    _, tel = vmap(lambda s, f: wf.run_segment(s, 8, metrics=False, stop_on_unhealthy=early_stop, frozen=f))(
        states, torch.tensor(frozen))
    assert tel.executed.tolist() == np.asarray(jtel["executed"]).tolist()
    assert tel.stopped.tolist() == np.asarray(jtel["stopped"]).tolist()
    if early_stop:
        want_exec = [0 if f else (3 if u == 1 else 6 if u == 3 else 8) for u, f in enumerate(frozen)]
    else:
        want_exec = [0 if f else 8 for f in frozen]
    assert tel.executed.tolist() == want_exec

    pack = TenantPack(wf, 4, early_stop=early_stop)
    for u in range(4):
        pack.admit(lane(states, u), u, frozen=frozen[u])
    ptel = pack.run_segment(8)
    assert ptel.executed.tolist() == want_exec and ptel.stopped.tolist() == tel.stopped.tolist()


# ---------------------------------------------------------------------------
# ingest_sinks(lane=), check_lanes, lane faults against the JAX package
# ---------------------------------------------------------------------------


def _telemetry(b=3, n=4, seed=0):
    r = np.random.default_rng(seed)
    data = r.standard_normal((b, n, POP)).astype(np.float32)
    gens = (np.arange(n)[None, :] + 2 + 10 * np.arange(b)[:, None]).astype(np.int32)
    insts = np.repeat(np.array([7, 8, 9])[:b, None], n, 1).astype(np.int32)
    executed = np.array([4, 2, 0])[:b].astype(np.int32)
    return [(0, 0)], [(data, gens, insts)], executed


@pytest.mark.parametrize("which", [0, 1, 2])
def test_ingest_sinks_lane_demux_equals_jax(which):
    meta, sinks, executed = _telemetry()
    jmon, mon = JEvalMonitor(ordered=False), EvalMonitor(ordered=False)
    jmon.ingest_sinks(meta, sinks, executed, lane=which)
    mon.ingest_sinks(meta, [tuple(torch.from_numpy(x) for x in s) for s in sinks], torch.from_numpy(executed),
                     lane=which)
    want, got = jmon.fitness_history, mon.fitness_history
    assert len(got) == len(want) == int(executed[which])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The whole vmapped form (no lane) appends every lane's rows.
    jall, pall = JEvalMonitor(ordered=False), EvalMonitor(ordered=False)
    jall.ingest_sinks(meta, sinks, executed)
    pall.ingest_sinks(meta, [tuple(torch.from_numpy(x) for x in s) for s in sinks], torch.from_numpy(executed))
    assert [a.tolist() for a in pall.fitness_history] == [np.asarray(b).tolist() for b in jall.fitness_history]


def test_ingest_sinks_lane_refuses_unbatched_telemetry_like_jax():
    args = ([(0, 0)], [(np.zeros((3, POP)), np.arange(3), np.zeros(3))], np.int32(3))
    msgs = []
    for mon in (JEvalMonitor(ordered=False), EvalMonitor(ordered=False)):
        with pytest.raises(ValueError, match="VMAPPED") as e:
            mon.ingest_sinks(*args, lane=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _lane_states(round_):
    """Three lanes of dyadic states: lane 0 improving, lane 1 with a NaN
    fitness, lane 2 flat (its best never moves)."""
    pop = np.stack([np.full((POP, DIM), 0.5 * (i + 1), np.float32) for i in range(3)])
    pop[:, 0, :] += 0.25  # some spread
    fit = np.stack([np.arange(POP, dtype=np.float32) + 8.0 - 2.0 * round_,
                    np.arange(POP, dtype=np.float32),
                    np.full((POP,), 3.0, np.float32)])
    fit[1, 3] = np.nan
    topk = fit.min(axis=1, initial=np.inf, where=~np.isnan(fit))[:, None].astype(np.float32)
    return pop, fit, topk


def test_check_lanes_verdicts_reasons_and_windows_equal_jax():
    kw = dict(stagnation_window=2, stagnation_tol=0.0, diversity_floor=1e-3)
    jprobe, probe = JHealthProbe(**kw), HealthProbe(**kw)
    for round_ in range(2):
        pop, fit, topk = _lane_states(round_)
        jstates = JState(algorithm=JState(pop=jnp.asarray(pop), fit=jnp.asarray(fit)),
                         monitor=JState(topk_fitness=jnp.asarray(topk)))
        states = State(algorithm=State(pop=torch.from_numpy(pop), fit=torch.from_numpy(fit)),
                       monitor=State(topk_fitness=torch.from_numpy(topk)))
        pairs = [(0, 100), (1, 200), (2, 300)]
        want = jprobe.check_lanes(jstates, generation=round_, lane_ids=pairs)
        got = probe.check_lanes(states, generation=round_, lane_ids=pairs)
        for a, b in zip(got, want):
            assert (a.healthy, a.reasons, a.nonfinite_leaves, a.stagnating, a.best_fitness, a.diversity) == (
                b.healthy, b.reasons, b.nonfinite_leaves, b.stagnating, b.best_fitness, b.diversity)
        for uid in (100, 200, 300):
            assert probe.lane_window(uid) == jprobe.lane_window(uid)
        # Sparse rows and plain ids too.
        assert [r.healthy for r in probe.check_lanes(states, lane_ids=[7, 8, 9])] == [
            r.healthy for r in jprobe.check_lanes(jstates, lane_ids=[7, 8, 9])]
    assert not got[1].healthy and "non-finite" in got[1].reasons[0]
    assert got[2].stagnating and got[0].healthy
    probe.reset_lane(200)
    jprobe.reset_lane(200)
    assert probe.lane_window(200) == jprobe.lane_window(200) == ()
    probe.restore_lane(100, [1.0, 0.5, 0.25])
    jprobe.restore_lane(100, [1.0, 0.5, 0.25])
    assert probe.lane_window(100) == jprobe.lane_window(100) == (0.5, 0.25)


LANE_PLAN = {
    1: {"nan_generations": (2, 3), "nan_rows": 5},
    2: {"inf_generations": (1,), "inf_rows": 3, "plateau_from": 2, "plateau_until": 4, "plateau_floor": 60.0},
    4: {"plateau_from": 0, "plateau_floor": 1e9},
}


@pytest.mark.parametrize("fault_lane", [-1, 0, 1, 2, 4])
@pytest.mark.parametrize("gen", [0, 1, 2, 3, 5])
def test_lane_faults_fitness_equals_jax(fault_lane, gen):
    pop = (np.arange(POP * DIM, dtype=np.float32).reshape(POP, DIM) % 7) - 3.0
    jprob = JFaultyProblem(JSphere(), lane_faults=LANE_PLAN)
    prob = FaultyProblem(Sphere(), lane_faults=LANE_PLAN)
    jst = jprob.setup(jax.random.key(0)).replace(
        fault_generation=jnp.int32(gen), fault_lane=jnp.int32(fault_lane))
    st = prob.setup(rng.key(0)).replace(
        fault_generation=torch.tensor(gen, dtype=torch.int32), fault_lane=torch.tensor(fault_lane, dtype=torch.int32))
    want, _ = jprob.evaluate(jst, jnp.asarray(pop))
    got, new = prob.evaluate(st, torch.from_numpy(pop))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(new.fault_generation) == gen + 1 and int(new.fault_lane) == fault_lane
    # Under vmap over lanes, each lane sees its own schedule.
    lanes = torch.tensor([-1, 1, 2, 4], dtype=torch.int32)
    stacked = vmap(lambda fl: prob.evaluate(st.replace(fault_lane=fl), torch.from_numpy(pop))[0])(lanes)
    for i, fl in enumerate(lanes.tolist()):
        one, _ = jprob.evaluate(jst.replace(fault_lane=jnp.int32(fl)), jnp.asarray(pop))
        np.testing.assert_array_equal(stacked[i].numpy(), np.asarray(one))


BAD_PLANS = [
    dict(lane_faults={1: {"nan_gens": (1,)}}),
    dict(lane_faults={-3: {"nan_generations": (1,)}}),
    dict(nan_generations=(-1,)),
    dict(plateau_from=5, plateau_until=2),
    dict(plateau_until=4),
    dict(lane_faults={2: {"plateau_until": 5, "plateau_floor": 9.9}}),
    dict(lane_faults={2: {"plateau_from": 5, "plateau_until": 1}}),
    dict(lane_faults={2: {"nan_generations": (-2,)}}),
    dict(lane_faults={2: {"delay_generations": (1,), "delay_seconds": -1.0}}),
    dict(lane_faults={2: {"inf_rows": -1}}),
    dict(dead_shards={9: (1,)}, shards=4),
    dict(eval_deadline=0.0),
    dict(error_times=-1),
]


@pytest.mark.parametrize("plan", BAD_PLANS, ids=[",".join(p) + str(i) for i, p in enumerate(BAD_PLANS)])
def test_lane_fault_validation_messages_equal_jax(plan):
    msgs = []
    for cls, inner in ((JFaultyProblem, JSphere()), (FaultyProblem, Sphere())):
        with pytest.raises(ValueError) as e:
            cls(inner, **plan)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_lane_delay_fires_once_a_lane_under_vmap_and_is_not_capturable():
    prob = FaultyProblem(Sphere(), lane_faults={1: {"delay_generations": (2,), "delay_seconds": 0.001}})
    assert not prob.capturable and FaultyProblem(Sphere(), lane_faults=LANE_PLAN).capturable
    st = prob.setup(rng.key(0))
    pop = torch.zeros(POP, DIM)
    for g in range(4):
        s = st.replace(fault_generation=torch.tensor(g, dtype=torch.int32))
        vmap(lambda fl: prob.evaluate(s.replace(fault_lane=fl), pop)[0])(torch.tensor([0, 1, 3], dtype=torch.int32))
    assert prob.attempts("lane_delay1", 2) == 1
    assert prob.attempts("lane_delay0", 2) == 0 and prob.attempts("lane_delay1", 1) == 0
    import pickle

    assert pickle.loads(pickle.dumps(prob)).lane_faults == prob.lane_faults


# ---------------------------------------------------------------------------
# the pack, the port alone
# ---------------------------------------------------------------------------


def test_assign_fault_lane_stamps_every_fault_lane_leaf():
    wf = pso_workflow(FaultyProblem(Ackley(), lane_faults=LANE_PLAN))
    s = assign_fault_lane(wf.init(0), 7)
    assert int(s.problem.fault_lane) == 7 and s.problem.fault_lane.dtype == torch.int32
    plain = pso_workflow().init(0)
    same_state(assign_fault_lane(plain, 3), plain)


@pytest.mark.parametrize("make", [pso_workflow, openes_workflow], ids=["pso", "openes"])
def test_packed_lanes_equal_solo_steps(make):
    """Three tenants in a 4-lane pack, three segments: each lane equals the
    same tenant's solo init_step and steps bit for bit; the empty lane
    executes nothing."""
    wf = make(FaultyProblem(Ackley() if make is pso_workflow else Sphere(), lane_faults=LANE_PLAN))
    pack = TenantPack(wf, LANES, early_stop=False)
    for uid in (0, 3, 5):
        state, _, _ = pack.init_tenant(tenant_state(wf, uid))
        pack.admit(state, uid)
    assert pack.free_lanes() == [3] and [u for _, u in pack.active_lanes()] == [0, 3, 5]
    for _ in range(3):
        tel = pack.run_segment(SEG)
        assert tel.executed.tolist() == [SEG, SEG, SEG, 0]
        assert tuple(tel.best_fitness.shape) == (LANES, SEG)
    for lane_i, uid in pack.occupied_lanes():
        same_state(pack.lane_state(lane_i), solo_steps(wf, tenant_state(wf, uid), 3 * SEG), f"lane {lane_i}")


def test_vmapped_run_segment_equals_per_instance_segments_and_the_pack():
    wf = pso_workflow()
    states = vmap(wf.init_step)(vmap(wf.init)(torch.stack(rng.split_keys(rng.key(5), 4)), torch.arange(4)))
    got, tel = vmap(lambda s: wf.run_segment(s, SEG))(states)
    assert tel.executed.tolist() == [SEG] * 4 and tel.sink_meta.shape[0] == 4
    assert set(tel.metrics) >= {"nonfinite", "best_fitness"}
    pack = TenantPack(wf, 4, early_stop=False)
    for i in range(4):
        pack.admit(lane(states, i), i)
    pack.run_segment(SEG)
    for i in range(4):
        want, wtel = wf.run_segment(lane(states, i), SEG)
        same_state(lane(got, i), want, f"instance {i}")
        same_state(pack.lane_state(i), want, f"pack lane {i}")
        assert torch.equal(tel.best_fitness[i], wtel.best_fitness)


def test_vmapped_run_segment_history_flushes_per_instance():
    mon = EvalMonitor(ordered=False, num_instances=2)
    wf = pso_workflow(monitor=mon)
    states = vmap(wf.init_step)(vmap(wf.init)(torch.stack(rng.split_keys(rng.key(2), 2)), torch.arange(2)))
    mon.clear_history()
    got, tel = vmap(lambda s: wf.run_segment(s, SEG))(states)
    assert tel.sink_meta.ndim == 3
    wf.flush_telemetry(tel)
    hist = mon.fitness_history
    assert len(hist) == SEG and tuple(hist[0].shape) == (2, POP)
    for i in range(2):
        one = EvalMonitor()
        w1 = pso_workflow(monitor=one)
        s1 = lane(states, i)
        for _ in range(SEG):
            s1 = w1.step(s1)
        for g in range(SEG):
            assert torch.equal(hist[g][i], one.fitness_history[g])


@pytest.mark.parametrize("make", [pso_workflow, openes_workflow], ids=["pso", "openes"])
def test_pack_width_invariance(make):
    """Widths 1, 4 and 8 advance the same tenant through the same bits."""
    finals = []
    for width in (1, 4, 8):
        wf = make()
        pack = TenantPack(wf, width)
        state, _, _ = pack.init_tenant(tenant_state(wf, 0))
        pack.admit(state, 0)
        for other in range(1, min(width, 3)):
            s, _, _ = pack.init_tenant(tenant_state(wf, 10 + other))
            pack.admit(s, 10 + other)
        for _ in range(3):
            pack.run_segment(SEG)
        finals.append(pack.lane_state(0))
    same_state(finals[0], finals[1], "width 1 vs 4")
    same_state(finals[0], finals[2], "width 1 vs 8")


def test_freeze_is_a_noop_and_thaw_resumes_without_a_new_program():
    wf = pso_workflow()
    pack = TenantPack(wf, LANES)
    for uid in (0, 1):
        s, _, _ = pack.init_tenant(tenant_state(wf, uid))
        pack.admit(s, uid)
    pack.run_segment(SEG)
    before = pack.lane_state(1)
    other = pack.lane_state(0)
    program = pack._segment_program
    pack.set_frozen(1, True)
    assert pack.frozen_mask.tolist() == [False, True, True, True]
    tel = pack.run_segment(SEG)
    assert tel.executed.tolist() == [SEG, 0, 0, 0] and tel.stopped.tolist() == [False, True, True, True]
    same_state(pack.lane_state(1), before, "frozen lane")
    pack.set_frozen(1, False)
    pack.run_segment(SEG)
    # The thawed lane resumes exactly where it froze: its next segment is
    # the one it would have run.
    want = wf.run_segment(before, SEG)[0]
    same_state(pack.lane_state(1), want, "thawed lane")
    same_state(pack.lane_state(0), wf.run_segment(wf.run_segment(other, SEG)[0], SEG)[0], "neighbour")
    assert pack._segment_program is program
    pack.release(1)
    assert pack.free_lanes() == [1, 2, 3] and pack.frozen_mask[1]


def test_pack_refusals(tmp_path):
    from evox_tpu_torch.utils import ExecutableCache

    wf = pso_workflow()
    with pytest.raises(ValueError, match="lanes must be >= 1"):
        TenantPack(wf, 0)
    pack = TenantPack(wf, 1)
    with pytest.raises(RuntimeError, match="no admitted tenants"):
        pack.run_segment(2)
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        pack.prewarm(tenant_state(wf, 0), [SEG, 0])
    # A persistent cache (13.2) is taken: a new pack of the bucket loads.
    cache = ExecutableCache(tmp_path / "exec")
    assert not any(TenantPack(wf, 1).prewarm(tenant_state(wf, 0), SEG, cache=cache).values())
    assert all(TenantPack(wf, 1).prewarm(tenant_state(wf, 0), SEG, cache=cache).values())
    labels = pack.prewarm(tenant_state(wf, 0), [SEG, 2 * SEG], label="b")
    assert all(v is False for v in labels.values()) and len(labels) == 3
    s, meta, sinks = pack.init_tenant(tenant_state(wf, 0))
    pack.admit(s, 0)
    with pytest.raises(RuntimeError, match="pack is full"):
        pack.admit(s, 1)
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        pack.run_segment(0)
    pack.release(0)
    meta_state = graph.unflatten(graph.flatten(s)[1], [t.to("meta") for t in graph.flatten(s)[0]])
    with pytest.raises(ValueError, match="mixed devices"):
        pack.admit(meta_state, 1)


def test_init_tenant_returns_the_init_generations_history():
    mon = EvalMonitor(ordered=False)
    wf = pso_workflow(monitor=mon)
    pack = TenantPack(wf, 2)
    state, meta, sinks = pack.init_tenant(tenant_state(wf, 4))
    assert meta == [(0, 0)] and sinks[0][0].shape == (1, POP)
    tmon = EvalMonitor(ordered=False)
    tmon.ingest_sinks(meta, sinks, 1)
    solo = EvalMonitor()
    swf = pso_workflow(monitor=solo)
    swf.init_step(tenant_state(swf, 4))
    assert torch.equal(tmon.fitness_history[0], solo.fitness_history[0])
    assert int(sinks[0][2][0]) == 4  # the instance id is the uid
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pack.admit(state, 4)
