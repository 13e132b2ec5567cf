"""The port's chaos conductor and invariant registry
(``evox_tpu_torch/resilience/chaos.py``, ``resilience/invariants.py``) and
its soak ladder (``tools/soak_torch.py``) on the CPU, at the JAX chaos
suite's sizes (``tests/test_chaos.py``: the acceptance plan
``ChaosPlan.from_seed(11, members=3, tenants=8, rounds=7, kills=2, wire=3,
disk=2, lanes=1, partitions=1)`` over three members of PSO(8, ±32 in dim
4) on Ackley, 4 lanes, segments of 4, ``device="cpu"``).

Every test of ``tests/test_chaos.py`` has its counterpart here under the
same name: the injector schedule audits, the plan DSL and its validation,
the acceptance run (zero violations, the event journal replayed bit for
bit by a second run over a fresh root, the JSON report, the statusz strip
on router, daemon and gateway), every invariant's mutation, the live-fleet
mutation and its postmortem bundle, the kill points, ``tools/evoxtop.py``
on the strip, and the soak ladder's 1k rung (the 100k rung slow-marked, as
there).

Held against the JAX package on the same inputs, exactly:

(a) ``ChaosPlan.from_seed`` on hypothesis-drawn seeds and sizes (the same
    ``to_json`` and ``digest``, or the same error), and every malformed plan
    of the JAX suite (the same exception type and message);
(b) every checker on the clean and the seven mutated snapshots and on
    hypothesis-drawn snapshots (the same ``to_json`` of every violation);
(c) the acceptance run: ``chaos_events.jsonl`` byte for byte, and the
    report's rounds, completions, acks, pending, injected events, plan
    digest, violations and counters; and the 200-tenant soak's report
    counts.  The JAX reference runs in a subprocess on one CPU device
    (``--xla_force_host_platform_device_count=1``): JAX's conductor fails
    on the eight devices the suite's ``conftest.py`` sets
    (``Expected args to execute_sharded_on_local_devices to have 8
    shards``).  It runs its conductor twice (as the JAX suite's fixture
    does) and its soak after a warm-up soak, over one executable cache:
    the default SLOs bound a segment at 2 s, and a segment that compiles
    breaches it, after which JAX's controller journals a shed decision
    that a warm run does not.  The runs compared are the warm ones.
"""

import ast
import json
import os
import subprocess
import sys
from copy import deepcopy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from evox_tpu.resilience import invariants as jinv  # noqa: E402
from evox_tpu.resilience.chaos import ChaosPlan as JChaosPlan  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_daemon import shared_cache  # noqa: E402

from evox_tpu_torch.resilience import (  # noqa: E402
    INVARIANTS,
    AuditContext,
    FaultyStore,
    FaultyTransport,
    audit_invariants,
)
from evox_tpu_torch.resilience import invariants as inv  # noqa: E402
from evox_tpu_torch.resilience.chaos import (  # noqa: E402
    ChaosConductor,
    ChaosPlan,
    build_audit_context,
)
from evox_tpu_torch.resilience.testing import flip_bit, kill_points  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import soak_torch  # noqa: E402


# -- injector schedule audits (the validate_schedule seam) --------------------


def test_faulty_store_schedule_rejects_negative_index():
    with pytest.raises(ValueError, match="negative"):
        FaultyStore(enospc_saves=[-1])


def test_faulty_store_schedule_rejects_conflicting_fates():
    """One save index scheduled for two incompatible outcomes is a plan
    contradiction, caught at construction — never a silent precedence."""
    with pytest.raises(ValueError, match="conflicting"):
        FaultyStore(crash_saves=[2], enospc_saves=[2])
    with pytest.raises(ValueError, match="conflicting"):
        FaultyStore(enospc_saves=[1], eio_saves=[1])


def test_faulty_transport_schedule_rejects_conflicts_and_negatives():
    with pytest.raises(ValueError, match="conflicting"):
        FaultyTransport(None, drop_requests=[0], drop_replies=[0])
    with pytest.raises(ValueError, match="negative"):
        FaultyTransport(None, delay_requests=[-2])
    with pytest.raises(ValueError, match="delay_seconds"):
        FaultyTransport(None, delay_requests=[0], delay_seconds=-1.0)


# -- plan DSL -----------------------------------------------------------------


def test_plan_from_seed_is_deterministic_and_json_round_trips():
    a = ChaosPlan.from_seed(42)
    b = ChaosPlan.from_seed(42)
    assert a.digest() == b.digest()
    assert a.digest() != ChaosPlan.from_seed(43).digest()
    restored = ChaosPlan.from_json(json.loads(json.dumps(a.to_json())))
    assert restored.digest() == a.digest()


def _base_plan(**overrides):
    base = dict(name="p", seed=0, rounds=4, members=2, tenants=1, submit_rounds=[0])
    base.update(overrides)
    return base


# The JAX suite's malformed plans (tests/test_chaos.py), each with the part
# of the message it matches.
MALFORMED = {
    "unknown-op": (dict(events=[{"round": 0, "op": "melt-member", "member": 0}]), "unknown op"),
    "missing-field": (dict(events=[{"round": 0, "op": "kill-member"}]), "missing field"),
    "event-round": (dict(events=[{"round": 9, "op": "kill-router"}]), "outside"),
    "event-member": (dict(events=[{"round": 0, "op": "kill-member", "member": 5}]), "outside"),
    "empty-window": (dict(events=[{"round": 2, "op": "partition-member", "member": 0, "until": 2}]),
                     "empty or runs past"),
    "negative-delay": (dict(events=[{"round": 0, "op": "straggle-member", "member": 0, "until": 2,
                                     "delay_seconds": -0.5}]), "delay_seconds"),
    "unscheduled-tenant": (dict(submit_rounds=[]), "every tenant"),
    "submit-round": (dict(submit_rounds=[7]), "outside"),
    "store-scope": (dict(store_faults={"member:9": {"eio_saves": [0]}}), "store_faults scope"),
    "store-conflict": (dict(store_faults={"router": {"crash_saves": [0], "eio_saves": [0]}}), "conflicting"),
    "wire-key": (dict(wire_faults={"7": {"drop_replies": [0]}}), "wire_faults key"),
    "lane-field": (dict(lane_faults={"0": {"nan_everything": True}}), "lane_faults"),
    "contradictory-fates": (dict(rounds=6, tenants=0, submit_rounds=[], events=[
        {"round": 1, "op": "partition-member", "member": 0, "until": 4},
        {"round": 2, "op": "kill-member", "member": 0},
    ]), "conflicting ChaosPlan member 0"),
}


def test_plan_validation_rejects_malformed_scenarios():
    ChaosPlan(**_base_plan())  # the base scenario is valid
    for name, (overrides, match) in MALFORMED.items():
        if name == "contradictory-fates":
            continue
        with pytest.raises(ValueError, match=match):
            ChaosPlan(**_base_plan(**overrides))


def test_plan_rejects_contradictory_member_fates():
    """A SIGKILL landing inside a partition window (nothing reaches the
    process) is the cross-event contradiction ``validate_schedule``'s
    exclusivity rule catches one level up."""
    overrides, match = MALFORMED["contradictory-fates"]
    with pytest.raises(ValueError, match=match):
        ChaosPlan(**_base_plan(**overrides))


def _outcome(cls, build):
    try:
        plan = build(cls)
    except Exception as e:  # noqa: BLE001 - the type and message are compared
        return ("error", type(e).__name__, str(e))
    return ("plan", plan.to_json(), plan.digest())


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    seed=st.integers(0, 2**40),
    members=st.integers(1, 5),
    tenants=st.integers(0, 12),
    rounds=st.integers(1, 10),
    kills=st.integers(0, 4),
    wire=st.integers(0, 4),
    disk=st.integers(0, 4),
    lanes=st.integers(0, 3),
    partitions=st.integers(0, 2),
)
def test_plan_from_seed_equals_jax(seed, members, tenants, rounds, kills, wire, disk, lanes, partitions):
    """The same seed and sizes give the same plan, digest and errors."""
    kw = dict(members=members, tenants=tenants, rounds=rounds, kills=kills, wire=wire, disk=disk, lanes=lanes,
              partitions=partitions)

    def build(cls):
        return cls.from_seed(seed, **kw)

    assert _outcome(ChaosPlan, build) == _outcome(JChaosPlan, build)


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_plan_validation_errors_equal_jax(name):
    """Each malformed plan of the JAX suite raises the same type with the
    same message in both packages."""
    overrides, match = MALFORMED[name]

    def build(cls):
        return cls(**_base_plan(**deepcopy(overrides)))

    got, want = _outcome(ChaosPlan, build), _outcome(JChaosPlan, build)
    assert got[0] == "error" and match in got[2]
    assert got == want


# -- the acceptance run -------------------------------------------------------

PLAN_SEED = 11
PLAN_SIZES = dict(members=3, tenants=8, rounds=7, kills=2, wire=3, disk=2, lanes=1, partitions=1)


def _acceptance_plan():
    return ChaosPlan.from_seed(PLAN_SEED, **PLAN_SIZES)


@pytest.fixture(scope="module")
def chaos_runs(tmp_path_factory):
    """Run the SAME seeded plan twice over fresh roots on the CPU; yields
    ``(conductor_a, report_a, report_b)`` with conductor A left open for
    the statusz / live-mutation suites."""
    root_a = tmp_path_factory.mktemp("chaos_a")
    root_b = tmp_path_factory.mktemp("chaos_b")
    conductor_a = ChaosConductor(root_a, _acceptance_plan(), exec_cache=shared_cache(), device="cpu")
    report_a = conductor_a.run()
    conductor_b = ChaosConductor(root_b, _acceptance_plan(), exec_cache=shared_cache(), device="cpu")
    try:
        report_b = conductor_b.run()
    finally:
        conductor_b.close()
    yield conductor_a, report_a, report_b
    conductor_a.close()


def test_chaos_acceptance_zero_violations(chaos_runs):
    """The seeded kills+wire+disk+partition+lane scenario completes every
    tenant exactly once with ZERO invariant violations, every member on
    the CPU as asked."""
    conductor, report, _ = chaos_runs
    assert report.violations == []
    assert report.completed == report.tenants == 8
    assert report.pending == 0
    assert report.acks >= report.tenants
    assert report.injected_events > 0
    sources = {e["source"].split(":")[0] for e in conductor.injected}
    assert "plan" in sources
    assert sources & {"wire", "store"}
    kinds = {e["kind"] for e in conductor.injected}
    assert kinds & {"kill-member", "kill-router"}
    assert {m.daemon.device.type for m in conductor.members.values()} == {"cpu"}


def test_chaos_event_journal_replays_bit_for_bit(chaos_runs):
    """Same ``(seed, plan digest)`` → byte-identical injected-event
    journal: any chaos failure reproduces exactly."""
    _, report_a, report_b = chaos_runs
    assert report_a.plan_digest == report_b.plan_digest
    assert report_a.event_log_sha256 == report_b.event_log_sha256
    assert Path(report_a.event_log).read_bytes() != b""


def test_chaos_report_is_json_clean_with_burn_rates(chaos_runs):
    """The persisted report parses clean and carries the SLO burn-rate
    section per member scope."""
    conductor, report, _ = chaos_runs
    on_disk = json.loads((conductor.root / ChaosConductor.REPORT).read_text())
    assert on_disk["plan_digest"] == report.plan_digest
    assert on_disk["violations"] == []
    scopes = on_disk["slo_burn_report"]["scopes"]
    assert scopes, "burn report must cover at least one member scope"
    for rows in scopes.values():
        for row in rows:
            assert {"slo", "good", "bad", "target"} <= set(row)


def test_chaos_statusz_strip_on_router_and_daemon(chaos_runs):
    """The conductor registers itself on the planes it drives: the
    router's and each member daemon's ``/statusz`` carry the chaos
    section the ``evoxtop`` strip renders."""
    conductor, _, _ = chaos_runs
    for payload in (
        conductor.router._statusz()["chaos"],
        conductor.members[0].daemon._statusz()["chaos"],
        conductor.statusz_payload(),
    ):
        assert payload["plan"] == conductor.plan.name
        assert {"round", "injected_events", "violations", "completed", "live_tenants",
                "worst_burn_rate"} <= set(payload)


def test_chaos_statusz_strip_on_gateway(chaos_runs):
    from evox_tpu_torch.service import Gateway

    conductor, _, _ = chaos_runs
    gw = Gateway(conductor.members[1].daemon, tokens={"tok": "alice"})
    assert "chaos" not in gw.statusz_payload()
    gw.chaos = conductor
    assert gw.statusz_payload()["chaos"]["plan"] == conductor.plan.name


# -- invariant liveness: every checker has a mutation that trips it ----------


def _clean_ctx(cls=AuditContext) -> AuditContext:
    """A minimal healthy snapshot: one acked, placed, journaled tenant."""
    return cls(
        round=1,
        acks=[{"tenant_id": "t0", "uid": 0, "kind": "submit", "round": 1}],
        router_records=[{"kind": "placement", "data": {"tenant_id": "t0", "member": 0}}],
        member_records={0: [{"kind": "submit", "data": {"tenant_id": "t0"}}]},
        placements={"t0": {"member": 0, "uid": 0}},
        live_members={0},
        resident={0: {"t0"}},
        counters={"c": 2.0},
        previous_counters={"c": 1.0},
        records_since_snapshot={"router": 3},
        compact_records={"router": 100},
        slo_reports={"member:0": [{
            "slo": "s", "tenant_class": "standard", "signal": "x",
            "target": 0.9, "threshold": 1.0, "window": 100,
            "good": 9, "bad": 1, "burn_rate": 1.0, "budget_remaining": 0.0,
        }]},
    )


def _mutate_double_mint(ctx):
    ctx.router_records.append({"kind": "placement", "data": {"tenant_id": "t0", "member": 1}})


def _mutate_torn_ack(ctx):
    ctx.acks.append({"tenant_id": "ghost", "uid": 9, "kind": "submit", "round": 1})
    ctx.completed.add("ghost")
    ctx.compacted_scopes.add("router")


def _mutate_rogue_writer(ctx):
    ctx.live_members.add(1)
    ctx.resident[1] = {"t0"}


def _mutate_lost_record(ctx):
    ctx.placements.pop("t0")
    ctx.resident[0].discard("t0")


def _mutate_unbounded_disk(ctx):
    ctx.forgotten.add("gone")
    ctx.resident[0].add("gone")


def _mutate_counter_regression(ctx):
    ctx.counters["c"] = 0.0


def _mutate_slo_arithmetic(ctx):
    ctx.slo_reports["member:0"][0]["burn_rate"] = 0.123


MUTATIONS = {
    "exactly-once-admission": _mutate_double_mint,
    "reply-after-journal": _mutate_torn_ack,
    "single-writer-per-namespace": _mutate_rogue_writer,
    "no-acked-record-lost": _mutate_lost_record,
    "bounded-disk": _mutate_unbounded_disk,
    "monotone-counters": _mutate_counter_regression,
    "slo-accounting": _mutate_slo_arithmetic,
}


def test_every_registered_invariant_has_a_mutation():
    """The liveness proof is COMPLETE: a new invariant registered
    without a mutation that trips it fails here."""
    assert set(MUTATIONS) == set(INVARIANTS)


def test_clean_snapshot_passes_every_checker():
    assert audit_invariants(_clean_ctx()) == []


@pytest.mark.parametrize("name", sorted(INVARIANTS))
def test_invariant_is_live(name):
    """Each checker actually fires on its seeded tampering — and ONLY
    the tampered promise breaks (the mutations are surgical)."""
    ctx = _clean_ctx()
    MUTATIONS[name](ctx)
    found = INVARIANTS[name](ctx)
    assert found, f"mutation for {name!r} did not trip its checker"
    assert all(v.invariant == name for v in found)
    assert all(v.round == ctx.round for v in found)
    for v in found:
        payload = json.loads(json.dumps(v.to_json()))
        assert payload["invariant"] == name
        assert payload["summary"]
    fired = {v.invariant for v in audit_invariants(ctx)}
    assert name in fired


def test_some_mutation_extras():
    """Edge variants the single-mutation matrix doesn't cover: the
    orphan namespace, journal growth past an armed threshold, and an
    SLO window claiming events but publishing no burn rate."""
    ctx = _clean_ctx()
    ctx.resident[0].add("orphan")
    assert any("orphan" in v.summary for v in INVARIANTS["bounded-disk"](ctx))
    ctx = _clean_ctx()
    ctx.records_since_snapshot["router"] = 999
    assert INVARIANTS["bounded-disk"](ctx)
    ctx = _clean_ctx()
    ctx.slo_reports["member:0"][0]["burn_rate"] = None
    assert any("unpublished" in v.summary for v in INVARIANTS["slo-accounting"](ctx))
    ctx = _clean_ctx()
    row = ctx.slo_reports["member:0"][0]
    row.update(good=0, bad=0, burn_rate=None, budget_remaining=None)
    assert INVARIANTS["slo-accounting"](ctx) == []


def _verdicts(module, ctx) -> dict:
    """Every checker's and the whole audit's violations, as JSON."""
    out = {name: [v.to_json() for v in checker(deepcopy(ctx))] for name, checker in module.INVARIANTS.items()}
    out["audit"] = [v.to_json() for v in module.audit_invariants(deepcopy(ctx))]
    return out


def _twin_contexts(mutate=None):
    ours, theirs = _clean_ctx(), _clean_ctx(jinv.AuditContext)
    if mutate is not None:
        mutate(ours)
        mutate(theirs)
    return ours, theirs


@pytest.mark.parametrize("name", ["clean"] + sorted(MUTATIONS))
def test_invariants_equal_jax(name):
    """The clean snapshot and each mutated one give the same violations,
    summaries and evidence in both packages."""
    ours, theirs = _twin_contexts(MUTATIONS.get(name))
    got, want = _verdicts(inv, ours), _verdicts(jinv, theirs)
    assert list(got) == list(want)
    assert got == want
    if name != "clean":
        assert got[name]


_TIDS = st.sampled_from(["t0", "t1", "t2", "ghost"])
_MEMBERS = st.integers(0, 2)
_KINDS = st.sampled_from(["placement", "migration", "steer", "submit", "complete", None])
_NUM = st.one_of(st.integers(-2, 20), st.floats(-1.0, 20.0, allow_nan=False), st.none(), st.just("x"))


@st.composite
def _contexts(draw):
    def record():
        data = draw(st.dictionaries(st.just("tenant_id"), st.one_of(_TIDS, st.none())))
        return {"kind": draw(_KINDS), "data": data}

    def slo_row():
        row = {"slo": draw(st.sampled_from(["lat", "tput"])), "target": draw(st.sampled_from([0.9, 0.99, 1.0, "x"])),
               "good": draw(_NUM), "bad": draw(_NUM), "burn_rate": draw(_NUM), "budget_remaining": draw(_NUM)}
        for key in draw(st.lists(st.sampled_from(["good", "bad", "burn_rate", "target"]), max_size=1)):
            row.pop(key)
        return row

    rnd = draw(st.integers(0, 3))
    scopes = st.sampled_from(["router", "member:0", "member:1"])
    return dict(
        round=rnd,
        acks=draw(st.lists(st.fixed_dictionaries({"tenant_id": _TIDS, "uid": st.integers(0, 3),
                                                  "kind": st.sampled_from(["submit", "steer"]),
                                                  "round": st.integers(0, 3)}), max_size=5)),
        router_records=[record() for _ in range(draw(st.integers(0, 5)))],
        member_records={m: [record() for _ in range(draw(st.integers(0, 4)))]
                        for m in draw(st.sets(_MEMBERS, max_size=3))},
        placements={t: {"member": draw(_MEMBERS), "uid": 0} for t in draw(st.sets(_TIDS, max_size=3))},
        completed=draw(st.sets(_TIDS, max_size=2)),
        forgotten=draw(st.sets(_TIDS, max_size=2)),
        live_members=draw(st.sets(_MEMBERS, max_size=3)),
        resident={m: draw(st.sets(_TIDS, max_size=3)) for m in draw(st.sets(_MEMBERS, max_size=3))},
        counters=draw(st.dictionaries(st.sampled_from(["a", "b", "c"]), st.floats(0, 5), max_size=3)),
        previous_counters=draw(st.dictionaries(st.sampled_from(["a", "b", "c"]), st.floats(0, 5), max_size=3)),
        slo_reports={s: [slo_row() for _ in range(draw(st.integers(0, 2)))]
                     for s in draw(st.sets(scopes, max_size=2))},
        records_since_snapshot=draw(st.dictionaries(scopes, st.integers(0, 500), max_size=3)),
        compact_records=draw(st.dictionaries(scopes, st.one_of(st.none(), st.integers(1, 100)), max_size=3)),
        compacted_scopes=draw(st.sets(scopes, max_size=2)),
    )


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(fields=_contexts())
def test_invariants_equal_jax_on_drawn_contexts(fields):
    """Hypothesis-drawn snapshots (collisions, missing and malformed SLO
    fields, compacted scopes, dead members) give the same violations in
    both packages."""
    got = _verdicts(inv, AuditContext(**deepcopy(fields)))
    want = _verdicts(jinv, jinv.AuditContext(**deepcopy(fields)))
    assert got == want


def test_live_fleet_mutation_trips_audit_and_dumps_postmortem(chaos_runs):
    """Tampering the REAL fleet — an orphaned namespace forged onto a
    member's disk — is caught by the conductor's next audit, and the
    violation lands as a FlightRecorder postmortem bundle."""
    conductor, report, _ = chaos_runs
    assert report.violations == []
    member = conductor.members[0]
    orphan = Path(member.root) / "tenants" / "forged"
    orphan.mkdir(parents=True)
    try:
        found = conductor._audit()
    finally:
        orphan.rmdir()
    assert any(v.invariant == "bounded-disk" and "forged" in v.summary for v in found)
    bundles = [b for b in conductor.recorder.bundles if "invariant" in b.name]
    assert bundles, "an invariant violation must dump a postmortem bundle"
    manifest = json.loads((bundles[-1] / "manifest.json").read_text())
    assert manifest["kind"] == "invariant"
    assert manifest["detail"]["invariant"] == "bounded-disk"


def test_live_fleet_audit_context_matches_reality(chaos_runs):
    """``build_audit_context`` snapshots the fleet faithfully: every
    completed tenant accounted, journals parsed, every member live."""
    conductor, report, _ = chaos_runs
    ctx = build_audit_context(conductor.router, acks=conductor.acks, round=conductor.round,
                              forgotten=conductor.forgotten)
    assert len(ctx.completed) == report.completed
    assert ctx.live_members == set(range(conductor.plan.members))
    assert set(ctx.placements) <= {a["tenant_id"] for a in conductor.acks}
    placement_kinds = {r["kind"] for r in ctx.router_records}
    assert "placement" in placement_kinds or "router" in ctx.compacted_scopes


# -- public kill-point scaffolding -------------------------------------------


def test_kill_points_cover_every_plane():
    from evox_tpu_torch.resilience.testing import KILL_POINTS

    assert {"daemon", "gateway", "router"} <= set(KILL_POINTS)
    assert kill_points("router")
    with pytest.raises(ValueError, match="unknown plane"):
        kill_points("mainframe")


def test_flip_bit_damages_exactly_one_byte(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"\x00" * 64)
    flip_bit(p, offset=10)
    data = p.read_bytes()
    assert len(data) == 64
    assert sum(1 for b in data if b != 0) == 1


def test_evoxtop_chaos_strip(chaos_runs):
    """The ``evoxtop`` screen renders the chaos section the port's
    conducted router publishes — and screams the violation count when
    non-zero."""
    import evoxtop

    conductor, _, _ = chaos_runs
    status = conductor.router._statusz()
    screen = evoxtop.render(status, 200, {"hosts": {}})
    assert f"chaos [{conductor.plan.name}]" in screen
    assert "injected" in screen
    hot = dict(status)
    hot["chaos"] = dict(status["chaos"], violations=2)
    screen = evoxtop.render(hot, 200, {"hosts": {}})
    assert "VIOLATIONS 2" in screen
    assert evoxtop.chaos_violations(hot) == 2
    assert evoxtop.chaos_violations({}) == 0


# -- the soak ladder ----------------------------------------------------------


def _assert_soak_green(report, tenants, wave):
    assert report["violations"] == []
    assert report["completed"] == report["tenants"] == tenants
    assert report["peak_resident_namespaces"] <= wave
    assert report["final_resident_namespaces"] == 0
    assert {"metric", "value", "platform", "slo_burn_report"} <= set(report)
    assert report["value"] > 0
    json.loads(json.dumps(report))


def test_soak_rung_1k_with_chaos(tmp_path):
    """The tier-1 rung of the scale ladder on the port: 1000 tenants churn
    through a 3-member fleet in waves of 250 with a mid-run member SIGKILL
    — zero violations, O(wave) disk, burn-rate report attached."""
    report = soak_torch.run_soak(tmp_path, device="cpu", tenants=1000, members=3, wave=250, chaos=True, seed=7)
    _assert_soak_green(report, 1000, 250)
    assert report["injected_events"] > 0
    assert report["waves"] == 4
    assert report["platform"] == "cpu"


@pytest.mark.slow
def test_soak_100k_proof_run(tmp_path):
    """The 100k proof run: 100k tenants, chaos on, SLO burn-rate report."""
    report = soak_torch.run_soak(tmp_path, device="cpu", tenants=100_000, members=3, wave=500, chaos=True, seed=4)
    _assert_soak_green(report, 100_000, 500)
    assert report["injected_events"] > 0


# -- the JAX package's runs, in a one-device subprocess -----------------------

SOAK_RUNG = dict(tenants=200, members=3, wave=50, chaos=True, seed=7)
SOAK_FIELDS = ("completed", "waves", "injected_events", "violations", "peak_resident_namespaces",
               "final_resident_namespaces", "records_since_snapshot")
REPORT_FIELDS = ("rounds_run", "completed", "acks", "pending", "injected_events", "plan_digest", "violations",
                 "counters")

_JAX_REFERENCE = """
import json, sys
root, out, plan_seed, sizes, rung = sys.argv[1], sys.argv[2], int(sys.argv[3]), json.loads(sys.argv[4]), \\
    json.loads(sys.argv[5])
sys.path.insert(0, sys.argv[6])
sys.path.insert(0, sys.argv[6] + "/tools")
import soak
from evox_tpu.resilience.chaos import ChaosConductor, ChaosPlan
from evox_tpu.utils import ExecutableCache

cache = ExecutableCache(root + "/exec")
result = {"chaos": []}
for tag in ("a", "b"):
    conductor = ChaosConductor(root + "/chaos_" + tag, ChaosPlan.from_seed(plan_seed, **sizes), exec_cache=cache)
    report = conductor.run().to_json()
    conductor.close()
    with open(report["event_log"], "rb") as f:
        report["event_log_bytes"] = f.read().decode()
    result["chaos"].append(report)
soak.ExecutableCache = lambda path: cache
soak.run_soak(root + "/soak_warm", tenants=16, members=rung["members"], wave=16, chaos=False, seed=rung["seed"])
result["soak"] = soak.run_soak(root + "/soak", **rung)
with open(out, "w") as f:
    json.dump(result, f)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX package's conductor (twice) and soak rung, run on one CPU
    device in a subprocess; their reports."""
    root = tmp_path_factory.mktemp("jax_chaos")
    out = root / "reference.json"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_REFERENCE, str(root), str(out), str(PLAN_SEED), json.dumps(PLAN_SIZES),
         json.dumps(SOAK_RUNG), str(REPO)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_conductor_run_equals_jax(chaos_runs, jax_reference):
    """The acceptance plan's event journal, byte for byte, and the
    report's counts and counters equal the JAX conductor's."""
    conductor, report, _ = chaos_runs
    first, warm = jax_reference["chaos"]
    assert first["event_log_sha256"] == warm["event_log_sha256"]
    assert Path(report.event_log).read_text() == warm["event_log_bytes"]
    assert report.event_log_sha256 == warm["event_log_sha256"]
    ours = report.to_json()
    assert {k: ours[k] for k in REPORT_FIELDS} == {k: warm[k] for k in REPORT_FIELDS}
    assert ours["plan_digest"] == ChaosPlan.from_seed(PLAN_SEED, **PLAN_SIZES).digest()


def test_soak_rung_equals_jax(tmp_path, jax_reference):
    """The 200-tenant soak rung's counts equal the JAX soak's."""
    report = soak_torch.run_soak(tmp_path, device="cpu", **SOAK_RUNG)
    want = jax_reference["soak"]
    assert {k: report[k] for k in SOAK_FIELDS} == {k: want[k] for k in SOAK_FIELDS}
    assert report["metric"] == want["metric"]
    _assert_soak_green(report, SOAK_RUNG["tenants"], SOAK_RUNG["wave"])


def test_chaos_modules_import_no_jax():
    files = [REPO / "evox_tpu_torch" / "resilience" / "invariants.py",
             REPO / "evox_tpu_torch" / "resilience" / "chaos.py",
             REPO / "tools" / "soak_torch.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "evox_tpu"), (f, n)
