"""The port's tenant router and its members (``evox_tpu_torch/service/router.py``,
``service/member.py``) on the CPU, at the JAX router suite's sizes
(``tests/test_router.py``: two members of ``test_torch_daemon.make_daemon``'s
shape — PSO(8, ±32 in dim 4) on Ackley, 4 lanes, segments of 4,
``device="cpu"`` — over one heartbeat directory).

Every test of ``tests/test_router.py`` has its counterpart here under the
same name: fleet-config validation, placement and bucket affinity, the
``no-members`` refusal, the routed fleet bit-identical to one daemon, the
kill at every forward boundary (SIGKILL modelled as abandonment: the router
object is dropped with no shutdown path running and a fresh one is built
over the same root and members), the restart's placement map, member-link
chaos, steer, dead-member migration bit-identical to one daemon, the
autoscale decider, drain-then-retire and growth, the gateway over the
router, ``tools/evoxtop.py`` against the router's ``/statusz``, the fold,
compaction and a kill at every compaction boundary.

Held against the JAX package on the same inputs, exactly (random streams
differ between the frameworks, so what is deterministic):

(a) ``fold_router_records`` on hypothesis-drawn record streams
    (placements, migrations, drains, retires, steers, parks, duplicates,
    idempotency keys, a snapshot base folded from a prefix; the spec blobs
    opaque strings) gives the same state and anomalies;
(b) ``ServiceMember.request`` gives the same status codes, error names,
    reply key sets and deterministic values for malformed JSON, a
    non-object body, unknown routes, ``GET /capacity``, a 405, bad spec
    blobs, unknown tenants, id and uid collisions, a shed (429), a steer
    and a park;
(c) one placement script over two members of 4 lanes each — submits of two
    buckets, a round, an affinity placement, a steer, a park, a member
    marked draining, a refused ``uid-mismatch`` and ``no-members`` — gives
    the same placement map (tenant → member, uid), the same refusal
    reasons and retry hints, and the same router-journal record kinds and
    fields in order (spec blobs left out; the bucket labels, whose digests
    are each framework's own, compared by the partition they name).

The port alone: members on two devices are refused, a member without
``device=`` runs its daemon on the card, the link's spec blob is
device-free, and the providers that endpoint and beat threads call read no
tensor.  On the card, ``tests/test_torch_cuda.py`` (``-k router``) holds
the capture rule and the card-built/host-built blob, and ``chip_smoke.py``'s
``router_main_path``, ``router_kill_restart`` and ``router_overhead`` drive
the router at full width.
"""

import json
import os
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import test_daemon as jtd  # noqa: E402
from evox_tpu.service import AdmissionError as JAdmissionError  # noqa: E402
from evox_tpu.service import RequestJournal as JRequestJournal  # noqa: E402
from evox_tpu.service import ServiceMember as JServiceMember  # noqa: E402
from evox_tpu.service import TenantClass as JTenantClass  # noqa: E402
from evox_tpu.service import TenantRouter as JTenantRouter  # noqa: E402
from evox_tpu.service.journal import JournalRecord as JJournalRecord  # noqa: E402
from evox_tpu.service.router import fold_router_records as jfold_router_records  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_daemon import N_TENANTS, _reference_results, make_daemon, pso_spec, shared_cache  # noqa: E402

from evox_tpu_torch.control import Controller, decide, decide_autoscale  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore, FaultyTransport  # noqa: E402
from evox_tpu_torch.resilience.testing import (  # noqa: E402
    assert_states_equal,
    kill_points,
    last_checkpoint_digests,
    run_silently,
    silent,
)
from evox_tpu_torch.service import (  # noqa: E402
    MEMBER_API_PREFIX,
    AdmissionError,
    Gateway,
    GatewayClient,
    RequestJournal,
    ServiceMember,
    TenantClass,
    TenantRouter,
)
from evox_tpu_torch.service import member as member_module  # noqa: E402
from evox_tpu_torch.service.daemon import _encode_spec  # noqa: E402
from evox_tpu_torch.service.journal import JournalRecord  # noqa: E402
from evox_tpu_torch.service.router import _link_blob, fold_router_records  # noqa: E402

TOKENS = {"tok-alice": "alice"}


def make_member(index, root, heartbeat_dir, **overrides):
    kwargs = dict(
        lanes_per_pack=4,
        segment_steps=4,
        seed=0,
        preemption=False,
        brownout_threshold=None,
        exec_cache=shared_cache(),
        device="cpu",
    )
    kwargs.update(overrides)
    return ServiceMember(index, root, heartbeat_dir=heartbeat_dir, **kwargs)


def make_fleet(tmp_path, n=2, member_overrides=None, **router_kwargs):
    beats = tmp_path / "beats"
    members = [make_member(i, tmp_path / f"m{i}", beats, **(member_overrides or {})) for i in range(n)]
    router_kwargs.setdefault("fleet_dead_after", 300.0)
    router_kwargs.setdefault("fleet_start_grace", 0.0)
    router = TenantRouter(tmp_path / "router", members, **router_kwargs)
    return router, members


def journal_kinds(path, tenant_id=None):
    records, damage = RequestJournal(path).replay()
    assert damage is None
    counts = {}
    for rec in records:
        if tenant_id is not None and rec.data.get("tenant_id") != tenant_id:
            continue
        counts[rec.kind] = counts.get(rec.kind, 0) + 1
    return counts


def member_submit_count(member_root, tenant_id):
    return journal_kinds(member_root / "journal.jsonl", tenant_id).get("submit", 0)


# -- fleet configuration validation -----------------------------------------


def test_fleet_config_validation(tmp_path):
    beats = tmp_path / "beats"
    with pytest.raises(ValueError, match="at least one member"):
        TenantRouter(tmp_path / "r0", [])
    # Split heartbeat planes: FleetHealth verdicts need one beat dir.
    split = [
        make_member(0, tmp_path / "a0", tmp_path / "beats-a"),
        make_member(1, tmp_path / "a1", tmp_path / "beats-b"),
    ]
    with pytest.raises(ValueError, match="heartbeat directories"):
        TenantRouter(tmp_path / "r1", split)
    # Seed disagreement: migration would not be bit-identical.
    mixed_seed = [make_member(0, tmp_path / "b0", beats), make_member(1, tmp_path / "b1", beats, seed=7)]
    with pytest.raises(ValueError, match="seed"):
        TenantRouter(tmp_path / "r2", mixed_seed)
    # Cadence disagreement: checkpoints would land on different grids.
    mixed_cadence = [make_member(0, tmp_path / "c0", beats), make_member(1, tmp_path / "c1", beats, segment_steps=8)]
    with pytest.raises(ValueError, match="segment_steps"):
        TenantRouter(tmp_path / "r3", mixed_cadence)
    # Duplicate index / shared root: identity and journals must be 1:1.
    with pytest.raises(ValueError, match="duplicate member index"):
        TenantRouter(tmp_path / "r4", [make_member(0, tmp_path / "d0", beats), make_member(0, tmp_path / "d1", beats)])
    shared = make_member(0, tmp_path / "e0", beats)
    with pytest.raises(ValueError, match="distinct"):
        TenantRouter(tmp_path / "r5", [shared, ServiceMember(1, tmp_path / "e0", daemon=shared.daemon)])
    with pytest.raises(ValueError, match="min_members"):
        TenantRouter(tmp_path / "r6", [make_member(0, tmp_path / "f0", beats)], min_members=2, max_members=1)


def test_members_on_different_devices_are_refused(tmp_path):
    """The port's own check beside seed and cadence: a migrated tenant is
    only bit-identical on the device it ran on, so the members must share
    one; the refusal names the devices."""
    beats = tmp_path / "beats"
    members = [make_member(0, tmp_path / "a0", beats), make_member(1, tmp_path / "a1", beats, device="meta")]
    with pytest.raises(ValueError, match=r"different devices \(\['cpu', 'meta'\]\)"):
        TenantRouter(tmp_path / "r", members)


def test_a_member_without_device_runs_its_daemon_on_the_card(tmp_path):
    member = ServiceMember(0, tmp_path / "m0", heartbeat_dir=tmp_path / "beats")
    assert member.daemon.device == torch.device("cuda")


# -- placement ---------------------------------------------------------------


def test_placement_spreads_and_journals_before_ack(tmp_path):
    router, members = make_fleet(tmp_path)
    try:
        router.start()
        for i in range(4):
            router.submit(pso_spec(f"t{i}", i), journal_extra={"idempotency_key": f"k{i}"})
        placed = {tid: p["member"] for tid, p in router._placements.items()}
        # Least-loaded spread with ties to the lowest index: 2 + 2.
        assert sorted(placed.values()).count(0) == 2
        assert sorted(placed.values()).count(1) == 2
        records, damage = RequestJournal(router.root / TenantRouter.JOURNAL_NAME).replay()
        assert damage is None
        placements = [r for r in records if r.kind == "placement"]
        assert len(placements) == 4
        # The ack carried the gateway idempotency key into the journal, and
        # every record landed with the uid pinned at placement time.
        assert {r.data["idempotency_key"] for r in placements} == {"k0", "k1", "k2", "k3"}
        assert all(p["confirmed"] for p in router._placements.values())
    finally:
        router.close()


def test_bucket_affinity_packs_dense(tmp_path):
    router, members = make_fleet(tmp_path)
    try:
        router.start()
        router.submit(pso_spec("t0", 0, n_steps=8))
        first = router._placements["t0"]["member"]
        router.step()  # t0 is now RUNNING: its bucket has a warm lane
        router.submit(pso_spec("t1", 1, n_steps=8))
        # Affinity beats least-loaded: the same-bucket tenant lands beside
        # t0 even though the other member is empty.
        assert router._placements["t1"]["member"] == first
        run_silently(router)
    finally:
        router.close()


def test_no_members_refusal_is_retryable(tmp_path):
    router, members = make_fleet(tmp_path, n=1)
    try:
        router.start()
        members[0].draining = True
        with pytest.raises(AdmissionError) as err:
            router.submit(pso_spec("t0", 0))
        assert err.value.reason == "no-members"
        # No cadence measured yet, so the hint is in segments (the daemon's
        # shed contract): the gateway still sends Retry-After.
        assert err.value.retry_after_segments == 1
        members[0].draining = False
        router.submit(pso_spec("t0", 0))  # the retry lands
        run_silently(router)
        assert router.result("t0") is not None
    finally:
        router.close()


# -- acceptance: routed == single daemon, bit for bit ------------------------


def test_routed_fleet_bit_identical_to_single_daemon(tmp_path):
    reference, ref_digests = _reference_results()
    router, members = make_fleet(tmp_path)
    try:
        router.start()
        for i in range(N_TENANTS):
            router.submit(pso_spec(f"t{i}", i))
        run_silently(router)
        for i in range(N_TENANTS):
            tid = f"t{i}"
            assert_states_equal(router.result(tid), reference[tid], context=tid)
            owner = router._placements[tid]["member"]
            assert last_checkpoint_digests(tmp_path / f"m{owner}", tid) == ref_digests[tid]
    finally:
        router.close()


# -- acceptance: kill the router at every forward boundary -------------------


@pytest.mark.parametrize("boundary", kill_points("router"))
def test_router_kill_at_forward_boundary_exactly_once(tmp_path, boundary):
    ref = make_daemon(tmp_path / "ref")
    ref.start()
    ref.submit(pso_spec("t0", 0))
    run_silently(ref)
    expected = ref.result("t0")
    ref.close()

    router, members = make_fleet(tmp_path)
    if boundary == "pre-journal":
        # The placement record never reaches the disk: ENOSPC mid-append.
        router.journal.close()
        router.journal = RequestJournal(router.root / TenantRouter.JOURNAL_NAME, store=FaultyStore(enospc_saves=[0]))
        router.controller.journal = router.journal
    router.start()
    if boundary == "post-journal-pre-forward":
        router.links[0] = FaultyTransport(members[0], drop_requests=[0])
    elif boundary == "post-forward-pre-ack":
        router.links[0] = FaultyTransport(members[0], drop_replies=[0])
    with pytest.raises(AdmissionError) as err:
        silent(router.submit, pso_spec("t0", 0))
    assert err.value.reason == ("journal-failed" if boundary == "pre-journal" else "member-link")
    # SIGKILL model: the router object is abandoned — no close(), no flush
    # — and a fresh router is built over the same root + members.
    router2 = TenantRouter(tmp_path / "router", members, fleet_dead_after=300.0, fleet_start_grace=0.0)
    try:
        restored = silent(router2.start)
        assert restored == (0 if boundary == "pre-journal" else 1)
        ack = router2.submit(pso_spec("t0", 0))  # the client's retry
        assert int(ack.uid) == 0
        run_silently(router2)
        assert_states_equal(router2.result("t0"), expected, context=boundary)
        # Exactly once on both planes: one member admission, one router
        # placement decision — no matter where the first attempt died.
        assert member_submit_count(tmp_path / "m0", "t0") == 1
        kinds = journal_kinds(router2.root / TenantRouter.JOURNAL_NAME, "t0")
        assert kinds.get("placement", 0) == 1
    finally:
        router2.close()


def test_router_restart_rebuilds_placement_map_and_dedups(tmp_path):
    router, members = make_fleet(tmp_path)
    router.start()
    for i in range(N_TENANTS):
        router.submit(pso_spec(f"t{i}", i))
    router.step()
    before = {tid: (p["member"], p["uid"]) for tid, p in router._placements.items()}
    # Abandon mid-run (no shutdown path), rebuild over the same root.
    router2 = TenantRouter(tmp_path / "router", members, fleet_dead_after=300.0, fleet_start_grace=0.0)
    try:
        assert router2.start() == N_TENANTS
        after = {tid: (p["member"], p["uid"]) for tid, p in router2._placements.items()}
        assert after == before
        # A duplicate submit of an already-confirmed placement is an
        # idempotent ack: same uid, no new journal record.
        ack = router2.submit(pso_spec("t0", 0))
        assert int(ack.uid) == before["t0"][1]
        kinds = journal_kinds(router2.root / TenantRouter.JOURNAL_NAME)
        assert kinds.get("placement", 0) == N_TENANTS
        run_silently(router2)
        for i in range(N_TENANTS):
            assert router2.result(f"t{i}") is not None
    finally:
        router2.close()


# -- member-link chaos -------------------------------------------------------


def test_member_link_chaos_degrades_then_retry_reuses_placement(tmp_path):
    router, members = make_fleet(tmp_path, n=1)
    try:
        router.start()
        # Torn reply: the member ADMITS but the router never hears it.
        router.links[0] = FaultyTransport(members[0], torn_replies=[0])
        with pytest.raises(AdmissionError) as err:
            silent(router.submit, pso_spec("t0", 0))
        assert err.value.reason == "member-link"
        assert err.value.retry_after_segments == 1
        assert router._link_faults[0] == 1
        # The retry reuses the journaled placement (no re-append) and
        # reconciles against the member's resident tenant by uid.
        ack = silent(router.submit, pso_spec("t0", 0))
        assert int(ack.uid) == 0
        assert member_submit_count(tmp_path / "m0", "t0") == 1
        kinds = journal_kinds(router.root / TenantRouter.JOURNAL_NAME, "t0")
        assert kinds.get("placement", 0) == 1
        run_silently(router)
        assert router.result("t0") is not None
    finally:
        router.close()


# -- steer / park through the router ----------------------------------------


def test_steer_forwarded_and_journaled(tmp_path):
    router, members = make_fleet(tmp_path, n=1)
    try:
        router.start()
        router.submit(pso_spec("t0", 0, n_steps=8))
        knobs = router.steer("t0", n_steps=16, journal_extra={"idempotency_key": "s1"})
        assert knobs["n_steps"] == 16
        records, _ = RequestJournal(router.root / TenantRouter.JOURNAL_NAME).replay()
        steers = [r for r in records if r.kind == "steer"]
        assert len(steers) == 1
        assert steers[0].data["idempotency_key"] == "s1"
        with pytest.raises(KeyError):
            router.steer("nope", n_steps=4)
        # A steer to a dead owner is a structured retryable refusal: the
        # tenant migrates at the next health check.
        router._dead.add(0)
        with pytest.raises(AdmissionError) as err:
            router.steer("t0", n_steps=20)
        assert err.value.reason == "member-down"
        router._dead.clear()
        run_silently(router)
        # The steered budget applied: the tenant ran past its original
        # 8-generation budget to the new one.
        assert router.tenant("t0").generations >= 16
    finally:
        router.close()


# -- acceptance: dead-member migration is bit-identical ----------------------


def test_dead_member_migration_bit_identical(tmp_path):
    reference, ref_digests = _reference_results()
    router, members = make_fleet(tmp_path)
    try:
        router.start()
        for i in range(N_TENANTS):
            router.submit(pso_spec(f"t{i}", i))
        for _ in range(2):  # warm: every tenant runs + checkpoints
            router.step()
        victims = {p["member"] for p in router._placements.values()}
        victim = min(victims)
        survivor = 1 - victim
        victim_tenants = [tid for tid, p in router._placements.items() if p["member"] == victim]
        assert victim_tenants
        # Freeze the victim's heartbeat (the process vanished); keep the
        # survivor visibly alive, then tighten the staleness threshold —
        # the next round's verdict declares the victim dead.
        deadline = time.time() + 0.7
        while time.time() < deadline:
            members[survivor].beat()
            time.sleep(0.05)
        router.fleet_dead_after = 0.4
        silent(router.step)
        assert victim in router._dead
        for tid in victim_tenants:
            assert router._placements[tid]["member"] == survivor
        run_silently(router)
        # Every tenant — migrated or not — finishes bit-identical to the
        # uninterrupted single-daemon reference: final state, monitor
        # history, and checkpoint leaf digests.
        for i in range(N_TENANTS):
            tid = f"t{i}"
            assert_states_equal(router.result(tid), reference[tid], context=tid)
            owner = router._placements[tid]["member"]
            assert last_checkpoint_digests(tmp_path / f"m{owner}", tid) == ref_digests[tid]
        # The migrations are journaled (replayable placement authority) and
        # surfaced on the status plane.
        records, _ = RequestJournal(router.root / TenantRouter.JOURNAL_NAME).replay()
        migrations = [r for r in records if r.kind == "migration"]
        assert {r.data["tenant_id"] for r in migrations} == set(victim_tenants)
        assert all(r.data["from"] == victim for r in migrations)
        status = router._statusz()
        assert status["router"]["members"][str(victim)]["state"] == "dead"
        assert len(status["router"]["migrations"]) == len(victim_tenants)
        healthy, payload = router._healthz()
        assert not healthy and payload["dead_members"] == [victim]
    finally:
        router.close()


# -- autoscale ---------------------------------------------------------------


def _evidence(**overrides):
    evidence = {
        "members": 2,
        "draining": 0,
        "min_members": 1,
        "max_members": None,
        "shed_rounds": 0,
        "shed_sustain": None,
        "burn_rate": None,
        "burn_enter": None,
        "queued": 0,
        "idle_member": None,
        "drained_member": None,
    }
    evidence.update(overrides)
    return evidence


def test_decide_autoscale_is_pure_and_total():
    assert decide_autoscale(_evidence()) == "hold"
    assert decide_autoscale(_evidence(shed_rounds=3, shed_sustain=2)) == "grow"
    # Pressure, but the fleet is at its cap.
    assert decide_autoscale(_evidence(shed_rounds=3, shed_sustain=2, max_members=2)) == "hold"
    assert decide_autoscale(_evidence(burn_rate=2.5, burn_enter=2.0)) == "grow"
    assert decide_autoscale(_evidence(drained_member=1)) == "retire:1"
    assert decide_autoscale(_evidence(idle_member=1)) == "drain:1"
    assert decide_autoscale(_evidence(idle_member=1, members=1)) == "hold"  # never below min_members
    assert decide_autoscale(_evidence(idle_member=1, queued=3)) == "hold"  # queued work wants those lanes
    # Pure: the same evidence always yields the same action, via the shared
    # decide() registry too.
    evidence = _evidence(shed_rounds=5, shed_sustain=2)
    assert all(decide("autoscale", evidence) == "grow" for _ in range(3))


def test_autoscale_drains_then_retires_idle_member(tmp_path):
    router, members = make_fleet(tmp_path, controller=Controller(grace=1), autoscale_drain=True, min_members=1)
    try:
        router.start()
        router.submit(pso_spec("t0", 0, n_steps=4))
        run_silently(router)
        for _ in range(6):  # idle rounds: drain fires, then retire
            silent(router.step)
        retired = [i for i, m in router.members.items() if m.retired]
        assert len(retired) == 1
        live = [i for i, m in router.members.items() if not m.retired and not m.draining]
        assert len(live) == router.min_members
        # Completed results stay fetchable even off a retired member.
        assert router.result("t0") is not None
        # Every non-hold decision is journaled with its full evidence and
        # replays bit-for-bit through the pure decider.
        records, _ = RequestJournal(router.root / TenantRouter.JOURNAL_NAME).replay()
        kinds = {r.kind for r in records}
        assert {"drain-member", "retire-member"} <= kinds
        decisions = [
            r.data["decision"]
            for r in records
            if r.kind == "decision" and r.data["decision"]["kind"] == "autoscale"
        ]
        assert [d["action"] for d in decisions] == [f"drain:{retired[0]}", f"retire:{retired[0]}"]
        for d in decisions:
            assert decide("autoscale", d["evidence"]) == d["action"]
        # The retirement is durable: a rebuilt router replays it.
        router3 = TenantRouter(tmp_path / "router", members, fleet_start_grace=0.0)
        silent(router3.start)
        assert router3.members[retired[0]].retired
    finally:
        router.close()


def test_autoscale_grows_under_shed_pressure(tmp_path):
    beats = tmp_path / "beats"

    def spawn(index):
        return make_member(index, tmp_path / f"m{index}", beats)

    router, members = make_fleet(
        tmp_path, n=1, controller=Controller(grace=1), autoscale_shed_rounds=2, max_members=2, spawn_member=spawn
    )
    try:
        router.start()
        # Sustained shed pressure on the evidence plane: the admission layer
        # counted sheds in consecutive rounds.
        for _ in range(2):
            members[0].daemon.stats.sheds += 1
            silent(router.step)
        assert router.growth_requested == 1
        assert sorted(router.members) == [0, 1]
        assert router.members[1].daemon.started
        # At the cap: more pressure holds instead of growing.
        for _ in range(3):
            members[0].daemon.stats.sheds += 1
            silent(router.step)
        assert router.growth_requested == 1
        # The new member is immediately placeable.
        members[0].draining = True
        router.submit(pso_spec("t0", 0, n_steps=4))
        assert router._placements["t0"]["member"] == 1
        run_silently(router)
        assert router.result("t0") is not None
    finally:
        router.close()


# -- the HTTP plane: gateway over router -------------------------------------


def test_gateway_over_router_exactly_once_and_status_planes(tmp_path):
    router, members = make_fleet(tmp_path)
    gateway = Gateway(router, tokens=TOKENS)
    gateway.start()
    try:
        client = GatewayClient(router.endpoint.url, "tok-alice", backoff=0.01, retry_after_cap=0.05)
        spec = pso_spec("t0", None, n_steps=8)
        ack = client.submit(spec, idem_key="key-1")
        replay = client.submit(spec, idem_key="key-1")
        assert replay["uid"] == ack["uid"]
        # Internally the tenant lives under its principal-qualified id.
        assert "alice--t0" in router._placements
        owner = router._placements["alice--t0"]["member"]
        assert member_submit_count(tmp_path / f"m{owner}", "alice--t0") == 1
        # Member-link chaos under a live client: the refusal surfaces as
        # 503 + Retry-After and the client's automatic retry lands the
        # tenant exactly once on the journaled placement.
        router.links[owner] = FaultyTransport(router.members[owner], drop_requests=[0])
        router.links[1 - owner] = FaultyTransport(router.members[1 - owner], drop_requests=[0])
        ack2 = silent(client.submit, pso_spec("t1", None, n_steps=8))
        assert client.retries >= 1
        owner2 = router._placements["alice--t1"]["member"]
        assert member_submit_count(tmp_path / f"m{owner2}", "alice--t1") == 1
        run_silently(router)
        assert client.result("t0")["status"] == "completed"
        assert client.result("t1")["status"] == "completed"
        # One status document spans all three planes: fleet, control, and
        # front door.
        status = router._statusz()
        assert "router" in status and "gateway" in status
        assert status["gateway"]["principals"]["alice"] == 2
        assert ack2["uid"] != ack["uid"]
        assert "alice--t1" in status["tenants"]
        healthy, _ = router._healthz()
        assert healthy
    finally:
        router.close()


# -- evoxtop: the operator view ----------------------------------------------


def test_evoxtop_renders_router_view_and_probes_dead_members(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    try:
        import evoxtop
    finally:
        sys.path.pop(0)
    router, members = make_fleet(tmp_path)
    try:
        router.start()
        router.submit(pso_spec("t0", 0, n_steps=4))
        run_silently(router)
        status = router._statusz()
        screen = evoxtop.render(status, 200, {"healthy": True})
        assert "router members (2)" in screen
        assert evoxtop.router_dead_members(status) == []
        drill = evoxtop.render(status, 200, {"healthy": True}, member=0)
        assert "member 0 [ok]" in drill
        # A dead member flips the one-shot probe to rc 2.
        router._dead.add(1)
        status = router._statusz()
        assert evoxtop.router_dead_members(status) == [1]
        assert "1:dead" in evoxtop.render(status, 200, {"healthy": False})
    finally:
        router.close()


# -- journal compaction: snapshot-anchored router recovery -------------------


def test_fold_router_records_placements_members_and_idem():
    def rec(seq, kind, **data):
        return JournalRecord(seq=seq, kind=kind, at=0.0, data=data)

    records = [
        rec(0, "placement", tenant_id="t0", uid=0, member=0, bucket="b", spec="s0", idem="k0", principal="alice",
            **{"class": "standard"}),
        rec(1, "placement", tenant_id="t1", uid=1, member=1, bucket="b", spec="s1", **{"class": "standard"}),
        rec(2, "migration", tenant_id="t1", uid=1, member=0, bucket="b", spec="s1", reason="member-dead",
            **{"from": 1, "class": "standard"}),
        rec(3, "drain-member", member=1),
        rec(4, "retire-member", member=1),
        # Last placement wins (a re-placement after the retire).
        rec(5, "placement", tenant_id="t0", uid=4, member=0, bucket="b", spec="s0v2", **{"class": "standard"}),
        rec(6, "steer", tenant_id="t0", uid=4, member=0, n_steps=24, idem="k1", principal="alice"),
    ]
    state, anomalies = fold_router_records(records)
    assert anomalies == []
    assert set(state["placements"]) == {"t0", "t1"}
    assert state["placements"]["t0"]["uid"] == 4
    assert state["placements"]["t0"]["spec"] == "s0v2"
    assert state["placements"]["t0"]["auto"] is False
    # Migration provenance survives the fold (statusz migration tail).
    t1 = state["placements"]["t1"]
    assert t1["auto"] is True and t1["from"] == 1
    assert t1["reason"] == "member-dead" and t1["member"] == 0
    # retire-member discards the drain mark.
    assert state["drained"] == [] and state["retired"] == [1]
    assert state["uid_next"] == 5
    # The gateway dedup map survives compaction through the fold.
    assert state["idem"]["alice:k0"]["route"] == "placement"
    assert state["idem"]["alice:k1"]["knobs"] == {"n_steps": 24}
    # Folding the fold's own output as a base is a fixed point.
    again, _ = fold_router_records([], base=state)
    assert again == state


def test_router_compaction_fires_and_snapshot_anchored_restart(tmp_path):
    """Journal growth -> the shared ``compact`` decider -> placement-map
    snapshot; a SIGKILLed router restarts anchored on the snapshot with the
    identical placement map and exactly-once dedup intact."""
    router, members = make_fleet(tmp_path, compact_records=4)
    router.start()
    for i in range(N_TENANTS):
        router.submit(pso_spec(f"t{i}", i))
    for i in range(N_TENANTS):
        # Steer to the budget the tenants already have: journal growth with
        # unchanged scheduling.
        router.steer(f"t{i}", n_steps=12)
    silent(router.step)  # the boundary where the decider fires
    assert router.compactions >= 1 and router.compaction_failures == 0
    assert router.journal.snapshot_seq is not None
    before = {tid: (p["member"], p["uid"]) for tid, p in router._placements.items()}
    # SIGKILL model: abandon the router, rebuild over the same root.
    router2 = TenantRouter(
        tmp_path / "router", members, fleet_dead_after=300.0, fleet_start_grace=0.0, compact_records=4
    )
    try:
        assert silent(router2.start) == N_TENANTS
        assert router2.journal.snapshot_seq is not None  # anchored
        assert router2.journal.snapshot_fallbacks == 0
        assert router2.replay_seconds is not None
        after = {tid: (p["member"], p["uid"]) for tid, p in router2._placements.items()}
        assert after == before
        # The placement records live only in the snapshot now — and a
        # duplicate submit still dedups to the journaled ack.
        kinds = journal_kinds(router2.root / TenantRouter.JOURNAL_NAME)
        assert kinds.get("placement", 0) == 0
        ack = router2.submit(pso_spec("t0", 0))
        assert int(ack.uid) == before["t0"][1]
        assert member_submit_count(tmp_path / f"m{before['t0'][0]}", "t0") == 1
        run_silently(router2)
        for i in range(N_TENANTS):
            assert router2.result(f"t{i}") is not None
        strip = router2._statusz()["journal"]
        assert strip["armed"] is True
        assert strip["snapshot_seq"] == router2.journal.snapshot_seq
        assert strip["decisions"] == []  # fired pre-kill, not replayed
    finally:
        router2.close()


@pytest.mark.parametrize(
    "boundary", ["mid-snapshot-publish", "post-snapshot-pre-copy", "post-copy-pre-swap", "post-swap-pre-gc"]
)
def test_router_kill_at_compaction_boundary_exactly_once(tmp_path, boundary):
    """SIGKILL at every boundary of the router's compaction protocol: the
    restarted router rebuilds the identical placement map and a client
    retry stays exactly-once on both planes."""
    router, members = make_fleet(tmp_path)
    router.start()
    for i in range(N_TENANTS):
        router.submit(pso_spec(f"t{i}", i))
    silent(router.step)  # mid-run: members hold live lanes
    before = {tid: (p["member"], p["uid"]) for tid, p in router._placements.items()}
    if boundary == "post-swap-pre-gc":
        silent(router._compact_journal)
        assert router.compactions == 1 and router.compaction_failures == 0
    else:
        step = {"mid-snapshot-publish": 0, "post-snapshot-pre-copy": 1, "post-copy-pre-swap": 2}[boundary]
        router.journal.store = FaultyStore(crash_saves=[step])
        silent(router._compact_journal)
        assert router.compactions == 0 and router.compaction_failures == 1
    # SIGKILL: abandoned mid-protocol, no shutdown path runs.
    router2 = TenantRouter(tmp_path / "router", members, fleet_dead_after=300.0, fleet_start_grace=0.0)
    try:
        assert silent(router2.start) == N_TENANTS
        after = {tid: (p["member"], p["uid"]) for tid, p in router2._placements.items()}
        assert after == before
        if boundary == "post-swap-pre-gc":
            assert router2.journal.snapshot_seq is not None
        else:
            # The swap never committed: plain full replay, all records.
            assert router2.journal.snapshot_seq is None
            kinds = journal_kinds(router2.root / TenantRouter.JOURNAL_NAME)
            assert kinds.get("placement", 0) == N_TENANTS
        # The client's retry of an already-placed tenant is an idempotent
        # ack: one member admission, no new placement.
        ack = router2.submit(pso_spec("t0", 0))
        assert int(ack.uid) == before["t0"][1]
        assert member_submit_count(tmp_path / f"m{before['t0'][0]}", "t0") == 1
        run_silently(router2)
        for i in range(N_TENANTS):
            assert router2.result(f"t{i}") is not None
    finally:
        router2.close()


# -- the port's device and thread rules --------------------------------------


def test_link_blob_is_device_free(tmp_path):
    """The placement record's blob is the spec encoded from the host: a
    host-built spec's blob is its plain encoding, and the same tenant whose
    algorithm records the card as its device gives the same bytes (the
    retry check compares them), while its plain encoding differs."""
    host = pso_spec("t0", 0)
    assert _link_blob(host) == _encode_spec(host)
    card_named = pso_spec("t0", 0)
    card_named.algorithm.device = torch.device("cuda")
    assert _encode_spec(card_named) != _encode_spec(host)
    assert _link_blob(card_named) == _link_blob(host)


def test_router_takes_specs_on_the_host_and_members_decode_onto_their_device(tmp_path, monkeypatch):
    router, members = make_fleet(tmp_path)
    decoded = []
    real = member_module._decode_spec

    def watched(blob, device):
        decoded.append(device)
        return real(blob, device)

    monkeypatch.setattr(member_module, "_decode_spec", watched)
    try:
        router.start()
        assert router.device == torch.device("cpu")
        router.submit(pso_spec("t0", 0))
        assert decoded == [members[0].daemon.device]
        # The gateway in front reads the same surface a daemon offers.
        assert router.journal is not None and router._last_segment_seconds is None
    finally:
        router.close()


def test_providers_read_no_tensor(tmp_path):
    """``capacity()``, ``load()`` and the router's ``/statusz``,
    ``/healthz`` and ``/metrics`` providers run on beat and endpoint
    threads, possibly while the serving thread holds a capture open: they
    read host state only — no tensor operation runs inside them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Ops.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    router, members = make_fleet(tmp_path)
    try:
        router.start()
        for i in range(N_TENANTS):
            router.submit(pso_spec(f"t{i}", i))
        router.step()
        with Ops():
            for m in members:
                m.capacity()
                m.load()
                m.beat()
            router._statusz()
            router._healthz()
            router._metrics_text()
            router._flight_window("t0")
        assert Ops.seen == []
    finally:
        router.close()


# -- against the JAX package -------------------------------------------------

ROUTER_KINDS = ("placement", "migration", "drain-member", "retire-member", "steer", "park", "decision")


@st.composite
def router_streams(draw):
    """A router record stream as a journal could hold it: any order of
    kinds over a few tenants (duplicates, migrations before placements,
    drains and retires of any member), opaque spec strings, steer knobs and
    gateway idempotency fields."""
    out = []
    for seq in range(draw(st.integers(0, 24))):
        kind = draw(st.sampled_from(ROUTER_KINDS))
        data = {}
        if kind in ("placement", "migration", "steer", "park"):
            data["uid"] = draw(st.integers(0, 4))
            data["tenant_id"] = f"t{data['uid']}"
            data["member"] = draw(st.integers(0, 2))
        if kind in ("placement", "migration"):
            data.update({"spec": draw(st.sampled_from(["AAA=", "BBB="])), "bucket": draw(st.sampled_from(["b", "c"])),
                         "class": draw(st.sampled_from(["standard", "batch"]))})
        if kind == "migration":
            data["from"] = draw(st.integers(0, 2))
            if draw(st.booleans()):
                data["reason"] = draw(st.sampled_from(["dead-member", "resubmit-dead-owner"]))
        if kind in ("drain-member", "retire-member"):
            data["member"] = draw(st.integers(0, 2))
        if kind == "steer":
            for knob in ("n_steps", "checkpoint_every", "max_restarts"):
                if draw(st.booleans()):
                    data[knob] = draw(st.integers(0, 100))
        if draw(st.integers(0, 3)) == 0:
            data.update(idem=draw(st.sampled_from(["k1", "k2"])), principal="alice")
        out.append((seq, kind, data))
    return out


def _records(cls, stream):
    return [cls(seq=seq, kind=kind, at=0.0, data=dict(data)) for seq, kind, data in stream]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(stream=router_streams(), split=st.integers(0, 24))
def test_fold_router_records_equals_jax(stream, split):
    """Replay's and compaction's fold: the same state and anomalies as the
    JAX package's on the same records, with and without a snapshot base
    folded from a prefix (and base + suffix equals the whole fold)."""
    got = fold_router_records(_records(JournalRecord, stream))
    want = jfold_router_records(_records(JJournalRecord, stream))
    assert got == want
    split = min(split, len(stream))
    base, _ = fold_router_records(_records(JournalRecord, stream[:split]))
    jbase, _ = jfold_router_records(_records(JJournalRecord, stream[:split]))
    assert base == jbase
    suffix = fold_router_records(_records(JournalRecord, stream[split:]), base=base)
    assert suffix == jfold_router_records(_records(JJournalRecord, stream[split:]), base=jbase)
    assert suffix[0] == got[0]


def jmake_member(index, root, heartbeat_dir, **overrides):
    kwargs = dict(
        lanes_per_pack=4,
        segment_steps=4,
        seed=0,
        preemption=False,
        brownout_threshold=None,
        # A cache of the member's own root: a JAX daemon that loads an
        # executable another JAX daemon of this process saved (the JAX
        # suite's shared cache) may refuse to run it ("Expected ... 8
        # shards").
        exec_cache=True,
    )
    kwargs.update(overrides)
    return JServiceMember(index, root, heartbeat_dir=heartbeat_dir, **kwargs)


def _reply(member, method, path, body):
    status, headers, raw = member.request(method, path, {}, body)
    assert headers == {"Content-Type": "application/json"}
    return status, json.loads(raw.decode("utf-8"))


def _member_script(member, make_spec, encode):
    """One request sequence against a member: each reply as (status, the
    reply's key set, its values but ``detail`` and the bucket labels)."""
    submit = MEMBER_API_PREFIX + "/submit"

    def post(route, payload):
        return "POST", MEMBER_API_PREFIX + route, json.dumps(payload).encode()

    requests = [
        ("POST", submit, b"{not json"),
        ("POST", submit, b"[1, 2]"),
        ("POST", submit, b"\xff\xfe"),
        ("POST", MEMBER_API_PREFIX + "/nope", b"{}"),
        ("POST", "/elsewhere/submit", b"{}"),
        ("GET", submit, None),
        ("DELETE", MEMBER_API_PREFIX + "/capacity", None),
        post("/submit", {"spec": 5}),
        post("/submit", {}),
        post("/submit", {"spec": "bm90IGEgcGlja2xl"}),
        post("/steer", {"tenant_id": "nope", "n_steps": 4}),
        post("/park", {"tenant_id": "nope"}),
        post("/submit", {"spec": encode(make_spec("t0", 0)), "tenant_class": "standard"}),
        post("/submit", {"spec": encode(make_spec("t0", 0))}),  # id collision
        post("/submit", {"spec": encode(make_spec("t1", 0))}),  # uid collision
        post("/submit", {"spec": encode(make_spec("t1", 1)), "journal_extra": {"idem": "k1", "principal": "alice"}}),
        post("/submit", {"spec": encode(make_spec("t2", 2))}),  # past the class budget: shed
        post("/submit", {"spec": encode(make_spec("t3", 3)), "tenant_class": "nope"}),
        post("/steer", {"tenant_id": "t0", "n_steps": 8, "checkpoint_every": 2}),
        post("/steer", {"tenant_id": "t0", "n_steps": -1}),
        post("/park", {"tenant_id": "t1"}),
        post("/park", {"tenant_id": "t1"}),
        ("GET", MEMBER_API_PREFIX + "/capacity", None),
    ]
    out = []
    for method, path, body in requests:
        status, reply = _reply(member, method, path, body)
        values = {k: v for k, v in reply.items() if k not in ("detail", "bucket_lanes", "free_lanes")}
        if "exec_cache" in values:  # counters of each module's shared cache
            values["exec_cache"] = sorted(values["exec_cache"])
        lanes = {k: sorted(reply[k].values()) for k in ("bucket_lanes", "free_lanes") if k in reply}
        out.append((method, path, status, sorted(reply), values, lanes))
    return out


def test_member_request_replies_equal_jax(tmp_path):
    """The member link against the JAX package's member, request for
    request: status codes, error names, reply key sets, and every value but
    the free-text ``detail`` (the free-lane maps by their counts: the
    bucket labels carry each framework's own digests; the program cache's
    counters by their keys: each module shares one cache across its
    tests)."""
    from evox_tpu_torch.service.daemon import _encode_spec as encode

    from evox_tpu.service.daemon import _encode_spec as jencode

    budget = [TenantClass("standard", 2)]
    port = make_member(0, tmp_path / "port", None, classes=budget)
    jax_member = jmake_member(0, tmp_path / "jax", None, classes=[JTenantClass("standard", 2)])
    try:
        port.start()
        jax_member.start()
        got = silent(_member_script, port, pso_spec, encode)
        want = silent(_member_script, jax_member, jtd.pso_spec, jencode)
        assert [g[:4] for g in got] == [w[:4] for w in want]
        assert got == want
        statuses = [g[2] for g in got]
        assert 429 in statuses and 405 in statuses and statuses.count(409) >= 2
    finally:
        port.close()
        jax_member.close()


def _placement_script(router, members, make_spec, admission_error):
    """Submits of two buckets, a round, an affinity placement, a steer, a
    park, a member marked draining, a refused uid-mismatch and no-members;
    returns (placements, refusals)."""
    refusals = []

    def refused(spec, **kw):
        try:
            router.submit(spec, **kw)
        except admission_error as e:
            refusals.append((spec.tenant_id, e.reason, e.retry_after_segments, e.retry_after_seconds is None))
            return
        raise AssertionError(f"{spec.tenant_id} was admitted")

    router.start()
    router.submit(make_spec("a0", 0, n_steps=8), journal_extra={"idem": "ka0", "principal": "alice"})
    router.submit(make_spec("b0", None, n_steps=8, dim=2))
    router.submit(make_spec("a1", None, n_steps=8))
    router.step()
    router.submit(make_spec("a2", None, n_steps=8), tenant_class="standard")
    router.steer("a0", n_steps=12, journal_extra={"idem": "ks0", "principal": "alice"})
    router.park("b0")
    refused(make_spec("a0", 7, n_steps=8))
    members[0].draining = True
    router.submit(make_spec("a3", None, n_steps=8))
    members[1].draining = True
    refused(make_spec("c0", None, n_steps=8))
    placements = {tid: (p["member"], p["uid"], p["confirmed"], p["auto"]) for tid, p in router._placements.items()}
    return placements, refusals


def _journal_view(records):
    """Router-journal records as (kind, data without the spec blob), the
    bucket labels renamed by order of first appearance."""
    labels = {}
    out = []
    for rec in records:
        data = {k: v for k, v in rec.data.items() if k != "spec"}
        if "bucket" in data:
            data["bucket"] = labels.setdefault(data["bucket"], f"bucket{len(labels)}")
        out.append((rec.kind, data, "spec" in rec.data))
    return out


def test_placement_script_equals_jax(tmp_path):
    """One placement script over two members of 4 lanes each, in both
    packages: the same placement map (member, uid, confirmed, auto), the
    same refusal reasons and retry hints, and the same router-journal
    records in order (kinds and fields; spec blobs left out, bucket labels
    compared by the partition they name)."""
    import jax.numpy as jnp

    def port_spec(name, uid, n_steps=12, dim=4):
        return pso_spec(name, uid, n_steps=n_steps) if dim == 4 else _dim_spec(name, uid, n_steps, dim)

    def _dim_spec(name, uid, n_steps, dim):
        from evox_tpu_torch.algorithms import PSO
        from evox_tpu_torch.problems.numerical import Ackley
        from evox_tpu_torch.service import TenantSpec

        algo = PSO(8, torch.full((dim,), -32.0), torch.full((dim,), 32.0), device="cpu")
        return TenantSpec(name, algo, Ackley(), n_steps=n_steps, uid=uid)

    def jax_spec(name, uid, n_steps=12, dim=4):
        from evox_tpu.algorithms import PSO
        from evox_tpu.problems.numerical import Ackley
        from evox_tpu.service import TenantSpec

        return TenantSpec(name, PSO(8, jnp.full((dim,), -32.0), jnp.full((dim,), 32.0)), Ackley(), n_steps=n_steps,
                          uid=uid)

    port_router, port_members = make_fleet(tmp_path / "port")
    jbeats = tmp_path / "jax" / "beats"
    jmembers = [jmake_member(i, tmp_path / "jax" / f"m{i}", jbeats) for i in range(2)]
    jax_router = JTenantRouter(tmp_path / "jax" / "router", jmembers, fleet_dead_after=300.0, fleet_start_grace=0.0)
    try:
        got = silent(_placement_script, port_router, port_members, port_spec, AdmissionError)
        want = silent(_placement_script, jax_router, jmembers, jax_spec, JAdmissionError)
        assert got == want
        assert [r[1] for r in got[1]] == ["uid-mismatch", "no-members"]
        port_records, damage = RequestJournal(port_router.root / TenantRouter.JOURNAL_NAME).replay()
        assert damage is None
        jax_records, jdamage = JRequestJournal(jax_router.root / JTenantRouter.JOURNAL_NAME).replay()
        assert jdamage is None
        assert _journal_view(port_records) == _journal_view(jax_records)
        assert [r.kind for r in port_records] == ["placement"] * 4 + ["steer", "park", "placement"]
    finally:
        port_router.close()
        jax_router.close()
