"""The port's durable serving daemon (``evox_tpu_torch/service/daemon.py``)
on the CPU, at the JAX daemon suite's sizes (``tests/test_daemon.py``:
PSO(8, ±32 in dim 4) on Ackley, 4 lanes, segments of 4).

Against the JAX package (random streams differ between the frameworks, so
what is deterministic): ``fold_daemon_records`` on hypothesis-drawn record
streams (duplicates, orphan steers, parks, completions, a snapshot base)
gives the same state and anomalies; ``kill_points`` is the same for every
plane; and one submission sequence under the same ``TenantClass`` budgets
gives the same accept and shed decisions, ``retry_after_segments`` hints
and brown-out enter and exit rounds.

The port alone: the kill-restart matrix over every ``kill_points("daemon")``
entry (SIGKILL modelled as abandonment: the daemon object is dropped with
no shutdown path running, and a fresh one is built over the same root),
bit-identical to an uninterrupted daemon in final states and checkpoint
leaf digests; restarts after completion and through a damaged journal
tail; evict, forget and steer durable across a kill; preemption; a warm
restart whose every pack program is a cache hit; a corrupt entry captured
anew with identical results; ``withdraw``; the configuration checks; the
compaction decider and a kill at every compaction boundary; and
``fleet_supervisor()`` wired to the daemon root.  On the card,
``chip_smoke.py``'s ``daemon_main_path`` kills a full-width daemon process
and restarts it in another with an empty kernel build directory.
"""

import os
import tempfile
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Ackley as JAckley  # noqa: E402
from evox_tpu.resilience.testing import KILL_POINTS as JKILL_POINTS  # noqa: E402
from evox_tpu.resilience.testing import kill_points as jkill_points  # noqa: E402
from evox_tpu.service import AdmissionError as JAdmissionError  # noqa: E402
from evox_tpu.service import ServiceDaemon as JServiceDaemon  # noqa: E402
from evox_tpu.service import TenantClass as JTenantClass  # noqa: E402
from evox_tpu.service import TenantSpec as JTenantSpec  # noqa: E402
from evox_tpu.service.daemon import fold_daemon_records as jfold_daemon_records  # noqa: E402
from evox_tpu.service.journal import JournalRecord as JJournalRecord  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore, Preempted, PreemptionGuard  # noqa: E402
from evox_tpu_torch.resilience.testing import (  # noqa: E402
    KILL_POINTS,
    assert_states_equal,
    kill_points,
    last_checkpoint_digests,
    run_silently,
    silent,
    verify_tenants_bit_identical,
)
from evox_tpu_torch.service import (  # noqa: E402
    STEER_KNOBS,
    AdmissionError,
    DaemonStats,
    JournalError,
    RequestJournal,
    ServiceDaemon,
    TenantClass,
    TenantSpec,
    TenantStatus,
    retry_after_seconds,
)
from evox_tpu_torch.service.daemon import _decode_spec, _encode_spec, fold_daemon_records  # noqa: E402
from evox_tpu_torch.service.journal import JournalRecord  # noqa: E402
from evox_tpu_torch.utils import ExecutableCache  # noqa: E402
from evox_tpu_torch.utils.checkpoint import CheckpointStore  # noqa: E402

DIM = 4
POP = 8
N_TENANTS = 3


def pso_spec(name, uid, n_steps=12):
    algo = PSO(POP, torch.full((DIM,), -32.0), torch.full((DIM,), 32.0), device="cpu")
    return TenantSpec(name, algo, Ackley(), n_steps=n_steps, uid=uid)


# One program cache shared by every daemon of this module, as the JAX
# suite shares its executable cache: the cross-instance path runs all the
# time.  Tests probing the cache itself pass ``exec_cache=True`` (a private
# root-local cache) or ``None`` (no persistence).
_SHARED: dict = {}


def shared_cache():
    if "cache" not in _SHARED:
        _SHARED["cache"] = ExecutableCache(os.path.join(tempfile.mkdtemp(prefix="evox_torch_daemon_"), "exec"))
    return _SHARED["cache"]


def make_daemon(root, **overrides):
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
    if kwargs["exec_cache"] is True:
        del kwargs["exec_cache"]  # ServiceDaemon default: root-local cache
    return ServiceDaemon(root, **kwargs)


def _reference_results(n_steps=12):
    """An uninterrupted daemon's final states and newest checkpoint digests
    of tenants ``t0..t2`` (computed once a budget, in a temp root)."""
    key = ("ref", n_steps)
    if key not in _SHARED:
        root = os.path.join(tempfile.mkdtemp(prefix="evox_torch_daemon_ref_"), "ref")
        ref = make_daemon(root)
        ref.start()
        for i in range(N_TENANTS):
            ref.submit(pso_spec(f"t{i}", i, n_steps=n_steps))
        run_silently(ref)
        _SHARED[key] = (
            {f"t{i}": ref.result(f"t{i}") for i in range(N_TENANTS)},
            {f"t{i}": last_checkpoint_digests(root, f"t{i}") for i in range(N_TENANTS)},
        )
    return _SHARED[key]


class FlakyAppends(CheckpointStore):
    """A store whose next journal append fails once, on request."""

    fail_next = False

    def append_record(self, f, data):
        if FlakyAppends.fail_next:
            FlakyAppends.fail_next = False
            raise OSError(28, "No space left on device (injected)")
        return super().append_record(f, data)


# -- against the JAX package ------------------------------------------------

KINDS = ("submit", "evict", "retire", "complete", "steer", "preempt", "decision")


@st.composite
def record_streams(draw):
    """A record stream as a journal could hold it: any order of kinds over
    a few uids (so duplicates, orphan steers, parks after completions),
    steer knobs, gateway idempotency fields, and uid-less records."""
    out = []
    for seq in range(draw(st.integers(0, 24))):
        kind = draw(st.sampled_from(KINDS))
        data = {}
        if kind not in ("preempt", "decision"):
            data["uid"] = draw(st.integers(0, 4))
            data["tenant_id"] = f"t{data['uid']}"
        if kind == "submit":
            data.update({"spec": draw(st.sampled_from(["AAA=", "BBB="])), "class": "standard",
                         "n_steps": draw(st.integers(1, 50))})
        if kind == "steer":
            for knob in STEER_KNOBS:
                if draw(st.booleans()):
                    data[knob] = draw(st.integers(0, 100))
        if draw(st.integers(0, 3)) == 0:
            data.update(idem=draw(st.sampled_from(["k1", "k2"])), principal="alice")
        out.append((seq, kind, data))
    return out


def _records(cls, stream):
    return [cls(seq=seq, kind=kind, at=0.0, data=dict(data)) for seq, kind, data in stream]


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(stream=record_streams(), split=st.integers(0, 24))
def test_fold_daemon_records_equals_jax(stream, split):
    """The pure fold of replay and compaction: the same state and anomalies
    as the JAX package's on the same records, with and without a snapshot
    base folded from a prefix (and the base + suffix fold equals the whole
    fold: the replay-equivalence invariant)."""
    got = fold_daemon_records(_records(JournalRecord, stream))
    want = jfold_daemon_records(_records(JJournalRecord, stream))
    assert got == want
    split = min(split, len(stream))
    base, _ = fold_daemon_records(_records(JournalRecord, stream[:split]))
    jbase, _ = jfold_daemon_records(_records(JJournalRecord, stream[:split]))
    assert base == jbase
    suffix = fold_daemon_records(_records(JournalRecord, stream[split:]), base=base)
    assert suffix == jfold_daemon_records(_records(JJournalRecord, stream[split:]), base=jbase)
    assert suffix[0] == got[0]


@pytest.mark.parametrize("plane", sorted(JKILL_POINTS) + ["nonsense"])
def test_kill_points_equal_jax(plane):
    if plane not in JKILL_POINTS:
        with pytest.raises(ValueError, match="unknown plane"):
            kill_points(plane)
        with pytest.raises(ValueError, match="unknown plane"):
            jkill_points(plane)
        return
    assert kill_points(plane) == jkill_points(plane) == JKILL_POINTS[plane]
    assert set(KILL_POINTS) == set(JKILL_POINTS)


def _admission_script(daemon, spec, admission_error):
    """One submission sequence against a daemon with classes standard (3)
    and batch (1), 2 lanes, max_queue 6, brown-out at 0.5 x 2; returns the
    log of decisions and rounds."""
    log = []

    def submit(name, uid, n_steps, cls="standard"):
        try:
            silent(daemon.submit, spec(name, uid, n_steps), tenant_class=cls)
            log.append(("ok", name))
        except admission_error as e:
            log.append((e.reason, name, e.retry_after_segments))

    def round_():
        progressed = silent(daemon.step)
        log.append(("round", progressed, daemon.brownout, daemon.service.segment_steps,
                    len(daemon.service._queue), daemon.stats.brownout_entries, daemon.stats.brownout_exits,
                    daemon.stats.sheds, daemon.service.stats.completed))
        return progressed

    daemon.start()
    for i, n in enumerate((8, 16, 8, 8, 8)):
        submit(f"s{i}", i, n)
    submit("b0", 5, 8, "batch")
    submit("b1", 6, 8, "batch")
    submit("x0", 7, 8, "gold")
    submit("s0", 0, 8)  # a live id: a collision, never a shed
    round_()
    submit("s5", 8, 24)
    submit("b2", 9, 8, "batch")
    submit("s6", 10, 8)
    round_()
    submit("s7", 11, 4)
    for _ in range(40):
        if not round_():
            break
    return log


def test_admission_decisions_equal_jax(tmp_path):
    """The same submissions under the same class budgets: the same accepts,
    sheds (with their ``retry_after_segments``), unknown-class and
    collision refusals, and the same brown-out enter and exit rounds."""
    kw = dict(lanes_per_pack=2, segment_steps=4, max_queue=6, seed=0, preemption=False,
              brownout_threshold=0.5, brownout_factor=2, exec_cache=None)
    jlb, jub = jnp.full((DIM,), -32.0), jnp.full((DIM,), 32.0)
    want = _admission_script(
        JServiceDaemon(tmp_path / "jax", classes=[JTenantClass("standard", 3), JTenantClass("batch", 1)], **kw),
        lambda name, uid, n: JTenantSpec(name, JPSO(POP, jlb, jub), JAckley(), n_steps=n, uid=uid),
        JAdmissionError,
    )
    got = _admission_script(
        ServiceDaemon(tmp_path / "torch", classes=[TenantClass("standard", 3), TenantClass("batch", 1)],
                      device="cpu", **kw),
        pso_spec,
        AdmissionError,
    )
    assert got == want
    reasons = {entry[0] for entry in got}
    assert {"ok", "shed", "unknown-class", "id-collision", "round"} <= reasons
    rounds = [entry for entry in got if entry[0] == "round"]
    assert rounds[0][2] and rounds[-1][5] == 1 and rounds[-1][6] == 1  # entered, then exited once


# -- admission: retry-after, shed, classes, brown-out -----------------------


def test_queue_full_rejection_carries_retry_after_hint(tmp_path):
    daemon = make_daemon(tmp_path / "svc", max_queue=1, classes=[TenantClass("standard", 99, sheddable=False)])
    daemon.start()
    daemon.submit(pso_spec("a", 0))
    with pytest.raises(AdmissionError) as exc_info:
        silent(daemon.submit, pso_spec("b", 1))
    err = exc_info.value
    assert err.reason == "queue-full" and isinstance(err.retry_after_segments, int)
    assert err.retry_after_segments >= 1
    rej = daemon.service.stats.rejections[-1]
    assert rej == ("b", "queue-full") and rej.retry_after_segments == err.retry_after_segments


def test_class_budget_shed_with_structured_retry_after(tmp_path):
    daemon = make_daemon(tmp_path / "svc", lanes_per_pack=2, classes=[TenantClass("standard", 2), TenantClass("batch", 1)])
    daemon.start()
    daemon.submit(pso_spec("s0", 0))
    daemon.submit(pso_spec("s1", 1))
    daemon.submit(pso_spec("b0", 2), tenant_class="batch")
    with pytest.raises(AdmissionError) as exc_info:
        silent(daemon.submit, pso_spec("b1", 3), tenant_class="batch")
    err = exc_info.value
    assert err.reason == "shed" and err.retry_after_segments >= 1
    assert daemon.stats.sheds == 1 and ("b1", "shed") in daemon.service.stats.rejections
    with pytest.raises(AdmissionError, match="shed"):
        silent(daemon.submit, pso_spec("s2", 4))


def test_class_budget_counts_only_that_class(tmp_path):
    daemon = make_daemon(tmp_path / "svc", classes=[TenantClass("standard", 1), TenantClass("bulk", 1)])
    daemon.start()
    daemon.submit(pso_spec("s0", 0))
    daemon.submit(pso_spec("k0", 1), tenant_class="bulk")
    with pytest.raises(AdmissionError, match="shed"):
        silent(daemon.submit, pso_spec("s1", 2))
    assert daemon._statusz()["queue_depth"] == {"bulk": 1, "standard": 1}


def test_unknown_class_rejected(tmp_path):
    daemon = make_daemon(tmp_path / "svc")
    daemon.start()
    with pytest.raises(AdmissionError) as exc_info:
        silent(daemon.submit, pso_spec("a", 0), tenant_class="gold")
    assert exc_info.value.reason == "unknown-class"


def test_journal_failure_unadmits_submission(tmp_path):
    """An acked-but-unjournaled tenant would be lost by a crash: a failed
    append withdraws the submission and tells the caller."""
    store = FaultyStore(enospc_saves=[0])
    daemon = make_daemon(tmp_path / "svc", store=store, exec_cache=None)
    daemon.start()
    with pytest.raises(AdmissionError) as exc_info:
        silent(daemon.submit, pso_spec("a", 0))
    assert exc_info.value.reason == "journal-failed" and exc_info.value.retry_after_segments == 1
    with pytest.raises(KeyError):
        daemon.tenant("a")
    assert daemon.service._queue == []
    assert make_daemon(tmp_path / "svc", exec_cache=None).start() == 0


def test_journal_failure_on_readmission_parks_existing_record(tmp_path):
    daemon = make_daemon(tmp_path / "svc", store=FlakyAppends(), exec_cache=None)
    daemon.start()
    daemon.submit(pso_spec("t", 0, n_steps=20))
    run_silently(daemon, max_rounds=1)
    daemon.evict("t")
    FlakyAppends.fail_next = True
    with pytest.raises(AdmissionError, match="journal-failed"):
        silent(daemon.submit, pso_spec("t", 0, n_steps=20))
    assert daemon.tenant("t").status is TenantStatus.EVICTED
    daemon.submit(pso_spec("t", 0, n_steps=20))
    run_silently(daemon)
    assert daemon.tenant("t").status is TenantStatus.COMPLETED


def test_duplicate_id_rejected_as_collision_not_shed(tmp_path):
    daemon = make_daemon(tmp_path / "svc", classes=[TenantClass("standard", 1)])
    daemon.start()
    daemon.submit(pso_spec("a", 0))
    with pytest.raises(AdmissionError) as exc_info:
        silent(daemon.submit, pso_spec("a", 0))
    assert exc_info.value.reason == "id-collision"


def test_brownout_stretches_cadence_then_recovers(tmp_path):
    """Both cadences are prewarmed at admission: the stretch and its return
    look nothing up and prewarm nothing more."""
    daemon = make_daemon(tmp_path / "svc", lanes_per_pack=2, max_queue=4, brownout_threshold=0.5, brownout_factor=2,
                         classes=[TenantClass("standard", 99)])
    daemon.start()
    for i in range(4):
        daemon.submit(pso_spec(f"t{i}", i, n_steps=8))
    pack = next(iter(daemon.service._buckets.values())).pack
    assert set(pack._from_cache) == {"init", 4, 8}
    looked_up = daemon.exec_cache.stats.hits + daemon.exec_cache.stats.misses
    silent(daemon.step)
    assert daemon.brownout and daemon.service.segment_steps == 8 and daemon.stats.brownout_entries == 1
    run_silently(daemon)
    assert not daemon.brownout and daemon.service.segment_steps == 4 and daemon.stats.brownout_exits == 1
    assert daemon.exec_cache.stats.hits + daemon.exec_cache.stats.misses == looked_up
    assert set(pack._from_cache) == {"init", 4, 8}
    for i in range(4):
        assert daemon.tenant(f"t{i}").status is TenantStatus.COMPLETED


def test_retry_after_seconds_conversion(tmp_path):
    assert retry_after_seconds(3, 2.0) == 6.0 and retry_after_seconds(None, 2.0) is None
    assert retry_after_seconds(3, None) is None and retry_after_seconds(3, 0.0) is None
    daemon = make_daemon(tmp_path / "svc", classes=[TenantClass("standard", 1)])
    daemon.start()
    daemon._last_segment_seconds = 2.5
    daemon.submit(pso_spec("t0", 0))
    with pytest.raises(AdmissionError) as err:
        silent(daemon.submit, pso_spec("t1", 1))
    assert err.value.reason == "shed"
    assert err.value.retry_after_seconds == pytest.approx(err.value.retry_after_segments * 2.5)
    assert daemon.service.stats.rejections[-1].retry_after_seconds == pytest.approx(err.value.retry_after_seconds)
    daemon.close()


# -- kill-at-every-boundary restart matrix (acceptance) ----------------------


@pytest.mark.parametrize("kill_point", kill_points("daemon"))
def test_kill_restart_bit_identical(tmp_path, kill_point):
    """SIGKILL (abandonment — no shutdown code runs) at each lifecycle
    point; the restarted daemon finishes every tenant bit-identical to an
    uninterrupted one, including checkpoint leaf digests."""
    expected, expected_digests = _reference_results()
    root = tmp_path / "killed"
    resubmit_after_restart = []
    if kill_point == "post-submit-pre-journal-ack":
        # The last tenant's journal append dies after the service accepted
        # it: unacked, and the client retries it after the restart.
        daemon = make_daemon(root, store=FaultyStore(enospc_saves=[N_TENANTS - 1]), exec_cache=None)
        daemon.start()
        for i in range(N_TENANTS - 1):
            daemon.submit(pso_spec(f"t{i}", i))
        with pytest.raises(AdmissionError):
            silent(daemon.submit, pso_spec(f"t{N_TENANTS - 1}", N_TENANTS - 1))
        resubmit_after_restart = [N_TENANTS - 1]
    else:
        daemon = make_daemon(root)
        daemon.start()
        for i in range(N_TENANTS):
            daemon.submit(pso_spec(f"t{i}", i))
        rounds = {"post-ack-pre-admit": 0, "mid-run": 1, "post-checkpoint": 2}[kill_point]
        if rounds:
            run_silently(daemon, max_rounds=rounds)
    del daemon  # SIGKILL: nothing else runs

    restarted = make_daemon(root)
    assert silent(restarted.start) == N_TENANTS - len(resubmit_after_restart)
    for i in resubmit_after_restart:
        restarted.submit(pso_spec(f"t{i}", i))
    run_silently(restarted)
    verify_tenants_bit_identical(restarted, root, expected, expected_digests, kill_point)


def test_restart_after_completion_materializes_results_without_lanes(tmp_path):
    expected, _ = _reference_results()
    root = tmp_path / "done"
    daemon = make_daemon(root)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i))
    run_silently(daemon)
    del daemon
    restarted = make_daemon(root)
    restarted.start()
    run_silently(restarted)
    for i in range(N_TENANTS):
        record = restarted.tenant(f"t{i}")
        assert record.status is TenantStatus.COMPLETED and record.lane is None
        assert_states_equal(expected[f"t{i}"], restarted.result(f"t{i}"), f"t{i}")


def test_restart_replays_through_damaged_journal_tail(tmp_path):
    expected, _ = _reference_results()
    root = tmp_path / "torn"
    daemon = make_daemon(root)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i))
    run_silently(daemon, max_rounds=1)
    del daemon
    with open(root / ServiceDaemon.JOURNAL_NAME, "ab") as f:
        f.write(b'{"body":{"seq":99,"kind":"co')
    restarted = make_daemon(root)
    assert silent(restarted.start) == N_TENANTS
    assert len(restarted.stats.journal_damage) == 1
    run_silently(restarted)
    for i in range(N_TENANTS):
        assert_states_equal(expected[f"t{i}"], restarted.result(f"t{i}"), f"t{i}")


def test_evict_is_durable_restart_parks_not_resumes(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("keep", 0, n_steps=20))
    daemon.submit(pso_spec("parked", 1, n_steps=20))
    daemon.submit(pso_spec("queued", 2, n_steps=20))
    run_silently(daemon, max_rounds=1)
    daemon.evict("parked")
    daemon.submit(pso_spec("waiting", 3, n_steps=20))
    assert daemon.park("waiting") == "evicted"  # a queued tenant parks too
    with pytest.raises(RuntimeError, match="holds no lane"):
        daemon.park("waiting")
    del daemon
    restarted = make_daemon(root)
    silent(restarted.start)
    for name in ("parked", "waiting"):
        assert restarted.tenant(name).status is TenantStatus.EVICTED
    run_silently(restarted)
    assert restarted.tenant("keep").status is TenantStatus.COMPLETED
    assert restarted.tenant("parked").status is TenantStatus.EVICTED
    restarted.submit(pso_spec("parked", 1, n_steps=20))
    run_silently(restarted)
    assert restarted.tenant("parked").status is TenantStatus.COMPLETED


def test_forget_is_durable_restart_drops_record(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("a", 0))
    daemon.submit(pso_spec("b", 1))
    run_silently(daemon)
    daemon.forget("a")
    assert not (root / "tenants" / "a").exists()
    del daemon
    restarted = make_daemon(root)
    silent(restarted.start)
    run_silently(restarted)
    with pytest.raises(KeyError):
        restarted.tenant("a")
    assert restarted.tenant("b").status is TenantStatus.COMPLETED


# -- steer: journaled knob adjustments under replay chaos --------------------


def test_steer_is_durable_kill_restart_bit_identical(tmp_path):
    ref = make_daemon(tmp_path / "ref")
    ref.start()
    ref.submit(pso_spec("t0", 0, n_steps=8))
    ref.steer("t0", n_steps=16, checkpoint_every=2)
    run_silently(ref)
    expected = ref.result("t0")
    _, expected_digests = last_checkpoint_digests(tmp_path / "ref", "t0")
    ref.close()

    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t0", 0, n_steps=8))
    run_silently(daemon, max_rounds=1)
    daemon.steer("t0", n_steps=16, checkpoint_every=2)
    del daemon  # SIGKILL: ack journaled, knobs never applied

    restarted = make_daemon(root)
    assert silent(restarted.start) == 1
    assert restarted.tenant("t0").spec.n_steps == 16 and restarted.tenant("t0").steer["checkpoint_every"] == 2
    run_silently(restarted)
    record = restarted.tenant("t0")
    assert record.status is TenantStatus.COMPLETED and record.generations >= 16
    assert_states_equal(expected, restarted.result("t0"), "steered")
    assert last_checkpoint_digests(root, "t0")[1] == expected_digests
    restarted.close()


def test_steer_torn_journal_tail_quarantined_keeps_acked_steer(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t0", 0, n_steps=8))
    daemon.steer("t0", n_steps=16)
    del daemon
    with open(root / ServiceDaemon.JOURNAL_NAME, "ab") as f:
        f.write(b'{"body":{"seq":99,"kind":"ste')
    restarted = make_daemon(root)
    assert silent(restarted.start) == 1
    assert len(restarted.stats.journal_damage) == 1 and restarted.tenant("t0").spec.n_steps == 16
    run_silently(restarted)
    assert restarted.tenant("t0").generations >= 16
    restarted.close()


def test_steer_duplicate_records_collapse_last_knob_wins(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t0", 0, n_steps=8))
    daemon.steer("t0", n_steps=16, max_restarts=5)
    daemon.journal.append("steer", tenant_id="t0", uid=0, n_steps=16)
    daemon.journal.append("steer", tenant_id="t0", uid=0, n_steps=12)
    del daemon
    restarted = make_daemon(root)
    assert silent(restarted.start) == 1
    record = restarted.tenant("t0")
    assert record.spec.n_steps == 12 and record.steer["max_restarts"] == 5
    restarted.close()


def test_steer_before_submit_skipped_loudly_on_replay(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t0", 0, n_steps=8))
    daemon.journal.append("steer", tenant_id="ghost", uid=7, n_steps=16)
    del daemon
    restarted = make_daemon(root)
    with pytest.warns(UserWarning, match="no live submit"):
        assert restarted.start() == 1
    assert restarted.tenant("t0").spec.n_steps == 8
    with pytest.raises(KeyError):
        restarted.tenant("ghost")
    restarted.close()


def test_steer_validates_before_journaling(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t0", 0, n_steps=8))
    with pytest.raises(ValueError, match="n_steps"):
        daemon.steer("t0", n_steps=0)
    with pytest.raises(ValueError, match="adjusts nothing"):
        daemon.steer("t0")
    with pytest.raises(KeyError):
        daemon.steer("nope", n_steps=16)
    run_silently(daemon)
    with pytest.raises(RuntimeError, match="completed"):
        daemon.steer("t0", n_steps=4)
    records, _ = RequestJournal(root / ServiceDaemon.JOURNAL_NAME).replay()
    assert [r.kind for r in records if r.kind == "steer"] == []
    daemon.close()


# -- preemption and journal chaos ---------------------------------------------


def test_preempted_daemon_journals_and_restart_resumes(tmp_path):
    expected, _ = _reference_results(n_steps=16)
    root = tmp_path / "svc"
    guard = PreemptionGuard()
    daemon = make_daemon(root, preemption=guard)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i, n_steps=16))
    run_silently(daemon, max_rounds=1)
    guard.trip("maintenance")
    with pytest.raises(Preempted):
        run_silently(daemon)
    records, _ = RequestJournal(root / ServiceDaemon.JOURNAL_NAME).replay()
    assert any(r.kind == "preempt" for r in records)
    del daemon
    restarted = make_daemon(root, preemption=False)
    assert silent(restarted.start) == N_TENANTS
    run_silently(restarted)
    for i in range(N_TENANTS):
        got = restarted.result(f"t{i}")
        want = expected[f"t{i}"]
        assert int(got.monitor.num_preemptions) == 1
        # Bit-identical minus the preemption counter the emergency
        # checkpoint bumped into the saved state.
        got = got.replace(monitor=got.monitor.replace(num_preemptions=want.monitor.num_preemptions))
        assert_states_equal(want, got, f"t{i}")


def test_daemon_survives_torn_journal_record_chaos(tmp_path):
    expected, _ = _reference_results()
    root = tmp_path / "svc"
    daemon = make_daemon(root, store=FaultyStore(torn_saves=[1]), exec_cache=None)
    daemon.start()
    daemon.submit(pso_spec("t0", 0))
    with pytest.raises(AdmissionError):
        silent(daemon.submit, pso_spec("t1", 1))
    daemon.submit(pso_spec("t2", 2))
    del daemon
    restarted = make_daemon(root)
    assert silent(restarted.start) == 2
    restarted.submit(pso_spec("t1", 1))
    run_silently(restarted)
    for i in range(N_TENANTS):
        assert_states_equal(expected[f"t{i}"], restarted.result(f"t{i}"), f"t{i}")


def test_evict_and_forget_journal_before_mutating(tmp_path):
    daemon = make_daemon(tmp_path / "svc", store=FlakyAppends(), exec_cache=None)
    daemon.start()
    daemon.submit(pso_spec("t", 0, n_steps=20))
    run_silently(daemon, max_rounds=1)
    FlakyAppends.fail_next = True
    with pytest.raises(JournalError):
        silent(daemon.evict, "t")
    assert daemon.tenant("t").status is TenantStatus.RUNNING
    daemon.evict("t")
    assert daemon.tenant("t").status is TenantStatus.EVICTED
    FlakyAppends.fail_next = True
    with pytest.raises(JournalError):
        silent(daemon.forget, "t")
    assert daemon.tenant("t").status is TenantStatus.EVICTED
    daemon.forget("t")
    with pytest.raises(KeyError):
        daemon.tenant("t")
    daemon.submit(pso_spec("queued", 1, n_steps=20))
    before = daemon.journal.next_seq
    with pytest.raises(RuntimeError, match="no lane"):
        daemon.evict("queued")
    with pytest.raises(RuntimeError, match="evict it"):
        daemon.forget("queued")
    assert daemon.journal.next_seq == before


# -- the persistent program cache ----------------------------------------------


def test_warm_restart_loads_every_pack_program_from_cache(tmp_path):
    root = tmp_path / "svc"
    daemon = make_daemon(root, exec_cache=True)
    daemon.start()
    for i in range(2):
        daemon.submit(pso_spec(f"t{i}", i, n_steps=16))
    run_silently(daemon, max_rounds=1)
    cold = daemon.exec_cache.stats
    assert cold.saves >= 2 and cold.hits == 0
    assert not any(daemon.stats.prewarmed.values())
    del daemon

    restarted = make_daemon(root, exec_cache=True)
    silent(restarted.start)
    stats = restarted.exec_cache.stats
    assert stats.misses == 0 and stats.hits == len(restarted.stats.prewarmed) >= 2
    assert all(restarted.stats.prewarmed.values())
    status = restarted._statusz()["exec_cache"]
    assert status["hits"] == stats.hits and status["hit_rate"] == 1.0 and status["quarantines"] == 0
    # On the CPU nothing is captured; the counts stand beside the hits.
    assert status["captures"] == restarted.stats.captures == {"init": 0, "segment": 0}
    assert set(status["kernel_builds"]) == {"builds", "installs"}
    run_silently(restarted)
    for i in range(2):
        assert restarted.tenant(f"t{i}").status is TenantStatus.COMPLETED


def test_corrupt_exec_cache_entry_recompiles_with_identical_results(tmp_path):
    expected, _ = _reference_results()
    root = tmp_path / "svc"
    daemon = make_daemon(root, exec_cache=True)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i))
    run_silently(daemon, max_rounds=1)
    del daemon
    exec_dir = root / ServiceDaemon.EXEC_CACHE_DIR
    entries = list(exec_dir.glob("exe_*"))
    assert entries
    for entry in entries:
        blob = bytearray(entry.read_bytes())
        blob[-30] ^= 0x01
        entry.write_bytes(bytes(blob))
    restarted = make_daemon(root, exec_cache=True)
    silent(restarted.start)
    assert restarted.exec_cache.stats.quarantines == len(entries)
    assert all("digest mismatch" in why for _, why in restarted.exec_cache.stats.quarantined)
    assert list(exec_dir.glob("*.corrupt*")) and restarted.exec_cache.stats.saves == len(entries)
    run_silently(restarted)
    for i in range(N_TENANTS):
        assert_states_equal(expected[f"t{i}"], restarted.result(f"t{i}"), f"t{i}")


@pytest.mark.slow
def test_kill_restart_64_tenants_acceptance(tmp_path):
    """64 packed tenants, killed mid-run, restart from journal + namespaces
    + program cache bit-identical to an uninterrupted daemon."""
    n = 64
    cache = ExecutableCache(tmp_path / "shared_exec")

    def build(root):
        return make_daemon(root, lanes_per_pack=n, max_queue=n, exec_cache=cache)

    ref = build(tmp_path / "ref")
    ref.start()
    for i in range(n):
        ref.submit(pso_spec(f"t{i:03d}", i, n_steps=8))
    run_silently(ref)
    expected = {f"t{i:03d}": ref.result(f"t{i:03d}") for i in range(n)}
    digests = {f"t{i:03d}": last_checkpoint_digests(tmp_path / "ref", f"t{i:03d}") for i in range(n)}
    root = tmp_path / "killed"
    daemon = build(root)
    daemon.start()
    for i in range(n):
        daemon.submit(pso_spec(f"t{i:03d}", i, n_steps=8))
    run_silently(daemon, max_rounds=1)
    del daemon
    restarted = build(root)
    assert silent(restarted.start) == n
    assert all(restarted.stats.prewarmed.values())
    run_silently(restarted)
    verify_tenants_bit_identical(restarted, root, expected, digests, "64 tenants")


# -- spec encoding, endpoint providers, fleet ---------------------------------


def test_decoded_spec_is_rebuilt_on_the_daemons_device():
    """The journaled spec records the device it was submitted on; the
    decode puts every tensor and ``torch.device`` on the daemon's."""
    spec = pso_spec("a", 0)
    blob = _encode_spec(spec)
    same = _decode_spec(blob, torch.device("cpu"))
    assert same.algorithm.device == torch.device("cpu") and torch.equal(same.algorithm.lb, spec.algorithm.lb)
    assert (same.tenant_id, same.uid, same.n_steps) == ("a", 0, 12)
    moved = _decode_spec(blob, torch.device("meta"))
    assert moved.algorithm.device == torch.device("meta")
    assert moved.algorithm.lb.device.type == "meta" and moved.algorithm.ub.device.type == "meta"


def test_statusz_healthz_and_metrics_providers(tmp_path):
    daemon = make_daemon(tmp_path / "svc", classes=[TenantClass("standard", 4), TenantClass("batch", 2)],
                         obs=None, compact_records=1000)
    daemon.start()
    daemon.submit(pso_spec("a", 0, n_steps=8))
    daemon.submit(pso_spec("b", 1, n_steps=8), tenant_class="batch")
    run_silently(daemon)
    status = daemon._statusz()
    assert status["tenant_counts"] == {"completed": 2}
    assert status["tenants"]["b"]["class"] == "batch" and status["queue_budget"] == {"batch": 2, "standard": 4}
    assert status["journal"]["armed"] is True and status["journal"]["records_since_snapshot"] >= 4
    assert status["exec_cache"]["misses"] + status["exec_cache"]["hits"] >= 2
    healthy, payload = daemon._healthz()
    assert healthy and payload["started"] and payload["tenants"] == 2
    text = daemon._metrics_text()
    for name in ("evox_daemon_journal_records_total", "evox_daemon_round_seconds", "evox_journal_records"):
        assert name in text, name
    assert isinstance(daemon.stats, DaemonStats) and daemon._flight_window("nope") is None
    daemon.close()


def test_fleet_supervisor_wired_to_daemon_root(tmp_path):
    """``fleet_supervisor`` builds a supervisor whose workers share the
    daemon's root; a relaunch after a host death completes on the
    survivors (scripted workers); with ``xla_cache`` the workers' env names
    the daemon's bytecode cache."""
    root = tmp_path / "svc"
    daemon = make_daemon(root)
    daemon.start()
    daemon.submit(pso_spec("t", 0))
    run_silently(daemon)
    daemon.close()

    class FakeWorker:
        pid = 4242

        def __init__(self, rc=None):
            self.rc = rc

        def poll(self):
            return self.rc

        def terminate(self):
            if self.rc is None:
                self.rc = -15

        def kill(self):
            if self.rc is None:
                self.rc = -9

        def wait(self, timeout=None):
            return self.rc

    script = {(0, 1): 1, (0, 0): None}  # attempt 0: worker 1 dies

    def spawn(argv, env, spec):
        return FakeWorker(rc=script.get((spec.attempt, spec.process_id), 0))

    sup = daemon.fleet_supervisor(lambda spec: ["daemon-worker"], 2, spawn=spawn, poll_interval=0.01,
                                  grace_seconds=0.05, start_grace=1000.0)
    assert sup.checkpoint_dir == root and sup.heartbeat_dir == root / "heartbeats"
    stats = silent(sup.run)
    assert stats.completed and stats.world_sizes == [2, 1] and stats.host_deaths == 1
    import sys

    prefix = sys.pycache_prefix
    try:
        warm = make_daemon(tmp_path / "warm", xla_cache=True)
        assert warm.xla_cache_enabled
        env = warm.fleet_supervisor(lambda spec: ["w"], 1, spawn=spawn).env
        assert env["PYTHONPYCACHEPREFIX"] == str((tmp_path / "warm" / ServiceDaemon.XLA_CACHE_DIR).resolve())
        assert "PYTHONDONTWRITEBYTECODE" not in env
    finally:
        sys.pycache_prefix = prefix


# -- misc ----------------------------------------------------------------------


def test_withdraw_requires_queued(tmp_path):
    daemon = make_daemon(tmp_path / "svc")
    daemon.start()
    daemon.submit(pso_spec("a", 0))
    daemon.submit(pso_spec("p", 1))
    daemon.submit(pso_spec("d", 2))
    daemon.service.withdraw("p", to_status=TenantStatus.EVICTED)
    assert daemon.tenant("p").status is TenantStatus.EVICTED and "p" not in daemon.service._queue
    daemon.service.withdraw("d")
    with pytest.raises(KeyError):
        daemon.tenant("d")
    run_silently(daemon)
    with pytest.raises(RuntimeError, match="not QUEUED"):
        daemon.service.withdraw("a")
    with pytest.raises(RuntimeError, match="not QUEUED"):
        daemon.service.withdraw("ghost")


def test_daemon_validates_configuration(tmp_path):
    with pytest.raises(ValueError, match="brownout_factor"):
        ServiceDaemon(tmp_path / "a", brownout_factor=0, device="cpu")
    with pytest.raises(ValueError, match="brownout_threshold"):
        ServiceDaemon(tmp_path / "b", brownout_threshold=1.5, device="cpu")
    with pytest.raises(ValueError, match="queue_budget"):
        TenantClass("x", -1)
    with pytest.raises(ValueError, match="duplicate"):
        ServiceDaemon(tmp_path / "c", classes=[TenantClass("a", 1), TenantClass("a", 2)], device="cpu")
    for name in ("compact_records", "compact_bytes", "max_replay_seconds"):
        with pytest.raises(ValueError, match=name):
            ServiceDaemon(tmp_path / "d", device="cpu", **{name: 0})
    assert ServiceDaemon(tmp_path / "e").device == torch.device("cuda")
    assert ServiceDaemon(tmp_path / "f", compact_records=5, device="cpu").controller is not None


# -- journal compaction through the daemon ------------------------------------


def test_daemon_compaction_decider_fires_and_restart_bit_identical(tmp_path):
    expected, expected_digests = _reference_results()
    root = tmp_path / "compacted"
    daemon = make_daemon(root, compact_records=4)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i))
    for i in range(N_TENANTS):
        daemon.steer(f"t{i}", n_steps=12)  # pure journal growth
    run_silently(daemon)
    assert daemon.stats.compactions >= 1 and daemon.stats.compaction_failures == 0
    strip = daemon._journal_statusz()
    assert strip["armed"] is True and strip["compactions"] == daemon.stats.compactions
    assert strip["snapshot_seq"] == daemon.journal.snapshot_seq is not None
    assert strip["decisions"] and all(m["kind"] == "compact" for m in strip["decisions"])
    del daemon

    restarted = make_daemon(root, compact_records=4)
    assert silent(restarted.start) == N_TENANTS
    assert restarted.journal.snapshot_seq is not None and restarted.journal.snapshot_fallbacks == 0
    assert restarted.stats.replay_seconds is not None
    run_silently(restarted)
    verify_tenants_bit_identical(restarted, root, expected, expected_digests, "compacted")


@pytest.mark.parametrize("boundary", ["mid-snapshot-publish", "post-snapshot-pre-copy", "post-copy-pre-swap",
                                      "post-swap-pre-gc"])
def test_daemon_kill_at_every_compaction_boundary_bit_identical(tmp_path, boundary):
    expected, expected_digests = _reference_results()
    root = tmp_path / "killed"
    daemon = make_daemon(root)
    daemon.start()
    for i in range(N_TENANTS):
        daemon.submit(pso_spec(f"t{i}", i))
    run_silently(daemon, max_rounds=1)
    if boundary == "post-swap-pre-gc":
        silent(daemon._compact_journal)
        assert (daemon.stats.compactions, daemon.stats.compaction_failures) == (1, 0)
    else:
        step = {"mid-snapshot-publish": 0, "post-snapshot-pre-copy": 1, "post-copy-pre-swap": 2}[boundary]
        daemon.journal.store = FaultyStore(crash_saves=[step])
        silent(daemon._compact_journal)
        assert (daemon.stats.compactions, daemon.stats.compaction_failures) == (0, 1)
    del daemon
    restarted = make_daemon(root)
    assert silent(restarted.start) == N_TENANTS
    assert (restarted.journal.snapshot_seq is not None) == (boundary == "post-swap-pre-gc")
    run_silently(restarted)
    verify_tenants_bit_identical(restarted, root, expected, expected_digests, boundary)


def test_forget_purges_disk_and_churn_stays_o_live(tmp_path):
    """Churned tenants (submit -> run -> forget) leave disk and journal
    proportional to live tenants: forget reaps the namespace once the
    retire record is durable, and armed compaction folds the churn."""
    root = tmp_path / "svc"
    daemon = make_daemon(root, compact_records=12)
    daemon.start()
    for batch in range(5):
        for k in range(4):
            uid = batch * 4 + k
            daemon.submit(pso_spec(f"churn-{uid}", uid, n_steps=4))
        run_silently(daemon)
        for k in range(4):
            uid = batch * 4 + k
            assert daemon.tenant(f"churn-{uid}").status is TenantStatus.COMPLETED
            daemon.forget(f"churn-{uid}")
    for i in range(2):
        daemon.submit(pso_spec(f"live-{i}", 1000 + i, n_steps=4))
    run_silently(daemon)
    assert sorted(os.listdir(root / "tenants")) == ["live-0", "live-1"]
    # The churn alone journaled 60 tenant records (submit, complete, retire).
    assert daemon.stats.compactions >= 1 and daemon.journal.records_since_snapshot < 60
    records, damage = silent(daemon.journal.replay)
    assert damage is None
    state, _ = fold_daemon_records(records, base=daemon.journal.snapshot_state)
    assert set(state["live"]) == {"1000", "1001"}
    daemon.close()


def test_silent_mutes_warnings():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert silent(lambda: warnings.warn("loud") or 5) == 5
