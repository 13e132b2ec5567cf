"""The port's network front door (``evox_tpu_torch/service/gateway.py``,
``service/client.py``, ``resilience/transport.py``) on the CPU, at the JAX
gateway suite's sizes (``tests/test_gateway.py``: PSO(8, ±32 in dim 4) on
Ackley behind the port's ``test_torch_daemon.make_daemon``).

Every test of ``tests/test_gateway.py`` has its counterpart here under the
same name: bearer auth, the hostile-id 400s, cross-principal isolation,
idempotent replay in process, across a restart and across a journal
compaction, overload as 429/503 with a measured ``Retry-After``,
``FaultyTransport`` wire chaos, the kill-at-every-boundary HTTP matrix
(SIGKILL modelled as abandonment: the endpoint's sockets close, nothing
else runs, and a fresh daemon and gateway are built over the same root),
long-poll result and flight reads, withdraw, steer, the catalog form and
the telemetry surfaces.

Held against the JAX package on the same inputs, every comparison exact
(equality of values, bytes and strings; no tolerance):

(a) ``FaultyTransport`` over a deterministic stub transport under the same
    schedules: events, request counts, returned bodies (torn bytes
    byte-equal), exception types and messages, and the schedule
    validation messages;
(b) ``GatewayClient`` over a scripted stub transport (statuses,
    ``Retry-After`` headers, torn bodies, lost requests) with an injected
    sleeper: the sleep sequence, ``retries``, the returned documents, the
    ``GatewayError`` fields, and the idempotency key on every attempt;
(c) one scripted sequence of raw HTTP requests against a JAX ``Gateway``
    over a JAX daemon and the port's over the port's daemon: status codes,
    ``error`` codes, the presence of ``Retry-After``, the JSON bodies' key
    sets, and ``statusz_payload()`` after the sequence;
(d) the catalog's accepted algorithm and problem kinds.

On the card, ``tests/test_torch_cuda.py`` holds the gateway's card rules
(a submit decoded during a capture, a card tenant's history as JSON, a
CPU-built spec run on the card) and ``chip_smoke.py``'s
``gateway_main_path``, ``gateway_kill_restart`` and ``gateway_overhead``
drive it at full width.
"""

import ast
import io
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_daemon as jtd  # noqa: E402
from evox_tpu.resilience import FaultyTransport as JFaultyTransport  # noqa: E402
from evox_tpu.resilience import TransportError as JTransportError  # noqa: E402
from evox_tpu.service import Gateway as JGateway  # noqa: E402
from evox_tpu.service import GatewayClient as JGatewayClient  # noqa: E402
from evox_tpu.service import GatewayError as JGatewayError  # noqa: E402
from evox_tpu.service import TenantClass as JTenantClass  # noqa: E402
from evox_tpu.service.client import encode_spec as jencode_spec  # noqa: E402
from test_torch_daemon import make_daemon, pso_spec  # noqa: E402

import evox_tpu_torch  # noqa: E402
from evox_tpu_torch.obs import FlightRecorder, MetricsRegistry, Observability  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore, FaultyTransport, TransportError  # noqa: E402
from evox_tpu_torch.resilience.testing import (  # noqa: E402
    assert_states_equal,
    kill_points,
    last_checkpoint_digests,
    npify,
    run_silently,
    silent,
)
from evox_tpu_torch.service import (  # noqa: E402
    Gateway,
    GatewayClient,
    GatewayError,
    HttpTransport,
    TenantClass,
    TenantStatus,
    encode_spec,
)
from evox_tpu_torch.service import gateway as gateway_module  # noqa: E402

TOKENS = {"tok-alice": "alice", "tok-bob": "bob"}
N = 2  # tenants in the kill matrix


def gw_daemon(root, **overrides):
    daemon = make_daemon(root, **overrides)
    gateway = Gateway(daemon, tokens=TOKENS)
    return daemon, gateway


def kill(daemon):
    """SIGKILL model: the OS tears down the process's sockets (endpoint
    listener included) but no daemon shutdown logic runs — the journal is
    left unclosed, nothing flushes."""
    daemon.endpoint.stop()


def client_for(daemon, token="tok-alice", **kwargs):
    kwargs.setdefault("backoff", 0.01)
    kwargs.setdefault("retry_after_cap", 0.05)
    return GatewayClient(daemon.endpoint.url, token, **kwargs)


def qualified(tenant_id, principal="alice"):
    return f"{principal}--{tenant_id}"


CATALOG = {
    "tenant_id": "curl0",
    "n_steps": 8,
    "algorithm": {"kind": "PSO", "pop_size": 8, "dim": 4, "lb": -32.0, "ub": 32.0},
    "problem": {"kind": "Ackley"},
}


# -- auth + path safety ------------------------------------------------------


def test_missing_and_unknown_tokens_rejected_and_counted(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        # No Authorization header at all (raw urllib, no client sugar).
        request = urllib.request.Request(f"{daemon.endpoint.url}/api/v1/tenants", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(request)
        assert err.value.code == 401
        with pytest.raises(GatewayError) as err2:
            client_for(daemon, token="tok-wrong").status("t0")
        assert err2.value.status == 401
        assert err2.value.error == "unauthenticated"
        section = gateway.statusz_payload()
        assert section["auth_rejects"] == 2
    finally:
        daemon.close()


@pytest.mark.parametrize("hostile", ["..", ".", "../evil", "a/b", "a\\b", "", "x" * 200, "a b", "%2e%2e"])
def test_hostile_tenant_ids_structured_400(tmp_path, hostile):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        with pytest.raises(GatewayError) as err:
            client.submit(catalog=dict(CATALOG, tenant_id=hostile, n_steps=4))
        assert err.value.status == 400
        assert err.value.error in ("bad-tenant-id", "bad-spec")
        # Nothing hostile became a directory component.
        tenants_dir = tmp_path / "svc" / "tenants"
        assert not tenants_dir.is_dir() or list(tenants_dir.iterdir()) == []
    finally:
        daemon.close()


def test_path_traversal_ids_rejected_on_read_routes(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        for route in ("status", "result", "flight", "withdraw"):
            with pytest.raises(GatewayError) as err:
                getattr(client, route)("../../etc")
            assert err.value.status == 400, route
            assert err.value.error == "bad-tenant-id", route
    finally:
        daemon.close()


def test_cross_principal_isolation(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        alice = client_for(daemon)
        bob = client_for(daemon, token="tok-bob")
        alice.submit(pso_spec("t0", 0, n_steps=4))
        # Bob can neither see alice's tenant nor collide with its id.
        with pytest.raises(GatewayError) as err:
            bob.status("t0")
        assert err.value.status == 404
        ack = bob.submit(pso_spec("t0", 1, n_steps=4))
        assert ack["uid"] == 1
        assert set(daemon.service._tenants) == {"alice--t0", "bob--t0"}
        section = gateway.statusz_payload()
        assert section["principals"] == {"alice": 1, "bob": 1}
    finally:
        daemon.close()


# -- idempotency -------------------------------------------------------------


def test_submit_requires_idempotency_key(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        status, _headers, body = HttpTransport("127.0.0.1", daemon.endpoint.port).request(
            "POST", "/api/v1/tenants", {"Authorization": "Bearer tok-alice"}, b"{}"
        )
        assert status == 400
        assert json.loads(body)["error"] == "missing-idempotency-key"
    finally:
        daemon.close()


def test_idempotent_submit_in_process_and_across_restart(tmp_path):
    root = tmp_path / "svc"
    daemon, gateway = gw_daemon(root)
    gateway.start()
    client = client_for(daemon)
    key = client.new_idem_key()
    spec = pso_spec("t0", 0, n_steps=8)
    first = client.submit(spec, idem_key=key)
    assert first["uid"] == 0 and "idempotent_replay" not in first
    again = client.submit(spec, idem_key=key)
    assert again["idempotent_replay"] is True and again["uid"] == 0
    # A different key for the same live id is a truthful 409, never a
    # second admission masked as a replay.
    with pytest.raises(GatewayError) as err:
        silent(client.submit, spec)
    assert err.value.status == 409
    assert len(daemon.service._tenants) == 1
    kill(daemon)
    del gateway, daemon

    daemon, gateway = gw_daemon(root)
    silent(gateway.start)
    try:
        replay = client_for(daemon).submit(spec, idem_key=key)
        assert replay["idempotent_replay"] is True and replay["uid"] == 0
        assert len(daemon.service._tenants) == 1
        assert gateway.statusz_payload()["idem_replays"] == 1
    finally:
        daemon.close()


def test_idempotent_resubmit_straddles_journal_compaction(tmp_path):
    """A gateway-retried submit whose first attempt predates a journal
    compaction must still replay the ack: the idempotency map is folded
    into the snapshot and ``_rebuild_idem`` recovers it from there."""
    from evox_tpu_torch.service import RequestJournal, ServiceDaemon

    root = tmp_path / "svc"
    daemon, gateway = gw_daemon(root)
    gateway.start()
    client = client_for(daemon)
    key = client.new_idem_key()
    spec = pso_spec("t0", 0, n_steps=8)
    first = client.submit(spec, idem_key=key)
    assert first["uid"] == 0
    run_silently(daemon)
    # Boundary-time compaction folds the submit record — and its
    # idempotency key — into the snapshot.
    silent(daemon._compact_journal)
    assert daemon.stats.compactions == 1
    kill(daemon)
    del gateway, daemon  # SIGKILL straddling the retry

    daemon, gateway = gw_daemon(root)
    silent(gateway.start)
    try:
        assert daemon.journal.snapshot_seq is not None
        replay = client_for(daemon).submit(spec, idem_key=key)
        assert replay["idempotent_replay"] is True and replay["uid"] == 0
        assert len(daemon.service._tenants) == 1
        assert gateway.statusz_payload()["idem_replays"] == 1
        # Exactly one admission across the whole history: the submit
        # lives in the snapshot, the suffix journal holds no second one.
        journal = RequestJournal(root / ServiceDaemon.JOURNAL_NAME)
        records, damage = silent(journal.replay)
        assert damage is None
        assert [r for r in records if r.kind == "submit"] == []
        assert (journal.snapshot_state or {}).get("idem"), "idempotency map missing from the snapshot"
    finally:
        daemon.close()


# -- overload → HTTP ---------------------------------------------------------


def test_shed_maps_to_429_with_measured_cadence_retry_after(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc", classes=[TenantClass("standard", 2)])
    gateway.start()
    try:
        daemon._last_segment_seconds = 2.0  # injected measured cadence
        client = client_for(daemon, max_retries=0)
        for i in range(2):
            client.submit(pso_spec(f"t{i}", i, n_steps=8))
        with pytest.raises(GatewayError) as err:
            silent(client.submit, pso_spec("t2", 2, n_steps=8))
        assert err.value.status == 429
        assert err.value.error == "shed"
        # Retry-After is wall-clock from the measured cadence: the hint
        # is >= 1 segment at 2 s/segment.
        assert err.value.retry_after is not None
        assert err.value.retry_after >= 2.0
        assert gateway.statusz_payload()["retry_after_sent"] == 1
    finally:
        daemon.close()


def test_queue_full_maps_to_503_with_retry_after(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc", max_queue=1, classes=[TenantClass("standard", 99, sheddable=False)])
    gateway.start()
    try:
        daemon._last_segment_seconds = 0.5
        client = client_for(daemon, max_retries=0)
        client.submit(pso_spec("t0", 0, n_steps=8))
        with pytest.raises(GatewayError) as err:
            silent(client.submit, pso_spec("t1", 1, n_steps=8))
        assert err.value.status == 503
        assert err.value.error == "queue-full"
        assert err.value.retry_after is not None and err.value.retry_after >= 1
    finally:
        daemon.close()


def test_client_retries_429_until_capacity_frees(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc", classes=[TenantClass("standard", 1)])
    gateway.start()
    try:
        fail_fast = client_for(daemon, max_retries=0)
        fail_fast.submit(pso_spec("t0", 0, n_steps=8))
        spec = pso_spec("t1", 1, n_steps=8)
        # Overloaded now: a no-retry client gets the truthful 429 ...
        with pytest.raises(GatewayError) as err:
            silent(fail_fast.submit, spec, idem_key="retry-me")
        assert err.value.status == 429
        # ... and a retrying client with the SAME key lands the submit by
        # itself once a pump thread drains capacity.
        pump = threading.Thread(target=lambda: silent(gateway.pump))
        pump.start()
        ack = client_for(daemon, max_retries=30).submit(spec, idem_key="retry-me")
        pump.join(timeout=60)
        assert ack["uid"] == 1
        silent(gateway.pump)
        assert daemon.tenant(qualified("t1")).status is TenantStatus.COMPLETED
    finally:
        daemon.close()


# -- wire chaos --------------------------------------------------------------


def test_faulty_transport_never_double_admits_or_loses_ack(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        faulty = FaultyTransport(
            HttpTransport("127.0.0.1", daemon.endpoint.port),
            drop_requests=[0],
            drop_replies=[1],
            torn_replies=[2],
            duplicate_requests=[3],
        )
        client = GatewayClient(daemon.endpoint.url, "tok-alice", transport=faulty, max_retries=8, backoff=0.01)
        # One logical submit rides: a dropped request, a delivered-but-
        # lost-ack (server admits!), a torn reply, then a duplicated
        # delivery — and still resolves to exactly one admission.
        ack = client.submit(pso_spec("t0", 0, n_steps=8))
        assert ack["uid"] == 0
        assert [kind for _i, kind in faulty.events] == [
            "drop-request",
            "drop-reply",
            "torn-reply",
            "duplicate-request",
        ]
        assert client.retries == 3
        assert list(daemon.service._tenants) == [qualified("t0")]
        # Attempts 1..4 hit the server; only the first admitted, the
        # rest were idempotent replays (the duplicate counts twice).
        assert gateway.statusz_payload()["idem_replays"] == 3
    finally:
        daemon.close()


def test_dropped_reply_on_steer_and_withdraw_is_safe_to_retry(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client_for(daemon).submit(pso_spec("t0", 0, n_steps=8))
        faulty = FaultyTransport(HttpTransport("127.0.0.1", daemon.endpoint.port), drop_replies=[0, 2])
        client = GatewayClient(daemon.endpoint.url, "tok-alice", transport=faulty, max_retries=4, backoff=0.01)
        knobs = client.steer("t0", n_steps=16)
        assert knobs.get("idempotent_replay") is True
        assert knobs["knobs"] == {"n_steps": 16}
        # The steer journaled exactly once despite the lost ack.
        records, _ = daemon.journal.replay()
        steers = [r for r in records if r.kind == "steer"]
        assert len(steers) == 1
        gone = client.withdraw("t0")
        assert gone.get("idempotent_replay") is True
        assert daemon.tenant(qualified("t0")).status is TenantStatus.EVICTED
        records, _ = daemon.journal.replay()
        assert len([r for r in records if r.kind == "evict"]) == 1
    finally:
        daemon.close()


# -- the kill-at-every-boundary HTTP matrix (acceptance) ---------------------


def _reference(tmp_path, n_steps=10):
    """The same specs submitted via the Python API, under the qualified
    ids the gateway will mint — the bit-identity baseline."""
    ref = make_daemon(tmp_path / "ref")
    ref.start()
    for i in range(N):
        ref.submit(pso_spec(qualified(f"t{i}"), i, n_steps=n_steps))
    run_silently(ref)
    results, digests, history = {}, {}, {}
    for i in range(N):
        tid = qualified(f"t{i}")
        results[tid] = ref.result(tid)
        digests[tid] = last_checkpoint_digests(tmp_path / "ref", tid)
        history[tid] = [npify(row) for row in ref.tenant(tid).monitor.fitness_history]
    return results, digests, history


@pytest.mark.parametrize("kill_point", kill_points("gateway"))
def test_kill_at_every_boundary_http_matrix(tmp_path, kill_point):
    expected, expected_digests, expected_history = _reference(tmp_path)
    root = tmp_path / "killed"
    keys = [f"idem-{i}" for i in range(N)]
    specs = [pso_spec(f"t{i}", i, n_steps=10) for i in range(N)]

    if kill_point == "pre-append":
        # The journal append for the LAST submit dies before any record
        # is durable: the client sees a structured 503 (no ack) and the
        # half-admitted tenant is withdrawn — the crash loses nothing
        # that was acknowledged.
        store = FaultyStore(enospc_saves=[N - 1])
        daemon, gateway = gw_daemon(root, store=store, exec_cache=None)
        gateway.start()
        client = client_for(daemon, max_retries=0)
        for i in range(N - 1):
            client.submit(specs[i], idem_key=keys[i])
        with pytest.raises(GatewayError) as err:
            silent(client.submit, specs[N - 1], idem_key=keys[N - 1])
        assert err.value.status == 503
        assert err.value.error == "journal-failed"
        assert qualified(f"t{N-1}") not in daemon.service._tenants
    elif kill_point == "post-append-pre-reply":
        daemon, gateway = gw_daemon(root)
        gateway.start()
        client = client_for(daemon, max_retries=0)
        client.submit(specs[0], idem_key=keys[0])
        # The last submit's reply is lost AFTER the journal append: the
        # server admitted, the client holds nothing.
        faulty = FaultyTransport(HttpTransport("127.0.0.1", daemon.endpoint.port), drop_replies=[0])
        lossy = GatewayClient(daemon.endpoint.url, "tok-alice", transport=faulty, max_retries=0)
        with pytest.raises(TransportError):
            lossy.submit(specs[1], idem_key=keys[1])
        assert qualified("t1") in daemon.service._tenants
    elif kill_point == "mid-run":
        daemon, gateway = gw_daemon(root)
        gateway.start()
        client = client_for(daemon)
        for i in range(N):
            client.submit(specs[i], idem_key=keys[i])
        silent(gateway.pump, 1)
    else:  # post-checkpoint
        daemon, gateway = gw_daemon(root)
        gateway.start()
        client = client_for(daemon)
        for i in range(N):
            client.submit(specs[i], idem_key=keys[i])
        silent(gateway.pump, 2)
    kill(daemon)
    del gateway, daemon  # SIGKILL: nothing else runs

    daemon, gateway = gw_daemon(root)
    silent(gateway.start)
    client = client_for(daemon)
    # The client holds its keys and retries every submit — it cannot
    # know which acks the dead daemon got out.  Exactly-once means each
    # retry is either the original ack replayed or (pre-append only) a
    # fresh first admission; never a duplicate.
    for i in range(N):
        ack = client.submit(specs[i], idem_key=keys[i])
        assert ack["uid"] == i, f"{kill_point}: t{i} re-keyed"
    live = [t for t in daemon.service._tenants if t.startswith("alice--")]
    assert sorted(live) == [qualified(f"t{i}") for i in range(N)]
    silent(gateway.pump)
    for i in range(N):
        tid = qualified(f"t{i}")
        record = daemon.tenant(tid)
        assert record.status is TenantStatus.COMPLETED, f"{kill_point}: {tid}"
        assert record.uid == i
        assert_states_equal(expected[tid], daemon.result(tid), f"{kill_point}: {tid}")
        assert last_checkpoint_digests(root, tid) == expected_digests[tid], (
            f"{kill_point}: {tid} final checkpoint digests differ"
        )
        # Host-side monitor history: a restart resumes from the newest
        # checkpoint, so the restarted record holds the history tail from
        # the resume point on (the in-state monitor compared above is the
        # full bit-identical record).  Every row it does hold must be
        # bit-identical to the uninterrupted run's same-generation row.
        got_history = [npify(row) for row in record.monitor.fitness_history]
        assert 1 <= len(got_history) <= len(expected_history[tid])
        tail = expected_history[tid][-len(got_history) :]
        for g, (got, want) in enumerate(zip(got_history, tail)):
            assert np.array_equal(got, want), f"{kill_point}: {tid} monitor history differs at tail row {g}"
    # And the acks the retries returned are truthful re-reads, not
    # duplicate admissions: the journal holds exactly one submit per key.
    records, _ = daemon.journal.replay()
    for i in range(N):
        assert len([r for r in records if r.kind == "submit" and r.data.get("idem") == keys[i]]) == 1, (
            f"{kill_point}: key {keys[i]} admitted more than once"
        )
    kill(daemon)


# -- read routes -------------------------------------------------------------


def test_result_long_poll_and_npz_bit_identity(tmp_path):
    expected, expected_digests, _history = _reference(tmp_path)
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        for i in range(N):
            client.submit(pso_spec(f"t{i}", i, n_steps=10))
        pump = threading.Thread(target=lambda: silent(gateway.pump))
        pump.start()
        doc = client.result("t0", wait=30)
        pump.join(timeout=60)
        assert doc["status"] == "completed"
        assert doc["generations"] >= 10
        name, digests = expected_digests[qualified("t0")]
        assert doc["checkpoint"] == name
        assert doc["leaf_digests"] == digests
        assert len(doc["fitness_history"]) == doc["generations"]
        # The archive a client downloads holds bit-identical leaves to
        # the one the Python-API run published.
        got_name, blob = client.result_npz("t0")
        assert got_name == name
        got = np.load(io.BytesIO(blob))
        want = np.load(tmp_path / "ref" / "tenants" / qualified("t0") / name)
        assert sorted(got.files) == sorted(want.files)
        for leaf in want.files:
            if leaf in ("__manifest__", "__digest__"):
                # The manifest embeds written_at (wall clock) and the
                # archive digest covers the manifest — state-leaf content
                # identity is pinned by the leaf_digests assert above.
                continue
            assert np.array_equal(got[leaf], want[leaf]), leaf
    finally:
        daemon.close()


def test_result_202_while_running(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=8))
        doc = client.result("t0", wait=0)
        assert doc["status"] == "queued"
        assert "fitness_history" not in doc
    finally:
        daemon.close()


def test_flight_long_poll_streams_rows(tmp_path):
    obs = Observability(registry=MetricsRegistry(), flight=FlightRecorder(tmp_path / "pm", window=64))
    daemon, gateway = gw_daemon(tmp_path / "svc", obs=obs)
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=12))
        pump = threading.Thread(target=lambda: silent(gateway.pump))
        pump.start()
        rows = client.flight("t0", after=-1, wait=30)
        pump.join(timeout=60)
        assert rows, "long-poll returned no flight rows"
        assert all("generation" in row for row in rows)
        generations = [row["generation"] for row in rows]
        assert generations == sorted(generations)
        # Cursoring: only rows past the watermark come back.  The run has
        # completed (pump joined), so re-fetch the final row set — the
        # long-poll snapshot above may predate the last generations.
        final = client.flight("t0", after=-1, wait=0)
        assert [r["generation"] for r in final][: len(rows)] == generations
        assert client.flight("t0", after=final[-1]["generation"], wait=0) == []
    finally:
        daemon.close()


def test_flight_404_when_not_armed(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=8))
        with pytest.raises(GatewayError) as err:
            client.flight("t0")
        assert err.value.status == 404
        assert err.value.error == "no-flight"
    finally:
        daemon.close()


# -- mutating routes (beyond submit) ----------------------------------------


def test_withdraw_parks_and_double_withdraw_409(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=8))
        gone = client.withdraw("t0")
        assert gone["status"] == "evicted"
        with pytest.raises(GatewayError) as err:
            client.withdraw("t0")
        assert err.value.status == 409
        with pytest.raises(GatewayError) as err2:
            client.withdraw("never-submitted")
        assert err2.value.status == 404
    finally:
        daemon.close()


def test_steer_via_http_changes_budget_at_boundary(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=8))
        ack = client.steer("t0", n_steps=16, checkpoint_every=1)
        assert ack["knobs"] == {"n_steps": 16, "checkpoint_every": 1}
        silent(gateway.pump)
        record = daemon.tenant(qualified("t0"))
        assert record.status is TenantStatus.COMPLETED
        assert record.spec.n_steps == 16
        assert record.generations >= 16
        with pytest.raises(GatewayError) as err:
            client.steer("t0", n_steps=0)
        assert err.value.status == 400
    finally:
        daemon.close()


def test_catalog_submit_and_unknown_kinds_400(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        ack = client.submit(catalog=CATALOG)
        assert ack["status"] == "queued"
        silent(gateway.pump)
        record = daemon.tenant(qualified("curl0"))
        assert record.status is TenantStatus.COMPLETED
        # The catalog form builds on the daemon's device, equal to the
        # same spec built through the Python API.
        assert record.spec.algorithm.lb.device == daemon.device
        for field, bad in (("algorithm", "Nope"), ("problem", "Nope")):
            broken = dict(CATALOG, tenant_id="curl1")
            broken[field] = dict(CATALOG[field], kind=bad)
            with pytest.raises(GatewayError) as err:
                client.submit(catalog=broken)
            assert err.value.status == 400
    finally:
        daemon.close()


# -- telemetry surfaces ------------------------------------------------------


def test_statusz_and_metrics_carry_gateway_counters(tmp_path):
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=8))
        client.status("t0")
        with pytest.raises(GatewayError):
            client_for(daemon, token="tok-wrong").status("t0")
        status = json.loads(urllib.request.urlopen(f"{daemon.endpoint.url}/statusz").read().decode())
        section = status["gateway"]
        assert section["requests"]["submit:201"] == 1
        assert section["requests"]["status:200"] == 1
        assert section["auth_rejects"] == 1
        assert section["principals"] == {"alice": 1}
        metrics = urllib.request.urlopen(f"{daemon.endpoint.url}/metrics").read().decode()
        assert "evox_gateway_requests_total" in metrics
        assert "evox_gateway_auth_rejects_total" in metrics
    finally:
        daemon.close()


# -- the port's own rules ----------------------------------------------------


def test_spec_reaches_the_daemon_device_only_under_the_lock(tmp_path, monkeypatch):
    """A submitted spec is decoded first on the host, outside
    ``gateway.lock``, and onto the daemon's device only under it (on the
    card a handler thread's allocation during the serving thread's capture
    would invalidate the capture).  Here the host is made a device other
    than the daemon's, so both decodes run: the pickle form and the
    catalog form (the host named by a string, which compares unequal to
    the daemon's ``torch.device("cpu")``)."""
    monkeypatch.setattr(gateway_module, "_HOST", "cpu")
    daemon, gateway = gw_daemon(tmp_path / "svc")
    seen = []
    decode = Gateway._decode_submit_spec

    def recording(self, payload, device):
        seen.append((device, self.lock._is_owned()))
        return decode(self, payload, device)

    monkeypatch.setattr(Gateway, "_decode_submit_spec", recording)
    gateway.start()
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=4))
        client.submit(catalog=CATALOG)
        host, dev = "cpu", daemon.device
        assert seen == [(host, False), (dev, True), (host, False), (dev, True)]
        # A blob that does not decode is refused on the host, the lock
        # never taken for it.
        status, _h, body = HttpTransport("127.0.0.1", daemon.endpoint.port).request(
            "POST",
            "/api/v1/tenants",
            {"Authorization": "Bearer tok-alice", "Idempotency-Key": "junk"},
            json.dumps({"spec": {"format": "pickle", "blob": "AAAA"}}).encode(),
        )
        assert (status, json.loads(body)["error"]) == (400, "bad-spec")
        assert seen[-1] == (host, False)
        assert [r.spec.algorithm.lb.device for r in daemon.service._tenants.values()] == [dev, dev]
    finally:
        daemon.close()


def test_serving_loop_hands_the_lock_to_a_queued_handler(tmp_path):
    """Between two rounds the serving loop waits until a handler queued on
    ``gateway.lock`` holds it: right after ``_let_handlers_in`` the loop
    cannot take the lock back (with a plain release it usually would,
    before the woken handler runs)."""
    daemon, gateway = gw_daemon(tmp_path / "svc")
    holding, done = threading.Event(), threading.Event()

    def handler():
        with gateway._hold():
            holding.set()
            done.wait(30)

    try:
        for _ in range(20):
            holding.clear(), done.clear()
            gateway.lock.acquire()  # a round
            thread = threading.Thread(target=handler)
            thread.start()
            deadline = time.monotonic() + 30
            while gateway._waiting == 0 and time.monotonic() < deadline:
                time.sleep(0.0005)
            gateway.lock.release()
            gateway._let_handlers_in()
            took_back = gateway.lock.acquire(blocking=False)
            if took_back:
                gateway.lock.release()
            assert not took_back, "the serving loop took the lock back first"
            assert holding.wait(30)
            done.set()
            thread.join(30)
            assert gateway._waiting == 0
    finally:
        done.set()
        daemon.close()


def test_handlers_interleave_with_a_busy_serving_loop(tmp_path):
    """While ``gateway.pump()`` runs round after round, a handler thread
    queued on ``gateway.lock`` takes it at the next boundary: the serving
    loop lets every queued handler in before its next round (a lock
    released and taken again at once would starve them until the daemon
    went idle; on the card a queued submit waited out many rounds).  A
    status read queued during round 1 runs before round 2; then a steer
    lands mid-run and ends the tenant early."""
    daemon, gateway = gw_daemon(tmp_path / "svc", checkpoint_every=10**6)
    gateway.start()
    events, replies = [], []
    try:
        client = client_for(daemon)
        client.submit(pso_spec("t0", 0, n_steps=400))
        step, snapshot = daemon.step, gateway._snapshot

        def recording_step():
            events.append("round")
            if len(events) == 1:
                reader = threading.Thread(target=lambda: replies.append(client.status("t0")))
                reader.start()
                deadline = time.monotonic() + 30
                while gateway._waiting == 0 and time.monotonic() < deadline:
                    time.sleep(0.001)
            return step()

        def recording_snapshot(tenant_id, record):
            events.append("handler")
            return snapshot(tenant_id, record)

        daemon.step, gateway._snapshot = recording_step, recording_snapshot
        silent(gateway.pump, 3)
        assert events == ["round", "handler", "round", "round"]
        daemon.step, gateway._snapshot = step, snapshot
        pump = threading.Thread(target=lambda: silent(gateway.pump))
        pump.start()
        ack = client.steer("t0", n_steps=8 + client.status("t0")["generations"])
        pump.join(timeout=120)
        record = daemon.tenant(qualified("t0"))
        assert record.status is TenantStatus.COMPLETED
        assert record.spec.n_steps == ack["knobs"]["n_steps"] <= record.generations < 400
        assert len(replies) == 1
    finally:
        daemon.close()


def test_encode_spec_is_the_journal_encoding(tmp_path):
    """``encode_spec`` is the daemon journal's own encoding: the blob a
    client sends is the blob the journal records."""
    from evox_tpu_torch.service.daemon import _encode_spec

    spec = pso_spec("t0", 0)
    wire = encode_spec(spec)
    assert wire["format"] == "pickle"
    daemon, gateway = gw_daemon(tmp_path / "svc")
    gateway.start()
    try:
        client_for(daemon).submit(spec, idem_key="k")
        records, _ = daemon.journal.replay()
        (submit,) = [r for r in records if r.kind == "submit"]
        # The journaled spec carries the qualified id: re-encode the
        # client's spec under it.
        from dataclasses import replace

        assert submit.data["spec"] == _encode_spec(replace(spec, tenant_id=qualified("t0")))
        assert (submit.data["idem"], submit.data["principal"]) == ("k", "alice")
    finally:
        daemon.close()


def test_client_and_transport_import_only_the_standard_library():
    """The client side of the wire is cheap to spawn: the modules' top-level
    imports are the standard library's (``encode_spec`` reaches the
    daemon's encoder lazily), and no module of the slice imports JAX."""
    import sys

    root = Path(evox_tpu_torch.__file__).resolve().parent
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for rel in ("service/client.py", "resilience/transport.py"):
        tree = ast.parse((root / rel).read_text())
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [("." if node.level else "") + (node.module or "")]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in stdlib or name == ".schedule", (rel, name)
    for rel in ("service/client.py", "resilience/transport.py", "service/gateway.py"):
        for node in ast.walk(ast.parse((root / rel).read_text())):
            names = (
                [a.name for a in node.names]
                if isinstance(node, ast.Import)
                else [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            )
            for name in names:
                assert name.split(".")[0] not in ("jax", "evox_tpu"), (rel, name)


# -- (a) FaultyTransport against the JAX package -----------------------------


class StubInner:
    """A deterministic inner transport: reply i is ``(200 + i % 3, {"X-Call":
    i}, body_i)``, ``body_i`` a JSON document of the call's index and
    request."""

    def __init__(self):
        self.calls = []

    def request(self, method, path, headers, body):
        i = len(self.calls)
        self.calls.append((method, path, dict(headers), body))
        doc = {"call": i, "method": method, "path": path, "body": body.decode(), "pad": "x" * (7 * i + 3)}
        return 200 + i % 3, {"X-Call": str(i)}, json.dumps(doc).encode()


TRANSPORT_SCHEDULES = [
    {},
    {"drop_requests": [0, 3]},
    {"drop_replies": [1], "duplicate_requests": [1, 4]},
    {"torn_replies": [0, 2, 5], "torn_fraction": 0.3},
    {"torn_replies": [1], "torn_fraction": 0.0},
    {"torn_replies": [2], "torn_fraction": 1.0},
    {"drop_requests": [0], "drop_replies": [1], "torn_replies": [2], "duplicate_requests": [3]},
    {"delay_requests": [0, 2], "delay_seconds": 0.0, "drop_replies": [2], "duplicate_requests": [2]},
    {"duplicate_requests": [0, 1, 2], "torn_replies": [1], "torn_fraction": 0.75},
]


def _drive_transport(factory, error_type, schedule):
    inner = StubInner()
    faulty = factory(inner, **schedule)
    outcomes = []
    for i in range(7):
        try:
            status, headers, body = faulty.request("POST", f"/api/v1/x{i}", {"H": str(i)}, f"b{i}".encode())
            outcomes.append(("ok", status, headers, body))
        except error_type as e:
            outcomes.append(("error", type(e).__name__, str(e)))
    return outcomes, list(faulty.events), faulty.requests, inner.calls


@pytest.mark.parametrize("schedule", TRANSPORT_SCHEDULES, ids=[str(i) for i in range(len(TRANSPORT_SCHEDULES))])
def test_faulty_transport_equals_jax(schedule):
    got = _drive_transport(FaultyTransport, TransportError, schedule)
    want = _drive_transport(JFaultyTransport, JTransportError, schedule)
    assert got == want
    assert issubclass(TransportError, ConnectionError)


BAD_TRANSPORT_SCHEDULES = [
    {"drop_requests": [-1]},
    {"torn_replies": [0, -3, -2]},
    {"drop_requests": [1, 2], "drop_replies": [2]},
    {"drop_requests": [4], "torn_replies": [4]},
    {"drop_requests": [0], "duplicate_requests": [0]},
    {"drop_replies": [5, 6], "torn_replies": [6, 5]},
    {"torn_fraction": -0.5},
    {"delay_seconds": -1.0},
]


@pytest.mark.parametrize("schedule", BAD_TRANSPORT_SCHEDULES, ids=[str(i) for i in range(len(BAD_TRANSPORT_SCHEDULES))])
def test_faulty_transport_validation_messages_equal_jax(schedule):
    with pytest.raises(ValueError) as got:
        FaultyTransport(StubInner(), **schedule)
    with pytest.raises(ValueError) as want:
        JFaultyTransport(StubInner(), **schedule)
    assert str(got.value) == str(want.value)


# -- (b) GatewayClient against the JAX package -------------------------------


class Scripted:
    """A transport that plays a script: each entry is a reply ``(status,
    headers, body)`` or the string ``"lost"`` (a ``ConnectionError``);
    every request is recorded."""

    def __init__(self, script):
        self.script = list(script)
        self.seen = []

    def request(self, method, path, headers, body):
        self.seen.append((method, path, dict(headers), body))
        step = self.script.pop(0)
        if step == "lost":
            raise ConnectionResetError("scripted: connection reset")
        return step


OK = (200, {}, b'{"ok": true}')
CREATED = (201, {"Content-Type": "application/json"}, b'{"tenant_id": "t", "uid": 3}')


def _err(status, error, retry_after=None, detail="d"):
    headers = {} if retry_after is None else {"Retry-After": retry_after}
    return status, headers, json.dumps({"error": error, "detail": detail}).encode()


CLIENT_SCRIPTS = {
    "first-try": (("submit",), [CREATED]),
    "503-then-ok": (("submit",), [_err(503, "queue-full", "3"), CREATED]),
    "429-capped": (("submit",), [_err(429, "shed", "100"), _err(429, "shed", "1"), CREATED]),
    "torn-then-ok": (("steer",), [(200, {}, b'{"tenant_id": "t", "kn'), OK]),
    "not-an-object": (("steer",), [(200, {}, b"[1, 2]"), OK]),
    "lost-then-ok": (("withdraw",), ["lost", "lost", OK]),
    "lost-exhausted": (("withdraw",), ["lost"] * 6),
    "503-exhausted": (("submit",), [_err(503, "journal-failed", "2")] * 6),
    "terminal-400": (("submit",), [_err(400, "bad-spec", detail="no")]),
    "terminal-409-header-case": (("steer",), [(409, {"retry-after": "5"}, b'{"error": "not-steerable"}')]),
    "500-not-json": (("status",), [(500, {}, b"<html>oops</html>")]),
    "retry-after-junk": (("submit",), [_err(503, "queue-full", "soon"), CREATED]),
    "result-202": (("result",), [(202, {}, b'{"status": "running"}')]),
    "result-torn-then-200": (("result",), [(200, {}, b"{"), (200, {}, b'{"status": "completed"}')]),
    "flight-rows": (("flight",), [(200, {}, b'{"rows": [{"generation": 1}, {"generation": 2}]}')]),
    "npz": (("result_npz",), [(200, {"X-Checkpoint-Name": "ckpt_00000008.npz"}, b"\x93NUMPY")]),
    "npz-404": (("result_npz",), [_err(404, "no-checkpoint")]),
    "backoff-cap": (("submit",), ["lost"] * 5 + [CREATED]),
}


def _drive_client(client_cls, error_cls, calls, script):
    transport = Scripted(script)
    sleeps = []
    client = client_cls(
        "http://127.0.0.1:9", "tok", transport=transport, max_retries=5, backoff=0.05, backoff_cap=0.3,
        retry_after_cap=4.0, sleep=sleeps.append,
    )
    (call,) = calls
    kwargs = {
        "submit": lambda: client.submit(catalog={"tenant_id": "t", "n_steps": 4}, idem_key="key-1"),
        "steer": lambda: client.steer("t 1", n_steps=8, idem_key="key-2"),
        "withdraw": lambda: client.withdraw("t/1", idem_key="key-3"),
        "status": lambda: client.status("t"),
        "result": lambda: client.result("t", wait=2),
        "flight": lambda: client.flight("t", after=3, wait=1.5),
        "result_npz": lambda: client.result_npz("t"),
    }
    try:
        out = ("ok", kwargs[call]())
    except error_cls as e:
        out = ("gateway-error", e.status, e.error, e.detail, e.retry_after, str(e))
    except OSError as e:
        out = ("os-error", type(e).__name__ if type(e).__name__ != "_TornReply" else "torn", str(e))
    return out, sleeps, client.retries, transport.seen


@pytest.mark.parametrize("name", sorted(CLIENT_SCRIPTS))
def test_gateway_client_retry_loop_equals_jax(name):
    calls, script = CLIENT_SCRIPTS[name]
    got = _drive_client(GatewayClient, GatewayError, calls, script)
    want = _drive_client(JGatewayClient, JGatewayError, calls, script)
    assert got == want
    # A mutating call repeats its key verbatim on every attempt.
    keys = {h.get("Idempotency-Key") for _m, _p, h, _b in got[3]}
    assert len(keys) == 1


# -- (c) one raw HTTP sequence against a JAX gateway and the port's ----------


def _http_sequence(url_port, blob):
    """The scripted requests; each reply reduced to (status, error code,
    Retry-After present, JSON key set)."""
    transport = HttpTransport("127.0.0.1", url_port)
    alice = {"Authorization": "Bearer tok-alice"}
    bob = {"Authorization": "Bearer tok-bob"}

    def with_key(headers, key):
        return {**headers, "Idempotency-Key": key}

    def catalog(**kw):
        doc = json.loads(json.dumps(CATALOG))
        doc.update(tenant_id="c0")
        for k, v in kw.items():
            if k in ("algorithm", "problem"):
                doc[k].update(v)
            else:
                doc[k] = v
        return json.dumps(doc).encode()

    spec = json.dumps({"spec": {"format": "pickle", "blob": blob}}).encode()
    steps = [
        ("POST", "/api/v1/tenants", {}, b"{}"),
        ("POST", "/api/v1/tenants", {"Authorization": "Bearer nope"}, b"{}"),
        ("GET", "/api/v1/tenants/t0", {"Authorization": "Basic abc"}, b""),
        ("POST", "/api/v1/tenants", alice, b"{}"),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), b"{not json"),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), b"[1, 2]"),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), b"{}"),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), b'{"spec": {"format": "yaml", "blob": ""}}'),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), b'{"spec": {"format": "pickle", "blob": "AAAA"}}'),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(algorithm={"kind": "Nope"})),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(problem={"kind": "Nope"})),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(algorithm={"pop_size": "many"})),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(problem={"kind": "CEC2022"})),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(tenant_id="../evil")),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(tenant_id="a b")),
        ("POST", "/api/v1/tenants", with_key(alice, "k0"), catalog(tenant_id="")),
        ("POST", "/api/v1/tenants", with_key(alice, "k1"), spec),
        ("POST", "/api/v1/tenants", with_key(alice, "k1"), spec),
        ("POST", "/api/v1/tenants", with_key(alice, "k2"), spec),
        ("POST", "/api/v1/tenants", with_key(alice, "k3"), catalog(tenant_id="c1")),
        ("POST", "/api/v1/tenants", with_key(alice, "k4"), catalog(tenant_id="c2", tenant_class="gold")),
        ("GET", "/api/v1/tenants/t0", alice, b""),
        ("GET", "/api/v1/tenants/t0", bob, b""),
        ("DELETE", "/api/v1/tenants/t0", bob, b""),
        ("GET", "/api/v1/tenants/%2E%2E%2Fetc", alice, b""),
        ("GET", "/api/v1/tenants", alice, b""),
        ("GET", "/api/v1/tenants/", alice, b""),
        ("POST", "/api/v1/tenants/t0", alice, b""),
        ("GET", "/api/v1/tenants/t0/nope", alice, b""),
        ("GET", "/api/v1/tenants/t0/a/b", alice, b""),
        ("DELETE", "/api/v1/tenants/t0/steer", alice, b""),
        ("GET", "/api/v1/elsewhere", alice, b""),
        ("POST", "/api/v1/tenants/t0/steer", alice, b"{}"),
        ("POST", "/api/v1/tenants/t0/steer", alice, b'{"n_steps": 0}'),
        ("POST", "/api/v1/tenants/t0/steer", with_key(alice, "s1"), b'{"n_steps": 16}'),
        ("POST", "/api/v1/tenants/t0/steer", with_key(alice, "s1"), b'{"n_steps": 16}'),
        ("POST", "/api/v1/tenants/t0/steer", alice, b'{"checkpoint_every": 2, "max_restarts": 1}'),
        ("POST", "/api/v1/tenants/missing/steer", alice, b'{"n_steps": 4}'),
        ("GET", "/api/v1/tenants/t0/result?wait=0", alice, b""),
        ("GET", "/api/v1/tenants/t0/result?wait=soon", alice, b""),
        ("GET", "/api/v1/tenants/t0/result?format=npz", alice, b""),
        ("GET", "/api/v1/tenants/t0/flight", alice, b""),
        ("GET", "/api/v1/tenants/t0/flight?after=x", alice, b""),
        ("GET", "/api/v1/tenants/t0/flight?wait=-3", alice, b""),
        ("DELETE", "/api/v1/tenants/t0", with_key(alice, "w1"), b""),
        ("DELETE", "/api/v1/tenants/t0", with_key(alice, "w2"), b""),
        ("DELETE", "/api/v1/tenants/t0", with_key(alice, "w1"), b""),
        ("DELETE", "/api/v1/tenants/never", alice, b""),
        ("GET", "/api/v1/tenants/t0", alice, b""),
        ("POST", "/api/v1/tenants", with_key(bob, "k1"), spec),
        ("POST", "/api/v1/tenants", with_key(bob, "k9"), catalog(tenant_id="c3")),
        ("POST", "/api/v1/tenants", with_key(bob, "k10"), catalog(tenant_id="c4")),
        ("POST", "/api/v1/tenants", with_key(alice, "k1"), catalog(tenant_id="c9")),
    ]
    out = []
    for method, path, headers, body in steps:
        status, reply_headers, payload = transport.request(method, path, headers, body)
        try:
            doc = json.loads(payload)
        except ValueError:
            doc = None
        retry_after = any(k.lower() == "retry-after" for k in reply_headers)
        out.append(
            (
                method,
                path,
                status,
                doc.get("error") if isinstance(doc, dict) else None,
                retry_after,
                sorted(doc) if isinstance(doc, dict) else None,
            )
        )
    return out


def test_http_sequence_equals_the_jax_gateway(tmp_path):
    """Both gateways take a class budget of 2 and a measured cadence of 2 s,
    so the sequence meets a 429 with ``Retry-After`` as well."""
    jdaemon = jtd.make_daemon(tmp_path / "jax", classes=[JTenantClass("standard", 2)])
    jgateway = JGateway(jdaemon, tokens=TOKENS)
    daemon, gateway = gw_daemon(tmp_path / "port", classes=[TenantClass("standard", 2)])
    results, statusz = [], []
    try:
        for d, g, blob in (
            (jdaemon, jgateway, jencode_spec(jtd.pso_spec("t0", 0, n_steps=8))["blob"]),
            (daemon, gateway, encode_spec(pso_spec("t0", 0, n_steps=8))["blob"]),
        ):
            silent(g.start)
            d._last_segment_seconds = 2.0
            results.append(silent(_http_sequence, d.endpoint.port, blob))
            statusz.append(g.statusz_payload())
    finally:
        jdaemon.close()
        daemon.close()
    for step, (want, got) in enumerate(zip(*results)):
        assert got == want, f"request #{step}"
    assert statusz[1] == statusz[0]
    codes = {r[2] for r in results[1]}
    assert {201, 200, 202, 400, 401, 404, 405, 409, 429} <= codes


# -- (d) the catalog's accepted kinds ----------------------------------------


def test_catalog_kinds_equal_jax(tmp_path):
    """Every kind either package knows (and one neither does) submitted in
    the catalog form with a hostile id: "unknown ... kind" on one side
    exactly when on the other (a known kind is built, then its id is
    refused, or its constructor refuses the catalog's arguments)."""
    import evox_tpu.algorithms as jalgorithms
    import evox_tpu.problems.numerical as jnumerical

    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems import numerical

    assert set(algorithms.__all__) == set(jalgorithms.__all__)
    assert set(numerical.__all__) == set(jnumerical.__all__)
    kinds = [("algorithm", k) for k in sorted(set(algorithms.__all__) | {"Nope", "torch"})]
    kinds += [("problem", k) for k in sorted(set(numerical.__all__) | {"Nope", "os"})]
    jdaemon = jtd.make_daemon(tmp_path / "jax")
    jgateway = JGateway(jdaemon, tokens=TOKENS)
    daemon, gateway = gw_daemon(tmp_path / "port")
    verdicts = []
    try:
        for d, g in ((jdaemon, jgateway), (daemon, gateway)):
            silent(g.start)
            transport = HttpTransport("127.0.0.1", d.endpoint.port)
            side = {}
            for field, kind in kinds:
                doc = json.loads(json.dumps(CATALOG))
                doc["tenant_id"] = "a/b"
                doc[field]["kind"] = kind
                status, _h, body = silent(
                    transport.request,
                    "POST",
                    "/api/v1/tenants",
                    {"Authorization": "Bearer tok-alice", "Idempotency-Key": f"{field}-{kind}"},
                    json.dumps(doc).encode(),
                )
                # A known kind's constructor may refuse the catalog's
                # arguments with any error (a 400, or a 500 where the JAX
                # package's raises outside KeyError/TypeError/ValueError):
                # only the whitelist's verdict is compared.
                reply = json.loads(body)
                side[(field, kind)] = status == 400 and reply["detail"].startswith(f"unknown {field} kind")
            verdicts.append(side)
            assert not d.service._tenants
    finally:
        jdaemon.close()
        daemon.close()
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][("algorithm", "PSO")] is False and verdicts[1][("algorithm", "Nope")] is True
