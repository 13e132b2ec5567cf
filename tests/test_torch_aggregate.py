"""The port's fleet aggregator and the supervisor's endpoint against the JAX
package's (counterparts of ``tests/test_telemetry.py``'s aggregation and
supervisor-endpoint tests).

Each aggregation scenario runs twice on the same payload sequence, once
with each package's ``MetricsRegistry`` and ``FleetAggregator``: the
assertions of the JAX test hold on the port, and both aggregators export
the same Prometheus text.  The supervisor tests drive the port's
``FleetSupervisor`` with scripted workers, as the JAX ones drive theirs.
"""

import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

pytest.importorskip("torch")
import evox_tpu.obs as jobs  # noqa: E402

import evox_tpu_torch.obs as tobs  # noqa: E402
from evox_tpu_torch.obs import (  # noqa: E402
    OBS_SCHEMA_VERSION,
    FleetAggregator,
    IntrospectionEndpoint,
    MetricsRegistry,
    Observability,
    parse_series,
)
from evox_tpu_torch.resilience import FleetSupervisor  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_multihost import FakeWorker  # noqa: E402


def _both(scenario):
    """Run ``scenario(obs_module)`` with the port's and the JAX package's
    obs modules; the two aggregators must export the same text.  Returns
    the port's aggregator."""
    mine, theirs = scenario(tobs), scenario(jobs)
    assert mine.to_prometheus() == theirs.to_prometheus()
    return mine


def _beat(pid, reg):
    return {"pid": pid, "metrics": reg.fleet_payload()}


# ---------------------------------------------------------------------------
# series parsing + typed heartbeat payload
# ---------------------------------------------------------------------------


def test_parse_series_round_trips_escaped_labels():
    reg = MetricsRegistry()
    reg.counter("c_total", tenant_id='a"b\\c,d', note="x\ny").inc()
    (series,) = reg.snapshot()
    name, labels = parse_series(series)
    assert name == "c_total"
    assert labels == {"tenant_id": 'a"b\\c,d', "note": "x\ny"}
    assert (name, labels) == jobs.parse_series(series)
    assert parse_series("plain") == ("plain", {})
    with pytest.raises(ValueError):
        parse_series("bad{oops}")


def test_fleet_payload_carries_bucket_arrays():
    def fill(o):
        reg = o.MetricsRegistry()
        reg.counter("c_total").inc(3)
        reg.gauge("g").set(7)
        reg.histogram("h_seconds", buckets=[0.1, 1.0]).observe(0.5)
        return reg.fleet_payload()

    payload = fill(tobs)
    assert payload["schema"] == OBS_SCHEMA_VERSION
    assert payload["counters"] == {"c_total": 3.0}
    assert payload["gauges"] == {"g": 7.0}
    hist = payload["histograms"]["h_seconds"]
    assert hist["bounds"] == [0.1, 1.0]
    assert hist["counts"] == [0.0, 1.0, 1.0]
    assert hist["count"] == 1.0 and hist["sum"] == pytest.approx(0.5)
    assert json.loads(json.dumps(payload)) == payload
    assert payload == fill(jobs)


# ---------------------------------------------------------------------------
# fleet aggregation
# ---------------------------------------------------------------------------


def test_aggregator_merges_counters_gauges_histograms():
    def scenario(o):
        h0, h1 = o.MetricsRegistry(), o.MetricsRegistry()
        h0.counter("evox_gens_total").inc(10)
        h1.counter("evox_gens_total").inc(5)
        h0.gauge("evox_queue").set(3)
        h1.gauge("evox_queue").set(7)
        h0.histogram("evox_seg_seconds", buckets=[1.0]).observe(0.5)
        h1.histogram("evox_seg_seconds", buckets=[1.0]).observe(2.0)
        agg = o.FleetAggregator()
        agg.update({0: _beat(100, h0), 1: _beat(200, h1)})
        scenario.first = agg.snapshot()
        agg.update({0: _beat(100, h0), 1: _beat(200, h1)})  # idempotent re-fold
        return agg

    agg = _both(scenario)
    snap = agg.snapshot()
    assert snap["evox_gens_total"] == 15
    assert snap['evox_queue{process_index="0"}'] == 3
    assert snap['evox_queue{process_index="1"}'] == 7
    assert snap['evox_seg_seconds_bucket{le="1.0"}'] == 1
    assert snap['evox_seg_seconds_bucket{le="+Inf"}'] == 2
    assert snap["evox_seg_seconds_sum"] == pytest.approx(2.5)
    assert scenario.first == snap


def test_aggregator_counters_resume_monotone_across_relaunch():
    def scenario(o):
        h0 = o.MetricsRegistry()
        h0.counter("evox_gens_total").inc(10)
        agg = o.FleetAggregator()
        agg.update({0: _beat(100, h0)})
        h0b = o.MetricsRegistry()  # a relaunched attempt: new pid, counters from 0
        h0b.counter("evox_gens_total").inc(4)
        agg.update({0: _beat(101, h0b)})
        scenario.relaunched = agg.snapshot()["evox_gens_total"]
        h0c = o.MetricsRegistry()  # a restart the pid check missed
        h0c.counter("evox_gens_total").inc(2)
        agg.update({0: _beat(101, h0c)})
        hh = o.MetricsRegistry()
        hh.histogram("evox_h", buckets=[1.0]).observe(0.5)
        agg.update({0: {"pid": 101, "metrics": hh.fleet_payload()}})
        hh2 = o.MetricsRegistry()
        hh2.histogram("evox_h", buckets=[1.0]).observe(0.5)
        agg.update({0: {"pid": 102, "metrics": hh2.fleet_payload()}})
        return agg

    agg = _both(scenario)
    assert scenario.relaunched == 14
    assert agg.snapshot()["evox_gens_total"] == 16
    assert agg.snapshot()["evox_h_count"] == 2


def test_aggregator_marks_dead_host_series_stale():
    def scenario(o):
        h0, h1 = o.MetricsRegistry(), o.MetricsRegistry()
        h0.gauge("evox_queue").set(1)
        h1.gauge("evox_queue").set(9)
        h1.counter("evox_gens_total").inc(5)
        agg = o.FleetAggregator()
        beats = {0: _beat(1, h0), 1: _beat(2, h1)}
        agg.update(beats)
        agg.update(beats, stale_hosts=[1])
        scenario.dead = agg.snapshot()
        h1.gauge("evox_queue").set(4)
        agg.update({0: _beat(1, h0), 1: _beat(3, h1)})
        scenario.back = agg.snapshot()
        agg.update({0: _beat(1, h0)})
        return agg

    agg = _both(scenario)
    snap = scenario.dead
    assert snap['evox_queue{process_index="1",stale="true"}'] == 9
    assert 'evox_queue{process_index="1"}' not in snap
    assert snap['evox_fleet_host_up{process_index="1"}'] == 0
    assert snap['evox_fleet_host_up{process_index="0"}'] == 1
    assert snap["evox_gens_total"] == 5
    snap = scenario.back
    assert 'evox_queue{process_index="1",stale="true"}' not in snap
    assert snap['evox_queue{process_index="1"}'] == 4
    assert snap['evox_fleet_host_up{process_index="1"}'] == 1
    assert agg.snapshot()['evox_fleet_host_up{process_index="1"}'] == 0


def test_aggregator_skips_conflicting_histogram_bounds_with_warning():
    def scenario(o):
        h0, h1 = o.MetricsRegistry(), o.MetricsRegistry()
        h0.histogram("evox_h", buckets=[1.0]).observe(0.5)
        h1.histogram("evox_h", buckets=[2.0]).observe(0.5)
        agg = o.FleetAggregator()
        agg.update({0: _beat(1, h0)})
        with pytest.warns(UserWarning, match="conflict"):
            agg.update({0: _beat(1, h0), 1: _beat(2, h1)})
        return agg

    assert _both(scenario).snapshot()["evox_h_count"] == 1


def test_aggregator_legacy_flat_payload_best_effort():
    def scenario(o):
        agg = o.FleetAggregator()
        agg.update({0: {"pid": 1, "metrics": {"evox_gens_total": 5.0, "evox_queue": 2.0}}})
        return agg

    snap = _both(scenario).snapshot()
    assert snap["evox_gens_total"] == 5
    assert snap['evox_queue{process_index="0"}'] == 2


def test_aggregator_update_from_dir_reads_beats_and_verdicts(tmp_path):
    """Beats written by the port's HostHeartbeat, folded through each
    package's ``update_from_dir`` with its own FleetHealth at one clock."""
    from evox_tpu.parallel import FleetHealth as JFleetHealth

    from evox_tpu_torch.parallel import FleetHealth, HostHeartbeat

    for idx, gens in ((0, 7), (1, 3)):
        reg = MetricsRegistry()
        reg.counter("evox_gens_total").inc(gens)
        reg.gauge("evox_queue").set(idx + 1)
        HostHeartbeat(tmp_path, idx, metrics=reg).beat(generation=gens)
    now = time.time() + 10.0  # both beats 10 s old: dead past dead_after=5
    aggs = []
    for agg, health in ((FleetAggregator(), FleetHealth(tmp_path, 2)), (jobs.FleetAggregator(), JFleetHealth(tmp_path, 2))):
        report = agg.update_from_dir(tmp_path, health, now=now)
        assert report.dead_hosts == [0, 1]
        aggs.append(agg)
    assert aggs[0].to_prometheus() == aggs[1].to_prometheus()
    fresh = FleetAggregator()
    fresh.update_from_dir(tmp_path)
    assert fresh.snapshot()["evox_gens_total"] == 10


# ---------------------------------------------------------------------------
# the supervisor's endpoint and the consumed /healthz
# ---------------------------------------------------------------------------


def _get(url):
    try:
        resp = urllib.request.urlopen(url, timeout=10)
        return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _parse_prom(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def test_supervisor_consumes_external_healthz(tmp_path):
    verdict = {"healthy": True, "dead": []}
    ep = IntrospectionEndpoint(healthz=lambda: (verdict["healthy"], dict(verdict))).start()

    def spawn(argv, env, spec):
        return FakeWorker(rc=None if spec.attempt == 0 else 0)

    sup = FleetSupervisor(
        lambda spec: ["true"],
        2,
        checkpoint_dir=tmp_path / "ckpt",
        spawn=spawn,
        poll_interval=0.01,
        grace_seconds=0.05,
        start_grace=1000.0,
        healthz_url=ep.url + "/healthz",
        obs=Observability(registry=MetricsRegistry()),
    )
    results: list = []
    try:
        runner = threading.Thread(target=lambda: results.append(sup.run()))
        runner.start()
        time.sleep(0.3)  # attempt 0 is hung (rc=None) and healthy
        verdict.update(healthy=False, dead=[1])  # the sidecar names host 1
        runner.join(timeout=60)
        assert not runner.is_alive()
    finally:
        ep.stop()
    stats = results[0]
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    assert stats.removed_hosts[0][1] == 1
    assert "consumed healthz" in stats.removed_hosts[0][2]


def test_supervisor_unreachable_healthz_warns_once_and_continues(tmp_path):
    def spawn(argv, env, spec):
        t0 = time.monotonic()

        class LateWorker(FakeWorker):
            def poll(self):
                if self.rc is None and time.monotonic() - t0 > 0.5:
                    self.rc = 0
                return self.rc

        return LateWorker(rc=None)

    sup = FleetSupervisor(
        lambda spec: ["true"],
        1,
        checkpoint_dir=tmp_path / "ckpt",
        spawn=spawn,
        poll_interval=0.01,
        start_grace=1000.0,
        healthz_url="http://127.0.0.1:9/healthz",  # port 9: nothing there
        healthz_timeout=0.2,
        obs=Observability(registry=MetricsRegistry()),
    )
    stats = sup.run()
    assert stats.completed
    assert [e.kind for e in stats.events].count("healthz-unreachable") == 1


def test_supervisor_endpoint_serves_fleet_view(tmp_path):
    hb = tmp_path / "ckpt" / "heartbeats"
    hb.mkdir(parents=True)
    reg = MetricsRegistry()
    reg.counter("evox_runner_generations_total").inc(12)
    done = threading.Event()

    def spawn(argv, env, spec):
        (hb / "host_0000.json").write_text(json.dumps({
            "process_index": 0, "pid": 77, "time": time.time() + 3600, "generation": 12,
            "metrics": reg.fleet_payload(),
        }))

        class GatedWorker(FakeWorker):
            def poll(self):
                if self.rc is None and done.is_set():
                    self.rc = 0
                return self.rc

        return GatedWorker(rc=None)

    sup = FleetSupervisor(
        lambda spec: ["true"],
        1,
        checkpoint_dir=tmp_path / "ckpt",
        spawn=spawn,
        poll_interval=0.02,
        start_grace=1000.0,
        endpoint=True,
        obs=Observability(registry=MetricsRegistry()),
    )
    results: list = []
    runner = threading.Thread(target=lambda: results.append(sup.run()))
    runner.start()
    try:
        deadline = time.monotonic() + 60
        scraped = None
        while time.monotonic() < deadline:
            try:
                if sup.endpoint.started:
                    status, text = _get(sup.endpoint.url + "/metrics")
                    if status == 200 and "evox_runner_generations_total" in text:
                        scraped = text
                        break
            except OSError:
                pass
            time.sleep(0.05)
        assert scraped is not None, "never scraped the aggregated view"
        assert _parse_prom(scraped)["evox_runner_generations_total"] == 12
        status, text = _get(sup.endpoint.url + "/healthz")
        assert status == 200
        assert json.loads(text)["hosts"]["0"]["alive"] is True
        status, text = _get(sup.endpoint.url + "/statusz")
        assert json.loads(text)["attempts"] == 1
    finally:
        done.set()
        runner.join(timeout=60)
    assert results and results[0].completed
    with pytest.raises(OSError):
        urllib.request.urlopen(sup.endpoint.url + "/metrics", timeout=2)
