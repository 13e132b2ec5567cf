"""The port's SLO trackers (``evox_tpu_torch/obs/slo.py``) and introspection
endpoint (``evox_tpu_torch/obs/endpoint.py``) against the JAX package's, on
the CPU.

Both modules are standard library in either package, so the comparisons
are exact: with an injected clock the same observations give the same burn
rates, budgets, ``describe()`` rows and Prometheus text (through each
package's own ``MetricsRegistry``), and the same providers give the same
routes, status codes and bodies.  The hand-computed fixtures are the JAX
package's own (``tests/test_telemetry.py``)."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from evox_tpu import control as jcontrol  # noqa: E402
from evox_tpu import obs as jobs  # noqa: E402

from evox_tpu_torch import control, obs  # noqa: E402

PACKAGES = {"jax": (jobs, jcontrol), "torch": (obs, control)}


def _get(url, method="GET", body=None):
    req = urllib.request.Request(url, data=body, method=method)
    try:
        resp = urllib.request.urlopen(req, timeout=10)
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


# ---------------------------------------------------------------------------
# SLO burn-rate math, against the JAX package's on the same observations
# ---------------------------------------------------------------------------


def _latency_fixture(o):
    slo = o.SLO("lat", "segment_seconds", target=0.9, threshold=1.0, window_seconds=100.0)
    tracker = o.SLOTracker([slo], clock=lambda: 0.0)
    for i in range(16):
        tracker.observe("segment_seconds", 0.5, at=float(i))
    for i in range(4):
        tracker.observe("segment_seconds", 2.0, at=float(16 + i))
    return [
        (st.good, st.bad, st.burn_rate, st.budget_remaining)
        for st in (tracker.status(slo, now=t) for t in (20.0, 116.5, 1000.0))
    ]


def _floor_fixture(o):
    floor = o.SLO("gens", "tenant_gens_per_sec", target=0.5, threshold=10.0, comparison="ge", window_seconds=60.0)
    adm = o.SLO("adm", "admission", target=0.5, window_seconds=60.0)
    tracker = o.SLOTracker([floor, adm], clock=lambda: 0.0)
    tracker.observe("tenant_gens_per_sec", 12.0, at=0.0)
    tracker.observe("tenant_gens_per_sec", 8.0, at=1.0)
    tracker.record("admission", True, at=0.0)
    tracker.record("admission", False, at=1.0, n=3)
    worst = tracker.worst(now=2.0)
    return (
        [(s.good, s.bad, s.burn_rate) for s in tracker.statuses(now=2.0)],
        worst.slo.name,
        tracker.worst(tenant_class="nonexistent", now=2.0),
        tracker.describe(now=2.0),
    )


def _publish_fixture(o):
    reg = o.MetricsRegistry()
    tracker = o.SLOTracker(o.default_slos(window_seconds=60.0, recovery_seconds=5.0), registry=reg,
                           clock=lambda: 0.0)
    tracker.observe("segment_seconds", 10.0, at=0.0)
    tracker.observe("tenant_gens_per_sec", 3.0, at=0.5)
    tracker.record("admission", True, at=0.5, n=7)
    tracker.observe("recovery_replay_seconds", 1.0, tenant_class="premium", at=0.5)
    tracker.publish(now=1.0)
    return reg.snapshot(), reg.to_prometheus(), tracker.describe(now=1.0)


@pytest.mark.parametrize("fixture", [_latency_fixture, _floor_fixture, _publish_fixture],
                         ids=["latency", "floor_and_prejudged", "publish"])
def test_slo_fixtures_match_jax(fixture):
    assert fixture(obs) == fixture(jobs)


def test_slo_hand_computed_fixture():
    (now20, now116, empty) = _latency_fixture(obs)
    # 4 bad / 20 total = 20% error rate against a 10% budget: burn 2.0.
    assert now20[:2] == (16, 4) and now20[2] == pytest.approx(2.0) and now20[3] == pytest.approx(-1.0)
    # Window expiry: at t=116.5 only events from t>16.5 remain (3 bad).
    assert now116[:2] == (0, 3) and now116[2] == pytest.approx(10.0)
    assert empty == (0, 0, None, None)
    statuses, worst, nothing, rows = _floor_fixture(obs)
    assert statuses[0][:2] == (1, 1) and statuses[0][2] == pytest.approx(1.0)
    assert statuses[1][:2] == (1, 3) and worst == "adm" and nothing is None
    assert [r["slo"] for r in rows] == ["gens", "adm"]
    snap = _publish_fixture(obs)[0]
    key = 'evox_slo_burn_rate{slo="segment-latency",tenant_class="standard",window="1m"}'
    assert snap[key] == pytest.approx(100.0)
    assert snap[key.replace("burn_rate", "budget_remaining")] == pytest.approx(-99.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_slo_validation(pkg):
    o, _ = PACKAGES[pkg]
    with pytest.raises(ValueError, match="target"):
        o.SLO("x", "s", target=1.5)
    with pytest.raises(ValueError, match="window_seconds"):
        o.SLO("x", "s", target=0.9, window_seconds=0)
    with pytest.raises(ValueError, match="comparison"):
        o.SLO("x", "s", target=0.9, comparison="eq")
    with pytest.raises(ValueError, match="pre-judged"):
        o.SLO("x", "s", target=0.9).good(1.0)
    with pytest.raises(ValueError, match="duplicate"):
        o.SLOTracker([o.SLO("x", "s", target=0.9, threshold=1.0), o.SLO("x", "t", target=0.9, threshold=1.0)])
    assert [o.SLO("w", "s", target=0.5, window_seconds=w).window_label for w in (7200.0, 120.0, 45.0)] == [
        "2h", "2m", "45s"]


def _controller_slo_evidence(o, c):
    tracker = o.SLOTracker([o.SLO("lat", "segment_seconds", target=0.9, threshold=1.0, window_seconds=60.0)],
                           clock=lambda: 0.0)
    for i in range(10):
        tracker.observe("segment_seconds", 5.0, at=float(i))
    ctrl = c.Controller(brownout_burn=2.0, slo_wait_seconds=100.0, slo=tracker)
    action = ctrl.brownout(pressure=0.0, active=False, enter=0.9)
    budget = ctrl.shed_threshold(queue_budget=8, segment_seconds=1.0, lanes=2, tenant_class="standard")
    return action, budget, [d.to_manifest() for d in ctrl.decisions]


def test_controller_slo_evidence_matches_jax():
    """The controller's ``slo=`` input: the worst burn rate rides the
    brown-out evidence and an exhausted budget halves the shed threshold,
    journaled alike in both packages."""
    mine = _controller_slo_evidence(obs, control)
    assert mine == _controller_slo_evidence(jobs, jcontrol)
    action, budget, decisions = mine
    assert action == "enter" and budget == 4
    assert decisions[0]["evidence"]["burn_rate"] == pytest.approx(10.0)
    assert decisions[1]["evidence"]["budget_remaining"] == pytest.approx(-9.0)
    assert control.decide_shed(decisions[1]["evidence"]) == 4


def test_controller_slo_failure_degrades_not_crashes():
    class Broken:
        def worst(self, **kw):
            raise RuntimeError("boom")

    ctrl = control.Controller(brownout_burn=2.0, slo=Broken())
    assert ctrl.brownout(pressure=0.99, active=False, enter=0.9) == "hold"
    assert ctrl.degraded and [d.kind for d in ctrl.decisions] == ["degrade"]


# ---------------------------------------------------------------------------
# the introspection endpoint, against the JAX package's
# ---------------------------------------------------------------------------

ROUTES = [("GET", "/metrics"), ("GET", "/healthz"), ("GET", "/statusz"), ("GET", "/flightz/a"),
          ("GET", "/flightz/unknown"), ("GET", "/flightz/"), ("GET", "/nope"), ("GET", "/"),
          ("POST", "/metrics"), ("DELETE", "/api/x"), ("GET", "/api/x")]


def _providers(o, healthy, broken_statusz, api):
    reg = o.MetricsRegistry()
    reg.counter("c_total").inc(2)
    reg.histogram("h_seconds", buckets=[0.1, 1.0]).observe(0.5)

    def statusz():
        if broken_statusz:
            raise RuntimeError("provider exploded")
        return {"tenants": {"a": {"status": "running"}}, "generation": 7}

    def handler(method, path, headers, body):
        return 201, "application/json", json.dumps({"method": method, "path": path, "body": body.decode()}), {
            "X-Api": "1"}

    kw = dict(api=handler) if api else {}
    return reg, dict(
        registry=reg, instrument=reg, statusz=statusz,
        healthz=lambda: (healthy, {"dead": [] if healthy else [1], "note": "fleet"}),
        flight=lambda tid: [{"generation": 1, "best_fitness": 0.5}] if tid == "a" else None, **kw)


def _serve(o, healthy, broken_statusz, api):
    reg, kw = _providers(o, healthy, broken_statusz, api)
    ep = o.IntrospectionEndpoint(**kw).start()
    try:
        assert ep.started and ep.port > 0 and ep.url.startswith("http://127.0.0.1:")
        out = [_get(ep.url + path, method, b"{}" if method != "GET" else None) for method, path in ROUTES]
        # The scrape counters the endpoint published (after its scrapes).
        out.append(_get(ep.url + "/metrics"))
        return out, {k: v for k, v in reg.snapshot().items() if k.startswith("evox_endpoint_")}
    finally:
        ep.stop()


@pytest.mark.parametrize("healthy, broken_statusz, api", [(True, False, False), (False, True, False),
                                                          (True, False, True)],
                         ids=["healthy", "unhealthy_broken_statusz", "api"])
def test_endpoint_routes_match_jax(healthy, broken_statusz, api):
    mine = _serve(obs, healthy, broken_statusz, api)
    assert mine == _serve(jobs, healthy, broken_statusz, api)
    responses, counters = mine
    by = dict(zip(ROUTES, responses))
    assert by[("GET", "/metrics")][0] == 200 and "c_total 2" in by[("GET", "/metrics")][2]
    assert by[("GET", "/healthz")][0] == (200 if healthy else 503)
    assert json.loads(by[("GET", "/healthz")][2])["healthy"] is healthy
    if broken_statusz:
        # A broken provider is a 500, and the server keeps serving.
        assert by[("GET", "/statusz")][0] == 500 and "provider exploded" in by[("GET", "/statusz")][2]
    assert json.loads(by[("GET", "/flightz/a")][2])["rows"] == [{"generation": 1, "best_fitness": 0.5}]
    assert by[("GET", "/flightz/unknown")][0] == 404 and by[("GET", "/nope")][0] == 404
    assert by[("POST", "/metrics")][0] == 405
    assert by[("GET", "/api/x")][0] == (201 if api else 404)
    assert counters['evox_endpoint_requests_total{path="/metrics"}'] == 3


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_endpoint_without_providers_and_stop(pkg):
    o, _ = PACKAGES[pkg]
    ep = o.IntrospectionEndpoint().start()
    assert ep.start() is ep  # idempotent
    try:
        assert _get(ep.url + "/healthz")[:2] == (200, "application/json")
        assert json.loads(_get(ep.url + "/healthz")[2]) == {"healthy": True}
        assert _get(ep.url + "/metrics")[0] == 404 and _get(ep.url + "/statusz")[0] == 404
        assert _get(ep.url + "/flightz/a")[0] == 404
    finally:
        ep.stop()
    ep.stop()
    assert not ep.started
    # Stopped: the port refuses.
    with pytest.raises(OSError):
        urllib.request.urlopen(ep.url + "/metrics", timeout=2)


def test_endpoint_concurrent_scrapes_are_internally_consistent():
    """Parallel scrapes during rapid registry mutation each see an
    internally-consistent snapshot (cumulative buckets, ``_count`` equal
    to the +Inf bucket, counters never going backwards)."""
    reg = obs.MetricsRegistry()
    ep = obs.IntrospectionEndpoint(registry=reg).start()
    stop = threading.Event()
    errors: list[str] = []

    def mutate():
        i = 0
        while not stop.is_set():
            reg.counter("m_total").inc()
            reg.histogram("m_seconds", buckets=[0.1, 1.0, 10.0]).observe([0.05, 0.5, 5.0, 50.0][i % 4])
            i += 1

    def scrape():
        last = 0.0
        for _ in range(25):
            status, _, text = _get(ep.url + "/metrics")
            if status != 200:
                errors.append(f"status {status}")
                return
            snap = {}
            for line in text.splitlines():
                if line and not line.startswith("#"):
                    series, value = line.rsplit(" ", 1)
                    snap[series] = float(value)
            if snap.get("m_total", 0.0) < last:
                errors.append("counter went backwards")
            last = snap.get("m_total", 0.0)
            counts = [v for k, v in snap.items() if k.startswith("m_seconds_bucket")]
            if counts != sorted(counts) or (counts and counts[-1] != snap.get("m_seconds_count")):
                errors.append("inconsistent histogram")

    mutator = threading.Thread(target=mutate, daemon=True)
    scrapers = [threading.Thread(target=scrape) for _ in range(3)]
    mutator.start()
    try:
        for t in scrapers:
            t.start()
        for t in scrapers:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in scrapers)
    finally:
        stop.set()
        mutator.join(timeout=10)
        ep.stop()
    assert not errors, errors


def test_slo_and_endpoint_modules_import_no_jax():
    import ast
    from pathlib import Path

    root = Path(obs.__file__).resolve().parent.parent
    for f in [root / "obs" / "slo.py", root / "obs" / "endpoint.py"]:
        for node in ast.walk(ast.parse(f.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert not (n.split(".")[0] in ("jax", "evox_tpu")), (f, n)
