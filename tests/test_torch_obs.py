"""The port's observability plane (``evox_tpu_torch/obs``) against the JAX
package's (``evox_tpu/obs``): the Prometheus text string for string, the
event JSON lines and the Chrome-trace schema (timestamps aside), the flight
signals and the trend helpers on the same inputs, the flight recorder's
bundles, and the device-memory introspection (empty on the CPU).

Tolerances: exact everywhere, except the flight recorder's means and
moment sums, which each framework adds in its own order (``SUM_RTOL``)."""

import json
import os
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: E402

from evox_tpu import obs as jobs  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402

from evox_tpu_torch import obs  # noqa: E402
from evox_tpu_torch.core import State  # noqa: E402

# Relative tolerance of a float32 sum or mean of up to 1024 terms added in
# another order than the JAX package's.
SUM_RTOL = 1e-5


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _drive(mod):
    """The same calls on a fresh registry of either package."""
    reg = mod.MetricsRegistry()
    reg.counter("evox_runner_retries_total", "Segment retries.").inc(3)
    reg.counter("evox_tenant_admitted_total", "Admitted.", tenant_id="a\"b\\c\nd").inc()
    reg.gauge("evox_device_bytes_in_use", "Live device HBM bytes in use.").set(1.5e9)
    reg.gauge("evox_runner_gens_per_sec", "", run_id="r1").set(float("nan"))
    reg.gauge("evox_x", "inf gauge").set(float("-inf"))
    reg.gauge("evox_big", "big").set(1e16)
    reg.gauge("evox_frac", "fraction").set(0.1 + 0.2)
    h = reg.histogram("evox_runner_segment_execute_seconds", "Blocked execution seconds per segment attempt.")
    for v in (0.001, 0.02, 0.3, 4.0, 50.0):
        h.observe(v)
    reg.histogram("evox_custom", "custom", buckets=(1, 2, 3), fn="segment[25]").observe(2)
    cursor: dict = {}
    reg.counter_sync(cursor, "evox_runner_generations_total", 10.0, "Generations.")
    reg.counter_sync(cursor, "evox_runner_generations_total", 25.0, "Generations.")
    return reg


def test_prometheus_text_equals_the_jax_packages_string_for_string(tmp_path):
    mine, theirs = _drive(obs), _drive(jobs)
    assert mine.to_prometheus() == theirs.to_prometheus()
    assert mine.snapshot().keys() == theirs.snapshot().keys()
    for k, v in mine.snapshot().items():
        w = theirs.snapshot()[k]
        assert (math.isnan(v) and math.isnan(w)) or v == w, k
    assert mine.heartbeat_payload().keys() == theirs.heartbeat_payload().keys()
    a = mine.fleet_payload()
    b = theirs.fleet_payload()
    assert json.dumps(a, sort_keys=True, default=repr) == json.dumps(b, sort_keys=True, default=repr)
    p = mine.write_prometheus(tmp_path / "m.prom")
    assert p.read_text() == theirs.to_prometheus()
    assert mine.remove_labeled("tenant_id", 'a"b\\c\nd') == theirs.remove_labeled("tenant_id", 'a"b\\c\nd') == 1


@pytest.mark.parametrize(
    "series",
    ['name', 'name{a="1"}', 'name{a="x\\"y",b="z\\\\w",c="l\\nm"}', 'evox_q{le="+Inf"}'],
)
def test_parse_series_and_refusals(series):
    assert obs.parse_series(series) == jobs.parse_series(series)
    mine, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for reg, mod in ((mine, obs), (theirs, jobs)):
        reg.counter("c")
        with pytest.raises(ValueError) as e:
            reg.gauge("c")
        reg.histogram("h", buckets=(1, 2))
        with pytest.raises(ValueError) as e2:
            reg.histogram("h", buckets=(1, 3))
        with pytest.raises(ValueError) as e3:
            reg.counter("c").inc(-1)
        reg.msgs = (str(e.value), str(e2.value), str(e3.value))
    assert mine.msgs == theirs.msgs


def test_default_registry_is_process_wide_and_resettable():
    a = obs.default_registry()
    assert obs.default_registry() is a
    b = obs.reset_default_registry()
    assert b is obs.default_registry() and b is not a


# ---------------------------------------------------------------------------
# events and traces
# ---------------------------------------------------------------------------


def _publish(mod, path):
    bus = mod.EventBus(run_id="run-1")
    ring = bus.add_sink(mod.RingBufferSink(8))
    lines = []
    bus.add_sink(mod.CallbackSink(lines.append, min_severity="warning"))
    bus.add_sink(mod.JsonlFileSink(path))
    bus.publish("checkpoint", "checkpoint written at generation 6", generation=6)
    bus.publish("runner", "segment (generations 7..11): attempt 1 failed", severity="warning", generation=7)
    bus.publish("restart", "restart #1 (rollback)", severity="warning", tenant_id="t", reasons=["x"], obj=object())
    return ring, lines


def _strip(record):
    record = dict(record)
    for k in ("t_wall", "t_mono"):
        assert isinstance(record.pop(k), float)
    if "obj" in record["payload"]:
        record["payload"] = {**record["payload"], "obj": "<object>"}
    return record


def test_event_json_lines_equal_the_jax_packages_timestamps_aside(tmp_path):
    ring, lines = _publish(obs, tmp_path / "port.jsonl")
    jring, jlines = _publish(jobs, tmp_path / "jax.jsonl")
    assert lines == jlines == ["segment (generations 7..11): attempt 1 failed", "restart #1 (rollback)"]
    mine = [_strip(json.loads(ln)) for ln in (tmp_path / "port.jsonl").read_text().splitlines()]
    theirs = [_strip(json.loads(ln)) for ln in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert mine == theirs and len(mine) == 3
    assert [_strip(e.to_json()) for e in ring.events()] == [_strip(e.to_json()) for e in jring.events()]


def test_event_process_index_is_the_rank_or_zero(monkeypatch):
    from evox_tpu_torch.obs import events

    monkeypatch.delenv("EVOX_TPU_FLEET_PROCESS_ID", raising=False)
    assert events._process_index() == 0  # no process group: 0, and none is created
    assert not torch.distributed.is_initialized() or torch.distributed.get_rank() == events._process_index()
    monkeypatch.setenv("EVOX_TPU_FLEET_PROCESS_ID", "3")
    assert events._process_index() == 3


def _trace(mod):
    tr = mod.Tracer(process_index=2)
    with tr.span("run", n_steps=5):
        tr.record("aot-compile", 1.0, 1.5, which="segment", chunk=25, cached=False)
        tr.record("execute", 1.5, 1.75, which="segment", chunk=25)
    tr.counter("device-memory", bytes_in_use=10, peak_bytes_in_use=None, junk="x")
    tr.counter("empty", junk=None)
    return tr.to_chrome_trace()


def test_chrome_trace_schema_equals_the_jax_packages():
    mine, theirs = _trace(obs), _trace(jobs)
    assert mine.keys() == theirs.keys()
    assert mine["otherData"].keys() == theirs["otherData"].keys()
    assert mine["otherData"]["schema"] == theirs["otherData"]["schema"] == obs.OBS_SCHEMA_VERSION
    assert mine["otherData"]["producer"] == "evox_tpu_torch.obs"

    def shape(events):
        return [(e["name"], e["ph"], e["pid"], sorted(e), e["args"]) for e in events]

    assert shape(mine["traceEvents"]) == shape(theirs["traceEvents"])
    span = next(e for e in mine["traceEvents"] if e["name"] == "aot-compile")
    assert span["dur"] == pytest.approx(0.5e6)


def test_profiler_window_exports_a_chrome_trace(tmp_path):
    tr = obs.Tracer(profile_segment=1, profile_dir=tmp_path / "prof")
    with tr.maybe_profile(0):
        pass
    with tr.maybe_profile(1):
        torch.ones(4).sum()
    assert tr.profiled_segments == [1]
    trace = json.loads((tmp_path / "prof" / "segment_00001.trace.json").read_text())
    assert "traceEvents" in trace


def test_observability_facade_and_resolve(tmp_path):
    rec = obs.FlightRecorder(tmp_path / "pm")
    plane = obs.Observability(run_id="r", events_path=tmp_path / "e.jsonl", flight=rec, tracer=obs.Tracer())
    assert rec.run_id == "r" and plane.ring is not None
    plane.event("runner", "hello", generation=1)
    plane.counter("c").inc()
    with plane.span("s"):
        pass
    assert plane.ring.events()[0].message == "hello"
    from evox_tpu_torch.obs.plane import resolve_obs

    assert resolve_obs(False) is None
    assert isinstance(resolve_obs(None, run_id="x"), obs.Observability)
    assert resolve_obs(plane) is plane


# ---------------------------------------------------------------------------
# flight signals
# ---------------------------------------------------------------------------


def _flight_states(seed=0, sigma=False):
    g = np.random.default_rng(seed)
    pop = g.standard_normal((64, 16)).astype(np.float32) * 3
    fit = g.standard_normal(64).astype(np.float32)
    vel = g.standard_normal((64, 16)).astype(np.float32)
    algo = {"pop": pop, "fit": fit, "velocity": vel}
    if sigma:
        algo["sigma"] = np.abs(g.standard_normal(16)).astype(np.float32)
    mon = {"num_nonfinite": np.int32(4), "num_shard_quarantines": np.int32(1)}
    port = State(algorithm=State(**{k: torch.from_numpy(v) for k, v in algo.items()}),
                 monitor=State(**{k: torch.tensor(v) for k, v in mon.items()}))
    jax_state = JState(algorithm=JState(**{k: jnp.asarray(v) for k, v in algo.items()}),
                       monitor=JState(**{k: jnp.asarray(v) for k, v in mon.items()}))
    return port, jax_state


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("sigma", [False, True])
def test_flight_signals_and_finalize_row_equal_the_jax_packages(raw, sigma):
    port, jax_state = _flight_states(sigma=sigma)
    mine = {k: float(v) for k, v in obs.flight_signals(port, raw=raw).items()}
    theirs = {k: float(v) for k, v in jobs.flight_signals(jax_state, raw=raw).items()}
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k in ("mean_fitness", "_pop_sum", "_pop_sumsq", "pop_diversity"):
            assert mine[k] == pytest.approx(theirs[k], rel=SUM_RTOL), k
        else:
            assert mine[k] == theirs[k], k
    if raw:
        # The host finish is pure float math: the same function of the sums.
        assert obs.finalize_row(theirs) == jobs.finalize_row(theirs)
        fin = obs.finalize_row(mine)
        assert fin["pop_diversity"] == pytest.approx(jobs.finalize_row(theirs)["pop_diversity"], rel=SUM_RTOL)
        assert not any(k.startswith("_") for k in fin)


def test_flight_signals_fall_back_to_the_monitors_latest_fitness():
    fit = np.arange(5, dtype=np.float32)
    port = State(algorithm=State(mean=torch.zeros(3)), monitor=State(latest_fitness=torch.from_numpy(fit)))
    jax_state = JState(algorithm=JState(mean=jnp.zeros(3)), monitor=JState(latest_fitness=jnp.asarray(fit)))
    assert {k: float(v) for k, v in obs.flight_signals(port).items()} == {
        k: float(v) for k, v in jobs.flight_signals(jax_state).items()
    }


ROWS = [
    {"generation": 1, "best_fitness": 5.0},
    {"generation": 2, "best_fitness": 4.0},
    {"generation": 3, "best_fitness": float("nan")},
    {"generation": 4, "best_fitness": 2.5},
    {"generation": 6, "best_fitness": 1.0, "other": 1.0},
    {"generation": 7, "best_fitness": float("inf")},
]


@pytest.mark.parametrize("window", [None, 2, 3, 6])
def test_trend_helpers_equal_the_jax_packages(window):
    assert obs.window_slope(ROWS, "best_fitness", window=window) == jobs.window_slope(ROWS, "best_fitness", window=window)
    assert obs.window_ema(ROWS, "best_fitness", window=window) == jobs.window_ema(ROWS, "best_fitness", window=window)
    for n in (1, 3, 10):
        a = obs.last_n(ROWS, "best_fitness", n)
        b = jobs.last_n(ROWS, "best_fitness", n)
        assert np.array_equal(np.array(a), np.array(b), equal_nan=True)
    with pytest.raises(ValueError):
        obs.last_n(ROWS, "x", 0)


def test_flight_recorder_rows_storm_and_bundles(tmp_path):
    def drive(mod, d):
        rec = mod.FlightRecorder(d, window=4, quarantine_storm=3, run_id="r")
        rec.record_rows({"best_fitness": [3.0, 2.0, 1.0], "num_nonfinite": [0, 0, 1]}, 3, start_generation=5)
        rec.record_rows({"best_fitness": [0.5, 0.4], "num_nonfinite": [4, 9]}, 1, start_generation=8)
        bus = mod.EventBus(run_id="r")
        bus.add_sink(rec)
        bus.publish("restart", "restart #1", severity="warning")
        bus.publish("health", "fine", severity="info")
        return rec

    mine, theirs = drive(obs, tmp_path / "p"), drive(jobs, tmp_path / "j")
    assert mine.rows() == theirs.rows()
    assert [b.name for b in mine.bundles] == [b.name for b in theirs.bundles]
    for a, b in zip(mine.bundles, theirs.bundles):
        assert (a / "flight.jsonl").read_text() == (b / "flight.jsonl").read_text()
        ma = json.loads((a / "manifest.json").read_text())
        mb = json.loads((b / "manifest.json").read_text())
        for m in (ma, mb):
            m.pop("created_wall")
            if m.get("trigger"):
                m["trigger"].pop("t_wall")
                m["trigger"].pop("t_mono")
        assert ma == mb


def test_device_memory_introspection_is_empty_on_the_cpu():
    reg = obs.MetricsRegistry()
    assert obs.xla.device_memory_stats("cpu") is None
    assert obs.xla.publish_device_memory_gauges(reg, "cpu") is None
    assert obs.xla.program_analysis(object()) == {}
    obs.xla.publish_program_gauges(reg, "segment[25]", {})
    obs.xla.publish_program_gauges(reg, "segment[25]", {"flops": 2.0})
    assert reg.snapshot() == {'evox_segment_flops{fn="segment[25]"}': 2.0}


def test_not_ported_obs_names_raise_by_name():
    # The fleet aggregator came with the fleet layer (13.7): exported now.
    assert "FleetAggregator" in obs.__all__ and obs.FleetAggregator.__module__ == "evox_tpu_torch.obs.aggregate"
    assert not getattr(obs, "_NOT_PORTED", ())
    for name in ("IntrospectionEndpoint", "SLO", "SLOStatus", "SLOTracker", "default_slos"):
        assert name in obs.__all__ and getattr(obs, name).__module__.startswith("evox_tpu_torch.obs.")


# ---------------------------------------------------------------------------
# obs/xla.py's bench half: the roofline math, the cost readers and writer
# ---------------------------------------------------------------------------

ROOFLINE_GRID = [
    # (flops_per_gen, bytes_per_gen, gen_per_sec, hbm_gbps, peak_tflops)
    (0.0, 0.0, 1.0, 3350.0, 67.0),
    (1.6e9, 1.2e9, 530.7, 3350.0, 67.0),
    (2.0e12, 1.0e6, 12.5, 3350.0, 67.0),
    (3.3e8, 4.0e9, 0.25, 819.0, 197.0),
    (1.0, 3.0, 1e6, 1.5, 0.001),
    (7.7e10, 7.7e10, 33.3333, 2039.0, 19.5),
]


@pytest.mark.parametrize("flops,nbytes,gps,hbm,tflops", ROOFLINE_GRID)
def test_roofline_equals_jax(flops, nbytes, gps, hbm, tflops):
    from evox_tpu.obs import xla as jxla

    kw = dict(flops_per_gen=flops, bytes_per_gen=nbytes, gen_per_sec=gps, hbm_gbps=hbm, peak_tflops=tflops)
    assert obs.xla.roofline(**kw) == jxla.roofline(**kw)


@pytest.mark.parametrize("cost", [
    {"flops": 4.0e9, "bytes accessed": 2.0e9, "n_steps": 50},
    {"flops": 4.0e9, "bytes accessed": 2.0e9},
    {"flops": 1.0, "bytes accessed": 0.0, "n_steps": 0},
    {"bytes accessed": 8.0e8, "transcendentals": 3.0},
])
@pytest.mark.parametrize("gps", [1.0, 77.7])
def test_roofline_from_cost_equals_jax(cost, gps):
    from evox_tpu.obs import xla as jxla

    peaks = dict(hbm_gbps=3350.0, peak_tflops=67.0)
    assert obs.xla.roofline_from_cost(cost, gps, **peaks) == jxla.roofline_from_cost(cost, gps, **peaks)


def test_publish_roofline_gauges_equals_jax():
    from evox_tpu.obs import xla as jxla

    mine, theirs = obs.MetricsRegistry(), jobs.MetricsRegistry()
    for flops, nbytes, gps, hbm, tflops in ROOFLINE_GRID[1:3]:
        kw = dict(flops_per_gen=flops, bytes_per_gen=nbytes, gen_per_sec=gps, hbm_gbps=hbm, peak_tflops=tflops)
        obs.xla.publish_roofline_gauges(mine, f"segment[{gps}]", obs.xla.roofline(**kw))
        jxla.publish_roofline_gauges(theirs, f"segment[{gps}]", jxla.roofline(**kw))
    obs.xla.publish_roofline_gauges(mine, "partial", {"achieved_GBps": 1.0, "pct_of_flop_peak": None})
    jxla.publish_roofline_gauges(theirs, "partial", {"achieved_GBps": 1.0, "pct_of_flop_peak": None})
    assert mine.snapshot() == theirs.snapshot() and len(mine.snapshot()) == 9


class _Compiled:
    """An object offering JAX's AOT-compiled introspection methods."""

    class _Memory:
        argument_size_in_bytes = 4096
        output_size_in_bytes = 1024
        temp_size_in_bytes = 512
        generated_code_size_in_bytes = 256
        alias_size_in_bytes = 1024

    def cost_analysis(self):
        return [{"flops": 20.0, "bytes accessed": 16.0, "transcendentals": 2.0, "utilization0{}": 1.0}]

    def memory_analysis(self):
        return self._Memory()


def test_cost_readers_equal_jax_and_a_captured_graph_has_none(tmp_path):
    """On an object with JAX's methods the readers and the writer give the
    JAX package's results and files, byte for byte; a captured graph's
    container and ``object()`` have no cost model: ``None``, an empty
    analysis, no file, no error."""
    from evox_tpu.obs import xla as jxla

    from evox_tpu_torch.utils import graph

    compiled = _Compiled()
    assert obs.xla.program_costs(compiled) == jxla.program_costs(compiled)
    assert obs.xla.program_memory(compiled) == jxla.program_memory(compiled)
    assert obs.xla.program_analysis(compiled) == jxla.program_analysis(compiled)
    extra = {"n_steps": 7}
    mine = obs.xla.write_cost_analysis(compiled, str(tmp_path / "port"), extra=extra)
    theirs = jxla.write_cost_analysis(compiled, str(tmp_path / "jax"), extra=extra)
    assert mine == theirs
    for name in ("cost_analysis.json", "memory_analysis.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for nothing in (graph.Cache(), object()):
        assert obs.xla.program_costs(nothing) is None and obs.xla.program_memory(nothing) is None
        assert obs.xla.program_analysis(nothing) == {}
        assert obs.xla.write_cost_analysis(nothing, str(tmp_path / "none")) is None
    assert not (tmp_path / "none").exists()
    # A profile directory that cannot be made: swallowed, as in JAX.
    (tmp_path / "file").write_text("")
    assert obs.xla.write_cost_analysis(compiled, str(tmp_path / "file"), extra=extra) == theirs


def test_peaks_are_the_h100s_and_the_environment_overrides_them(monkeypatch):
    import importlib

    assert "EVOX_TPU_HBM_PEAK_GBPS" not in os.environ and "EVOX_TPU_FLOP_PEAK_TFLOPS" not in os.environ
    assert (obs.xla.DEFAULT_HBM_PEAK_GBPS, obs.xla.DEFAULT_FLOP_PEAK_TFLOPS) == (3350.0, 67.0)
    got = obs.xla.roofline(flops_per_gen=6.7e10, bytes_per_gen=3.35e9, gen_per_sec=100.0)
    assert (got["pct_of_hbm_peak"], got["pct_of_flop_peak"]) == (10.0, 10.0)
    monkeypatch.setenv("EVOX_TPU_HBM_PEAK_GBPS", "819")
    monkeypatch.setenv("EVOX_TPU_FLOP_PEAK_TFLOPS", "197")
    try:
        importlib.reload(obs.xla)
        assert (obs.xla.DEFAULT_HBM_PEAK_GBPS, obs.xla.DEFAULT_FLOP_PEAK_TFLOPS) == (819.0, 197.0)
    finally:
        monkeypatch.delenv("EVOX_TPU_HBM_PEAK_GBPS")
        monkeypatch.delenv("EVOX_TPU_FLOP_PEAK_TFLOPS")
        importlib.reload(obs.xla)
    assert obs.xla.DEFAULT_HBM_PEAK_GBPS == 3350.0
