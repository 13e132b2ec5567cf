"""The port's multi-host fleet layer against the JAX package's (counterpart of
``tests/test_multihost.py``): ``parallel/multihost.py``,
``resilience/fleet.py``, the runner's ``primary=``/``heartbeat=`` and
``FaultyProblem``'s process faults.

* Against the JAX package, exactly: manifests of both ``FleetTopology``
  classes (each loading in the other), ``WorkerSpec.env()``, heartbeat
  files (a beat of either package read by the other's
  ``read_heartbeats``), ``FleetHealth`` verdicts and reasons on the same
  files and clock, ``plan_relaunch``, the ``FleetStats`` of the same
  scripted fleet (both supervisors driven by one fake worker factory), and
  the process faults' validation messages.
* The runner's fleet arguments against the port itself, bit for bit.
* Real gloo fleets on the CPU through ``tests/test_torch_fleet_worker.py``
  (each bounded by the supervisor's ``attempt_timeout``): a 2-process
  fleet that loses rank 1 to ``SIGKILL`` and finishes on 1, bit-equal to
  an uninterrupted 1-process fleet and to the same run in this process;
  and a metrics fleet whose aggregated counters equal the sum of its
  ranks' registries.  The JAX package's three slow acceptances (4 -> 3 ->
  2 chaos, straggler, partition) are here too, marked slow as there.
"""

import errno
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import evox_tpu.parallel.multihost as jmultihost  # noqa: E402
import evox_tpu.resilience.fleet as jfleet  # noqa: E402
from evox_tpu.resilience import FaultyProblem as JFaultyProblem  # noqa: E402
from evox_tpu.resilience import MeshTopology as JMeshTopology  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import State  # noqa: E402
from evox_tpu_torch.parallel import (  # noqa: E402
    FleetHealth,
    FleetTopology,
    HostHeartbeat,
    bootstrap_fleet,
    fleet_barrier,
    gather_replicated,
    init_multi_host,
    is_primary,
    make_pop_mesh,
    multihost,
    read_heartbeats,
)
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.resilience import (  # noqa: E402
    EX_PREEMPTED,
    FaultyProblem,
    FleetError,
    FleetSupervisor,
    MeshTopology,
    ResilientRunner,
    RetryPolicy,
    WorkerSpec,
    free_coordinator_port,
    scan_checkpoints,
)
from evox_tpu_torch.utils import ReadOnlyCheckpointStore, graph, save_state  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_fleet_worker as worker  # noqa: E402

DIM = 4
LB = -5.0 * torch.ones(DIM)
UB = 5.0 * torch.ones(DIM)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _no_process_group():
    """No process group from another test file, and none left behind (the
    in-process reference sets up a one-rank gloo group)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# FleetTopology: the process-level world record
# ---------------------------------------------------------------------------

_TOPO = dict(axis_names=("pop",), axis_sizes=(4,), device_kind="cpu", platform="cpu", num_devices=4,
             num_processes=4, process_index=2, coordinator="10.0.0.1:8476", attempt=1)


def test_fleet_topology_manifest_roundtrip():
    topo = FleetTopology(**_TOPO)
    entry = json.loads(json.dumps(topo.to_manifest()))
    back = FleetTopology.from_manifest(entry)
    assert back == topo
    assert not back.primary
    assert "process 2/4" in back.describe()
    assert "10.0.0.1:8476" in back.describe()
    # JAX's keys exactly, and each package's entry loads in the other.
    theirs = jmultihost.FleetTopology(**_TOPO)
    assert entry == json.loads(json.dumps(theirs.to_manifest()))
    assert FleetTopology.from_manifest(theirs.to_manifest()) == topo
    assert jmultihost.FleetTopology.from_manifest(entry) == theirs


def test_fleet_topology_from_plain_mesh_manifest():
    fields = dict(axis_names=("pop",), axis_sizes=(8,), device_kind="cpu", platform="cpu", num_devices=8,
                  num_processes=1)
    for entry in (MeshTopology(**fields).to_manifest(), JMeshTopology(**fields).to_manifest()):
        topo = FleetTopology.from_manifest(entry)
        assert (topo.process_index, topo.coordinator, topo.attempt) == (0, "", 0)
        assert topo.primary


def test_fleet_topology_current_single_process():
    topo = FleetTopology.current(device="cpu")
    assert topo.num_processes == 1
    assert topo.process_index == 0
    assert topo.primary
    assert (topo.platform, topo.device_kind) == ("cpu", "cpu")
    assert "process 0/1" not in topo.describe()
    assert " via " not in topo.describe()


def test_fleet_topology_single_process_touches_no_backend(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_name", refuse)
    topo = FleetTopology.single_process()
    assert topo.num_processes == 1 and topo.num_devices == 0
    assert topo.primary
    assert topo.to_manifest() == jmultihost.FleetTopology.single_process().to_manifest()


# ---------------------------------------------------------------------------
# bootstrap + collectives: degenerate single-process paths
# ---------------------------------------------------------------------------


def test_bootstrap_fleet_noop_without_fleet(monkeypatch):
    for var in (multihost.FLEET_ENV_COORDINATOR, multihost.FLEET_ENV_NUM_PROCESSES,
                multihost.FLEET_ENV_PROCESS_ID, multihost.FLEET_ENV_ATTEMPT):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "init_multi_host", lambda *a, **k: pytest.fail("joined a group"))
    assert bootstrap_fleet() == FleetTopology.single_process()
    assert not torch.distributed.is_initialized()


def test_bootstrap_fleet_noop_on_empty_coordinator(monkeypatch):
    monkeypatch.setenv(multihost.FLEET_ENV_COORDINATOR, "")
    monkeypatch.setenv(multihost.FLEET_ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(multihost.FLEET_ENV_PROCESS_ID, "0")
    monkeypatch.setenv(multihost.FLEET_ENV_ATTEMPT, "3")
    monkeypatch.setattr(multihost, "init_multi_host", lambda *a, **k: pytest.fail("joined a group"))
    assert bootstrap_fleet() == FleetTopology.single_process()


def test_bootstrap_fleet_auto_hands_rendezvous_to_torchrun(monkeypatch):
    """``auto=True`` joins through the ``torchrun`` environment
    (``init_method="env://"``: no address, world size or rank passed)
    instead of degenerating to one process; the default stays a no-op.
    The environment contract and ``key_impl`` reach the port's join."""
    for var in (multihost.FLEET_ENV_COORDINATOR, multihost.FLEET_ENV_NUM_PROCESSES,
                multihost.FLEET_ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    # Recorded (and restored) by monkeypatch: bootstrap_fleet publishes it.
    monkeypatch.setenv("EVOX_TPU_KEY_IMPL", "")
    calls = []

    def fake_init(*args, **kwargs):
        calls.append((args, kwargs))
        return torch.device("cpu")

    monkeypatch.setattr(multihost, "init_multi_host", fake_init)
    topo = bootstrap_fleet(auto=True, device="cpu")
    assert calls == [((None, None, None), {"device": "cpu", "timeout": None})]
    assert topo.num_processes == 1
    calls.clear()
    assert bootstrap_fleet() == FleetTopology.single_process()
    assert calls == []
    monkeypatch.setenv(multihost.FLEET_ENV_COORDINATOR, "127.0.0.1:1234")
    monkeypatch.setenv(multihost.FLEET_ENV_NUM_PROCESSES, "4")
    monkeypatch.setenv(multihost.FLEET_ENV_PROCESS_ID, "2")
    monkeypatch.setenv(multihost.FLEET_ENV_ATTEMPT, "1")
    topo = bootstrap_fleet(device="cpu", initialization_timeout=7.0, key_impl="rbg")
    assert calls == [(("127.0.0.1:1234", 4, 2), {"device": "cpu", "timeout": 7.0})]
    assert (topo.coordinator, topo.attempt) == ("127.0.0.1:1234", 1)
    assert os.environ["EVOX_TPU_KEY_IMPL"] == "rbg"


def test_single_process_collective_helpers_are_noops():
    assert is_primary() and jmultihost.is_primary()
    fleet_barrier()
    tree = {"a": torch.arange(3), "b": np.ones(2)}
    assert gather_replicated(tree) is tree


def test_gloo_group_joined_on_the_card_gives_a_mesh_on_the_card(monkeypatch, tmp_path):
    """Ranks that outnumber the host's cards join a gloo group through
    ``init_multi_host(device="cuda")``; ``make_pop_mesh()`` with its
    default device then puts the mesh on the rank's card, not on the
    group's CPU default.  A gloo group the port did not join on a card
    keeps its mesh on the CPU.  CUDA is mocked: the 2-rank group is a
    1-rank gloo group over a file store."""
    dist = torch.distributed
    joined: dict = {}
    real_init = dist.init_process_group

    def one_rank_init(**kwargs):
        joined.update(kwargs)
        real_init(backend=kwargs["backend"], init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        m.setattr(torch.cuda, "set_device", lambda device: None)
        m.setattr(dist, "init_process_group", one_rank_init)
        m.delenv("LOCAL_RANK", raising=False)
        m.delenv("LOCAL_WORLD_SIZE", raising=False)
        try:
            dev = init_multi_host("127.0.0.1:1", num_processes=2, process_id=1, device="cuda")
            assert dev == torch.device("cuda", 0)
            assert joined["backend"] == "gloo" and "device_id" not in joined
            assert dist.get_backend() == "gloo"
            assert make_pop_mesh().device == torch.device("cuda", 0)
        finally:
            dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store2'}", rank=0, world_size=1)
    try:
        assert make_pop_mesh().device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_worker_spec_env_contract():
    fields = dict(process_id=3, num_processes=4, coordinator="127.0.0.1:9999", attempt=2,
                  heartbeat_dir="/tmp/hb", checkpoint_dir="/tmp/ck")
    env = WorkerSpec(**fields).env()
    assert env == jfleet.WorkerSpec(**fields).env()
    assert env[multihost.FLEET_ENV_COORDINATOR] == "127.0.0.1:9999"
    assert env[multihost.FLEET_ENV_NUM_PROCESSES] == "4"
    assert env[multihost.FLEET_ENV_PROCESS_ID] == "3"
    assert env[multihost.FLEET_ENV_HEARTBEAT_DIR] == "/tmp/hb"
    assert env[multihost.FLEET_ENV_ATTEMPT] == "2"
    for name in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID", "HEARTBEAT_DIR", "ATTEMPT"):
        assert getattr(multihost, f"FLEET_ENV_{name}") == getattr(jmultihost, f"FLEET_ENV_{name}")


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------


def test_heartbeat_roundtrip(tmp_path):
    hb = HostHeartbeat(tmp_path / "mine", 3)
    hb.beat(generation=5, segment_seconds=0.25, deadline_trips=2)
    jmultihost.HostHeartbeat(tmp_path / "theirs", 3).beat(generation=5, segment_seconds=0.25, deadline_trips=2)
    beats = read_heartbeats(tmp_path / "mine")
    assert set(beats) == {3}
    beat = beats[3]
    assert beat["generation"] == 5
    assert beat["segment_seconds"] == 0.25
    assert beat["deadline_trips"] == 2
    assert beat["pid"] == os.getpid()
    assert beat["time"] <= time.time()
    assert (tmp_path / "mine" / "host_0003.json").exists()
    # Each package reads the other's beats, key for key.
    theirs = read_heartbeats(tmp_path / "theirs")
    assert theirs.keys() == beats.keys() and theirs[3].keys() == beat.keys()
    assert jmultihost.read_heartbeats(tmp_path / "mine") == beats


def test_heartbeat_progress_clock_advances_only_on_new_generation(tmp_path):
    hb = HostHeartbeat(tmp_path, 0)
    hb.beat(generation=4)
    first = read_heartbeats(tmp_path)[0]["progress_at"]
    time.sleep(0.02)
    hb.beat(generation=4)
    assert read_heartbeats(tmp_path)[0]["progress_at"] == first
    time.sleep(0.02)
    hb.beat(generation=5)
    assert read_heartbeats(tmp_path)[0]["progress_at"] > first


def test_heartbeat_liveness_thread_keeps_time_fresh(tmp_path):
    hb = HostHeartbeat(tmp_path, 1, interval=0.05)
    hb.beat(generation=7)
    stamped = read_heartbeats(tmp_path)[1]["time"]
    hb.start()
    try:
        deadline = time.time() + 2.0
        while time.time() < deadline:
            beat = read_heartbeats(tmp_path).get(1)
            if beat and beat["time"] > stamped:
                break
            time.sleep(0.02)
        beat = read_heartbeats(tmp_path)[1]
        assert beat["time"] > stamped
        assert beat["generation"] == 7
    finally:
        hb.stop()
    assert hb._thread is None


def test_heartbeat_extra_payload_and_broken_reporter(tmp_path):
    calls = {"n": 0}

    def extra():
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("reporter broke")
        return {"deadline_trips": 4}

    hb = HostHeartbeat(tmp_path, 2, extra=extra)
    hb.beat(generation=1)
    assert read_heartbeats(tmp_path)[2]["deadline_trips"] == 4
    hb.beat(generation=2)
    beat = read_heartbeats(tmp_path)[2]
    assert beat["generation"] == 2
    assert "extra_error" in beat


def test_heartbeat_publish_swallows_unserializable_payload(tmp_path):
    hb = HostHeartbeat(tmp_path, 0)
    hb.beat(generation=1)
    with pytest.warns(UserWarning, match="heartbeat publish failed"):
        hb.beat(generation=2, poison=object())
    assert read_heartbeats(tmp_path)[0]["generation"] == 1
    assert not list(tmp_path.glob("*.tmp.*"))
    hb.beat(generation=3, poison="fine now")
    assert read_heartbeats(tmp_path)[0]["generation"] == 3


def test_read_heartbeats_skips_garbage(tmp_path):
    HostHeartbeat(tmp_path, 0).beat(generation=1)
    (tmp_path / "host_0001.json").write_text("{torn json")
    (tmp_path / "host_0002.json").write_text('{"no_process_index": true}')
    beats = read_heartbeats(tmp_path)
    assert set(beats) == {0}
    assert jmultihost.read_heartbeats(tmp_path) == beats
    assert read_heartbeats(tmp_path / "absent") == {}


# ---------------------------------------------------------------------------
# FleetHealth: per-host verdicts
# ---------------------------------------------------------------------------


def _write_beat(directory, idx, *, age=0.0, progress_age=None, gen=3, now=None, **extra):
    now = time.time() if now is None else now
    payload = {"process_index": idx, "time": now - age,
               "progress_at": now - (progress_age if progress_age is not None else age), "generation": gen}
    payload.update(extra)
    Path(directory).mkdir(parents=True, exist_ok=True)
    (Path(directory) / f"host_{idx:04d}.json").write_text(json.dumps(payload))
    return now


def _check_both(directory, n, now, **kw):
    """Both packages' verdicts on the same files at the same clock; they
    must agree field for field.  Returns the port's report."""
    mine = FleetHealth(directory, n, **kw).check(now=now)
    theirs = jmultihost.FleetHealth(directory, n, **kw).check(now=now)
    assert mine.to_json() == theirs.to_json()
    assert mine.unhealthy_hosts == theirs.unhealthy_hosts
    assert {i: vars(v) for i, v in mine.verdicts.items()} == {i: vars(v) for i, v in theirs.verdicts.items()}
    return mine


def test_fleet_health_dead_verdict(tmp_path):
    now = time.time()
    _write_beat(tmp_path, 0, age=0.0, now=now)
    _write_beat(tmp_path, 1, age=60.0, now=now)
    report = _check_both(tmp_path, 2, now, dead_after=5.0)
    assert not report.healthy
    assert report.dead_hosts == [1]
    assert report.verdicts[0].alive and not report.verdicts[0].dead
    assert report.verdicts[1].dead and not report.verdicts[1].alive
    assert report.unhealthy_hosts == [1]
    assert any("presumed dead" in r for r in report.reasons)


def test_fleet_health_wedged_verdict(tmp_path):
    now = _write_beat(tmp_path, 0, age=0.0, progress_age=30.0)
    report = _check_both(tmp_path, 1, now, dead_after=5.0, stall_after=10.0)
    assert report.wedged_hosts == [0]
    assert not report.dead_hosts
    v = report.verdicts[0]
    assert v.wedged and not v.dead and not v.alive
    assert _check_both(tmp_path, 1, now, dead_after=5.0, stall_after=None).healthy


def test_fleet_health_slow_verdicts(tmp_path):
    now = _write_beat(tmp_path, 0, deadline_trips=3)
    _write_beat(tmp_path, 1, segment_seconds=9.0, now=now)
    _write_beat(tmp_path, 2, segment_seconds=0.1, now=now)
    report = _check_both(tmp_path, 3, now, dead_after=60.0, eval_deadline=2.0)
    assert sorted(report.slow_hosts) == [0, 1]
    assert not report.dead_hosts and not report.wedged_hosts
    assert report.verdicts[0].alive and report.verdicts[0].slow
    assert report.verdicts[0].deadline_trips == 3
    assert report.unhealthy_hosts == [0, 1]
    assert _check_both(tmp_path, 3, now, dead_after=60.0).healthy


def test_fleet_health_start_grace_window(tmp_path):
    health = FleetHealth(tmp_path, 2, dead_after=1.0, start_grace=1000.0)
    report = health.check()
    assert report.healthy
    assert not report.verdicts[0].dead
    time.sleep(0.01)
    report = _check_both(tmp_path, 2, time.time() + 0.01, dead_after=1.0, start_grace=0.0)
    assert report.dead_hosts == [0, 1]
    assert all("no heartbeat" in r for r in report.reasons)


def test_fleet_health_reset_rearms_grace_and_world(tmp_path):
    health = FleetHealth(tmp_path, 4, dead_after=1.0, start_grace=0.0)
    time.sleep(0.01)
    assert len(health.check().dead_hosts) == 4
    health.start_grace = 1000.0
    health.reset(num_processes=2)
    report = health.check()
    assert health.num_processes == 2
    assert report.healthy


def test_fleet_health_validation():
    for cls in (FleetHealth, jmultihost.FleetHealth):
        with pytest.raises(ValueError, match="num_processes"):
            cls("/tmp", 0)
        with pytest.raises(ValueError, match="dead_after"):
            cls("/tmp", 1, dead_after=0.0)


# ---------------------------------------------------------------------------
# single-writer checkpoint discipline
# ---------------------------------------------------------------------------


def test_readonly_store_refuses_every_mutation(tmp_path):
    store = ReadOnlyCheckpointStore()
    for op in (
        lambda: store.open_temp(tmp_path, "ckpt"),
        lambda: store.publish(tmp_path / "a", tmp_path / "b"),
        lambda: store.unlink(tmp_path / "a"),
        lambda: store.rename(tmp_path / "a", tmp_path / "b"),
    ):
        with pytest.raises(OSError) as err:
            op()
        assert err.value.errno == errno.EROFS


def _write_checkpoint(path, *, corrupt=False):
    save_state(path, State(x=torch.arange(8.0), g=torch.tensor(3)))
    if corrupt:
        raw = bytearray(path.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        path.write_bytes(bytes(raw))
    return path


def test_concurrent_scanners_single_rename(tmp_path):
    good = _write_checkpoint(tmp_path / "ckpt_00000002.npz")
    bad = _write_checkpoint(tmp_path / "ckpt_00000001.npz", corrupt=True)
    candidates, rejected = scan_checkpoints(tmp_path, verify=True, quarantine=True, store=ReadOnlyCheckpointStore())
    assert [p for _, p in candidates] == [good]
    assert [(p, renamed) for p, _, renamed in rejected] == [(bad, False)]
    assert bad.exists()
    assert not list(tmp_path.glob("*.corrupt*"))
    candidates, rejected = scan_checkpoints(tmp_path, verify=True, quarantine=True)
    assert [(p, renamed) for p, _, renamed in rejected] == [(bad, True)]
    assert not bad.exists()
    assert len(list(tmp_path.glob("ckpt_00000001.npz.corrupt*"))) == 1
    candidates, rejected = scan_checkpoints(tmp_path, verify=True, quarantine=True, store=ReadOnlyCheckpointStore())
    assert [p for _, p in candidates] == [good]
    assert rejected == []


def test_scan_survives_concurrently_vanishing_candidate(tmp_path, monkeypatch):
    _write_checkpoint(tmp_path / "ckpt_00000002.npz")
    _write_checkpoint(tmp_path / "ckpt_00000001.npz")
    from evox_tpu_torch.resilience import runner as runner_mod

    real_verify = runner_mod.verify_checkpoint

    def racing_verify(path, *a, **k):
        if Path(path).name == "ckpt_00000001.npz":
            raise FileNotFoundError(path)
        return real_verify(path, *a, **k)

    monkeypatch.setattr(runner_mod, "verify_checkpoint", racing_verify)
    candidates, rejected = scan_checkpoints(tmp_path, verify=True, quarantine=True)
    assert [gen for gen, _ in candidates] == [2]
    assert len(rejected) == 1
    assert "vanished" in rejected[0][1]
    assert (tmp_path / "ckpt_00000001.npz").exists()


def _small_workflow():
    mon = EvalMonitor(full_fit_history=False)
    return mon, StdWorkflow(PSO(8, LB, UB, device="cpu"), Sphere(), monitor=mon)


def _leaves_equal(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def test_runner_non_primary_is_read_only_and_bit_identical(tmp_path):
    _, wf_primary = _small_workflow()
    primary = ResilientRunner(wf_primary, tmp_path / "rw", checkpoint_every=2)
    s_primary = primary.run(wf_primary.init(0), n_steps=5)
    assert list((tmp_path / "rw").glob("ckpt_*.npz"))
    _, wf_follower = _small_workflow()
    follower = ResilientRunner(wf_follower, tmp_path / "ro", checkpoint_every=2, primary=False)
    assert isinstance(follower.store, ReadOnlyCheckpointStore)
    assert follower._writer is None
    s_follower = follower.run(wf_follower.init(0), n_steps=5)
    assert not (tmp_path / "ro").exists()
    _leaves_equal(s_primary, s_follower)


def test_runner_non_primary_resumes_primary_checkpoints(tmp_path):
    _, wf = _small_workflow()
    ResilientRunner(wf, tmp_path, checkpoint_every=2).run(wf.init(0), n_steps=4)
    _, wf2 = _small_workflow()
    follower = ResilientRunner(wf2, tmp_path, checkpoint_every=2, primary=False)
    follower.run(wf2.init(0), n_steps=6)
    assert follower.stats.resumed_from_generation is not None
    gens = sorted(int(p.stem.split("_")[1]) for p in tmp_path.glob("ckpt_*.npz"))
    assert max(gens) == 4


def test_runner_default_primary_is_true_single_process(tmp_path):
    _, wf = _small_workflow()
    runner = ResilientRunner(wf, tmp_path, checkpoint_every=2)
    assert runner.primary
    assert not isinstance(runner.store, ReadOnlyCheckpointStore)


def test_runner_heartbeat_published_at_boundaries(tmp_path):
    beats = []

    class Recorder:
        def beat(self, generation=None, segment_seconds=None, **fields):
            beats.append(generation)

    _, wf = _small_workflow()
    ResilientRunner(wf, tmp_path / "ck", checkpoint_every=2, heartbeat=Recorder()).run(wf.init(0), n_steps=5)
    assert beats[0] == 1
    assert beats[-1] == 5
    assert beats == sorted(beats)
    beats.clear()
    _, wf2 = _small_workflow()
    ResilientRunner(wf2, tmp_path / "ck", checkpoint_every=2, heartbeat=Recorder()).run(wf2.init(0), n_steps=5)
    assert beats and beats[0] == 5


# ---------------------------------------------------------------------------
# process faults: degenerate single-process behaviour
# ---------------------------------------------------------------------------


def _steps(prob, n):
    wf = StdWorkflow(PSO(8, LB, UB, device="cpu"), prob)
    state = wf.init_step(wf.init(0))
    for _ in range(n):
        state = wf.step(state)
    return state


def test_fleet_faults_for_other_processes_never_fire_here():
    prob = FaultyProblem(Sphere(), kill_process_at={3: (0, 1)}, partition_process_at={2: (0,)},
                         slow_process_at={1: (0,)})
    assert not prob.capturable
    state = _steps(prob, 1)
    assert int(state.problem.fault_generation) == 2
    assert prob.deadline_trips == 0


def test_slow_process_fault_counts_deadline_trips():
    prob = FaultyProblem(Sphere(), slow_process_at={0: (1,)}, slow_process_seconds=30.0, eval_deadline=0.2)
    start = time.monotonic()
    _steps(prob, 2)
    assert time.monotonic() - start < 10.0
    assert prob.deadline_trips == 1
    prob.reset_faults()
    assert prob.deadline_trips == 0


def test_slow_process_fault_without_deadline_really_sleeps():
    prob = FaultyProblem(Sphere(), slow_process_at={0: (0,)}, slow_process_seconds=0.4)
    start = time.monotonic()
    _steps(prob, 0)
    assert time.monotonic() - start >= 0.35


def test_partition_fault_freezes_progress():
    prob = FaultyProblem(Sphere(), partition_process_at={0: (0,)}, partition_seconds=0.4)
    start = time.monotonic()
    _steps(prob, 0)
    assert time.monotonic() - start >= 0.35


@pytest.mark.parametrize(
    "plan",
    [dict(kill_process_at={-1: [1]}), dict(slow_process_at={0: [-2]}), dict(partition_times=-1),
     dict(kill_process_at={1: [3, 4]}, slow_process_at={1: [4]}),
     dict(kill_process_at={2: [5]}, partition_process_at={2: [5, 6]})],
    ids=["negative-key", "negative-eval", "negative-times", "kill-and-slow", "kill-and-partition"],
)
def test_process_fault_validation_messages_equal_jax(plan):
    """The JAX package's message, with the torch.distributed rank where
    it names jax.process_index()."""
    with pytest.raises(ValueError) as mine:
        FaultyProblem(Sphere(), **plan)
    from evox_tpu.problems.numerical import Sphere as JSphere

    with pytest.raises(ValueError) as theirs:
        JFaultyProblem(JSphere(), **plan)
    assert str(mine.value) == str(theirs.value).replace("jax.process_index()", "torch.distributed rank")


# ---------------------------------------------------------------------------
# the supervisor's decisions (fake workers: no subprocesses), both packages
# ---------------------------------------------------------------------------


class FakeWorker:
    """Scripted worker handle: ``rc`` is the scripted exit code (``None`` =
    running until the supervisor stops it)."""

    pid = 4242

    def __init__(self, rc=None):
        self.rc = rc
        self.terminated = False
        self.killed = False

    def poll(self):
        return self.rc

    def terminate(self):
        self.terminated = True
        if self.rc is None:
            self.rc = -15

    def kill(self):
        self.killed = True
        if self.rc is None:
            self.rc = -9

    def wait(self, timeout=None):
        return self.rc


def _scripted(cls, tmp_path, script, **kwargs):
    """A supervisor of ``cls`` whose worker factory replays ``script``:
    ``{(attempt, process_id): rc, or a callable (supervisor, spec) ->
    worker}``; missing entries exit 0."""
    holder = {}

    def spawn(argv, env, spec):
        plan = script.get((spec.attempt, spec.process_id), 0)
        return plan(holder["sup"], spec) if callable(plan) else FakeWorker(rc=plan)

    kwargs.setdefault("poll_interval", 0.01)
    kwargs.setdefault("grace_seconds", 0.05)
    kwargs.setdefault("start_grace", 1000.0)
    kwargs.setdefault("obs", False)
    holder["sup"] = cls(lambda spec: ["true"], kwargs.pop("num_processes", 3), checkpoint_dir=tmp_path / "ckpt",
                        spawn=spawn, **kwargs)
    return holder["sup"]


def _view(stats):
    return dict(attempts=stats.attempts, completed=stats.completed, world_sizes=stats.world_sizes,
                removed_hosts=stats.removed_hosts, host_deaths=stats.host_deaths,
                hosts_quarantined=stats.hosts_quarantined, kinds=[e.kind for e in stats.events],
                exit_codes=stats.exit_codes)


def _run_both(tmp_path, script, raises=None, **kwargs):
    """Run the port's and the JAX package's supervisor on one script; their
    FleetStats must agree.  Returns the port's supervisor."""
    sups = []
    for cls, sub in ((FleetSupervisor, "mine"), (jfleet.FleetSupervisor, "theirs")):
        sup = _scripted(cls, tmp_path / sub, script, **dict(kwargs))
        if raises is None:
            sup.run()
        else:
            with pytest.raises((FleetError, jfleet.FleetError), match=raises):
                sup.run()
        sups.append(sup)
    assert _view(sups[0].stats) == _view(sups[1].stats)
    return sups[0]


def test_supervisor_completes_when_all_exit_zero(tmp_path):
    stats = _run_both(tmp_path, {}).stats
    assert stats.completed
    assert stats.attempts == 1
    assert stats.world_sizes == [3]
    assert stats.host_deaths == 0
    assert [e.kind for e in stats.events] == ["launch", "complete"]


def test_supervisor_relaunches_one_smaller_after_host_death(tmp_path):
    stats = _run_both(tmp_path, {(0, 2): 1, (0, 0): None, (0, 1): None}).stats
    assert stats.completed
    assert stats.world_sizes == [3, 2]
    assert stats.host_deaths == 1
    assert stats.removed_hosts == [(0, 2, "exited rc=1")]
    kinds = [e.kind for e in stats.events]
    assert "host-death" in kinds and "relaunch" in kinds and "stop" in kinds
    assert stats.exit_codes[0] == {0: -15, 1: -15, 2: 1}


def test_supervisor_sigkill_death_is_a_death(tmp_path):
    stats = _run_both(tmp_path, {(0, 1): -9, (0, 0): None}).stats
    assert stats.completed
    assert stats.removed_hosts[0][:2] == (0, 1)
    assert stats.world_sizes == [3, 2]


def test_supervisor_spontaneous_preemption_is_resumable_not_broken(tmp_path):
    stats = _run_both(tmp_path, {(0, 1): EX_PREEMPTED, (0, 0): None, (0, 2): None}).stats
    assert stats.completed
    assert stats.world_sizes == [3, 2]
    assert stats.removed_hosts == [(0, 1, "preempted externally")]


def test_supervisor_graceful_stop_ack_is_not_a_second_removal(tmp_path):
    def graceful(sup, spec):
        w = FakeWorker(rc=None)
        w.terminate = lambda: setattr(w, "rc", EX_PREEMPTED)
        return w

    stats = _run_both(tmp_path, {(0, 0): 1, (0, 1): graceful, (0, 2): graceful}).stats
    assert stats.completed
    assert stats.removed_hosts == [(0, 0, "exited rc=1")]
    assert stats.world_sizes == [3, 2]
    assert stats.exit_codes[0] == {0: 1, 1: EX_PREEMPTED, 2: EX_PREEMPTED}


def test_supervisor_min_processes_floor(tmp_path):
    script = {(a, 1): 1 for a in range(5)}
    script.update({(a, 0): None for a in range(5)})
    sup = _run_both(tmp_path, script, raises="min_processes", num_processes=2, min_processes=2)
    assert sup.stats.world_sizes == [2]


def test_supervisor_relaunch_budget(tmp_path):
    script = {(a, p): 1 if p == a else None for a in range(6) for p in range(5)}
    sup = _run_both(tmp_path, script, raises="relaunch budget", num_processes=5, max_relaunches=1)
    assert sup.stats.world_sizes == [5, 4]


def test_supervisor_attempt_timeout_is_a_loud_error(tmp_path):
    script = {(0, p): None for p in range(2)}
    sup = _run_both(tmp_path, script, raises="deadlocked", num_processes=2, attempt_timeout=0.2)
    assert sup.stats.exit_codes[-1] == {0: -15, 1: -15}


def _beating(idx, **payload):
    def factory(sup, spec):
        _write_beat(sup.heartbeat_dir, idx, **payload)
        return FakeWorker(rc=None)

    return factory


def test_supervisor_straggler_quarantine_via_heartbeats(tmp_path):
    script = {(0, 0): _beating(0, gen=3), (0, 1): _beating(1, gen=3, deadline_trips=5)}
    stats = _run_both(tmp_path, script, num_processes=2, eval_deadline=1.0, dead_after=1000.0,
                      start_grace=0.0).stats
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    assert stats.hosts_quarantined == 1
    assert [e.kind for e in stats.events if e.kind == "straggler"]
    assert stats.removed_hosts[0][1] == 1


def test_supervisor_whole_fleet_wedge_shrinks_by_one(tmp_path):
    script = {(0, 0): _beating(0, age=0.0, progress_age=500.0), (0, 1): _beating(1, age=0.0, progress_age=500.0)}
    stats = _run_both(tmp_path, script, num_processes=2, dead_after=1000.0, stall_after=10.0,
                      start_grace=0.0).stats
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    assert [e.kind for e in stats.events if e.kind == "fleet-stall"]
    assert stats.hosts_quarantined == 1


def test_supervisor_clears_stale_heartbeats_between_attempts(tmp_path):
    sup = _scripted(FleetSupervisor, tmp_path, {}, num_processes=2)
    _write_beat(sup.heartbeat_dir, 7, gen=99)
    stats = sup.run()
    assert stats.completed
    assert read_heartbeats(sup.heartbeat_dir) == {}


def test_supervisor_validation():
    for kw, match in ((dict(num_processes=0), "num_processes"), (dict(min_processes=3), "min_processes"),
                      (dict(max_relaunches=-1), "max_relaunches")):
        msgs = []
        for cls in (FleetSupervisor, jfleet.FleetSupervisor):
            kwargs = dict(kw)
            with pytest.raises(ValueError, match=match) as err:
                cls(lambda s: ["x"], kwargs.pop("num_processes", 2), checkpoint_dir="/tmp/x", **kwargs)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


def test_plan_relaunch_always_charges_at_least_one_host(tmp_path):
    sups = [_scripted(cls, tmp_path, {}, num_processes=4) for cls in (FleetSupervisor, jfleet.FleetSupervisor)]
    for world, removed in ((4, set()), (4, {1, 3}), (3, {0}), (2, {0, 1, 2})):
        got = []
        for sup in sups:
            try:
                got.append(sup.plan_relaunch(world, removed))
            except (FleetError, jfleet.FleetError) as e:
                got.append(str(e))
        assert got[0] == got[1]
    assert sups[0].plan_relaunch(4, set()) == 3
    assert sups[0].plan_relaunch(4, {1, 3}) == 2
    with pytest.raises(FleetError, match="min_processes"):
        sups[0].plan_relaunch(1, {0})


def test_supervisor_single_process_degenerate_real_subprocess(tmp_path):
    sup = FleetSupervisor(
        lambda spec: [sys.executable, "-c",
                      "import os, sys; sys.exit(0 if os.environ.get('EVOX_TPU_FLEET_COORDINATOR') == '' else 7)"],
        1,
        checkpoint_dir=tmp_path / "ckpt",
        poll_interval=0.05,
        start_grace=1000.0,
        attempt_timeout=60.0,
        obs=False,
    )
    stats = sup.run()
    assert stats.completed
    assert stats.world_sizes == [1]
    assert list(sup.heartbeat_dir.glob("worker_a00_p00.log"))


# ---------------------------------------------------------------------------
# real gloo fleets on the CPU (tests/test_torch_fleet_worker.py)
# ---------------------------------------------------------------------------

_STEPS = 8
_CFG = {"n_steps": _STEPS, "pop": 24, "dim": DIM, "checkpoint_every": 2, "seed": 0, "device": "cpu"}
# The counter that counts the interruptions themselves (a supervisor's
# SIGTERM caught at a boundary is recorded in the emergency checkpoint).
_PREEMPT_KEY = "monitor/num_preemptions"


@pytest.fixture(scope="module")
def fleet_harness():
    """Skip where a loopback coordinator port or a subprocess is not
    available (decided here, not at import)."""
    try:
        free_coordinator_port()
    except OSError as e:
        pytest.skip(f"no loopback coordinator port: {e!r}")
    probe = subprocess.run([sys.executable, "-c", "pass"], timeout=60, capture_output=True)
    if probe.returncode != 0:
        pytest.skip(f"subprocess spawning broken (rc={probe.returncode})")


def _worker_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    return env


def _run_fleet(directory, name, num_processes, cfg, **kwargs):
    ckpt = directory / name
    cfg_path = directory / f"{name}.json"
    cfg_path.write_text(json.dumps(cfg))
    kwargs.setdefault("poll_interval", 0.1)
    kwargs.setdefault("dead_after", 20.0)
    kwargs.setdefault("grace_seconds", 6.0)
    kwargs.setdefault("start_grace", 120.0)
    kwargs.setdefault("attempt_timeout", 120.0)
    sup = FleetSupervisor(
        lambda spec: [sys.executable, str(Path(worker.__file__)), spec.checkpoint_dir, str(cfg_path)],
        num_processes, checkpoint_dir=ckpt, env=_worker_env(), **kwargs,
    )
    try:
        stats = sup.run()
    except FleetError:
        logs = "\n".join(p.read_text()[-2000:] for p in sorted(sup.heartbeat_dir.glob("*.log")))
        raise AssertionError(f"fleet {name} failed; worker logs:\n{logs}")
    return stats, ckpt, sup


def _final_state(ckpt_dir):
    return dict(np.load(ckpt_dir / "final_state.npz"))


def _assert_states_equal(a, b, msg):
    assert a.keys() == b.keys(), (msg, sorted(a), sorted(b))
    for k in a:
        if k != _PREEMPT_KEY:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}: {k}")


@pytest.fixture(scope="module")
def reference(fleet_harness, tmp_path_factory):
    """The uninterrupted 1-process fleet of ``_CFG``."""
    stats, ckpt, _ = _run_fleet(tmp_path_factory.mktemp("ref"), "ref1", 1, _CFG)
    assert stats.completed and stats.attempts == 1
    return _final_state(ckpt)


def _inprocess_reference(ckpt_dir, cfg=_CFG):
    """The same configuration run in this process on a one-rank mesh,
    through the same runner path and the worker's own problem."""
    wf, _ = worker.build(cfg, make_pop_mesh(device="cpu"))
    runner = ResilientRunner(wf, ckpt_dir, checkpoint_every=cfg["checkpoint_every"],
                             retry=RetryPolicy(max_retries=0))
    return worker.final_payload(runner.run(wf.init(cfg["seed"]), n_steps=cfg["n_steps"]))


def test_fleet_sigkill_on_two_processes_resumes_on_one_bit_identical(reference, tmp_path):
    cfg = dict(_CFG, faults={"0": {"kill": {"1": [4]}}})  # attempt 0: rank 1 dies at eval 4
    stats, ckpt, sup = _run_fleet(tmp_path, "chaos", 2, cfg)
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    assert stats.host_deaths == 1
    assert [h for _, h, _ in stats.removed_hosts] == [1]
    # The survivor waited for the stop and acknowledged it.
    assert stats.exit_codes[0][0] == EX_PREEMPTED
    summary = json.loads((ckpt / "final_summary.json").read_text())
    assert summary["world"] == 1
    assert summary["completed_generations"] == _STEPS
    assert summary["resumed_from_generation"] == 3
    survivor = json.loads((ckpt / "worker_a00_p00.json").read_text())
    assert survivor["outcome"] == "peer-lost" and survivor["group_backend"] == "gloo"
    # The killed rank's record is the one of its last boundary.
    killed = json.loads((ckpt / "worker_a00_p01.json").read_text())
    assert killed["outcome"] == "running" and killed["completed_generations"] == 3
    assert killed["rows_device"] == survivor["rows_device"] == "cpu"
    state = _final_state(ckpt)
    _assert_states_equal(state, reference, "chaos fleet vs uninterrupted 1-process fleet")
    _assert_states_equal(state, _inprocess_reference(tmp_path / "inproc"), "chaos fleet vs in-process run")


def test_fleet_metrics_aggregation_value_for_value(fleet_harness, tmp_path):
    """Every rank's registry rides its beats; after the run the
    supervisor's aggregated counters equal the sum of the ranks' final
    registries, series for series."""
    from evox_tpu_torch.obs import MetricsRegistry, Observability

    stats, ckpt, sup = _run_fleet(tmp_path, "metrics", 2, dict(_CFG, metrics=True),
                                  obs=Observability(registry=MetricsRegistry()))
    assert stats.completed and stats.world_sizes == [2]
    hosts = [json.loads((ckpt / f"host_registry_{i:04d}.json").read_text()) for i in range(2)]
    want: dict = {}
    for h in hosts:
        for series, value in h["counters"].items():
            want[series] = want.get(series, 0.0) + value
    assert want and any(s.startswith("evox_runner_") for s in want)
    snap = sup.aggregator.snapshot()
    for series, value in want.items():
        assert snap[series] == value, series
    assert snap["evox_fleet_aggregated_hosts"] == 2


@pytest.mark.slow
def test_fleet_chaos_sigkill_resume_bit_identical(fleet_harness, tmp_path):
    """A 4-process fleet loses rank 3 to SIGKILL, resumes on 3, loses rank
    1, and finishes on 2: bit-identical to an uninterrupted 2-process fleet
    and to the in-process run."""
    cfg = dict(_CFG, faults={"0": {"kill": {"3": [4]}}, "1": {"kill": {"1": [6]}}})
    stats, ckpt, _ = _run_fleet(tmp_path, "chaos", 4, cfg, min_processes=2)
    assert stats.completed
    assert stats.world_sizes == [4, 3, 2]
    assert stats.attempts == 3
    assert stats.host_deaths == 2
    assert [h for _, h, _ in stats.removed_hosts] == [3, 1]
    summary = json.loads((ckpt / "final_summary.json").read_text())
    assert summary["world"] == 2 and summary["completed_generations"] == _STEPS
    assert summary["resumed_from_generation"] == 5
    assert summary["restarts"] == 0
    ref_stats, ref_ckpt, _ = _run_fleet(tmp_path, "ref2", 2, _CFG)
    assert ref_stats.completed and ref_stats.attempts == 1
    state = _final_state(ckpt)
    _assert_states_equal(state, _final_state(ref_ckpt), "chaos fleet vs uninterrupted 2-process fleet")
    assert 0 <= int(state[_PREEMPT_KEY]) <= stats.attempts - 1
    _assert_states_equal(state, _inprocess_reference(tmp_path / "inproc"), "chaos fleet vs in-process run")


@pytest.mark.slow
def test_fleet_straggler_quarantined_without_wedging(reference, tmp_path):
    cfg = dict(_CFG, faults={"0": {"slow": {"1": [2, 3, 4, 5, 6, 7]}}}, slow_seconds=30.0, slow_times=1,
               eval_deadline=0.5)
    stats, ckpt, _ = _run_fleet(tmp_path, "straggler", 2, cfg, eval_deadline=30.0)
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    assert stats.hosts_quarantined >= 1
    assert any(e.kind == "straggler" for e in stats.events)
    assert stats.removed_hosts[0][1] == 1
    summary = json.loads((ckpt / "final_summary.json").read_text())
    assert summary["completed_generations"] == _STEPS
    state = _final_state(ckpt)
    _assert_states_equal(state, reference, "straggler-quarantined fleet vs uninterrupted 1-process fleet")
    assert 0 <= int(state[_PREEMPT_KEY]) <= 1


@pytest.mark.slow
def test_fleet_partition_detected_as_wedge_and_survived(fleet_harness, tmp_path):
    cfg = dict(_CFG, faults={"0": {"partition": {"1": [5]}}}, collective_timeout=30.0)
    stats, ckpt, _ = _run_fleet(tmp_path, "partition", 2, cfg, stall_after=15.0, dead_after=60.0)
    assert stats.completed
    assert stats.world_sizes == [2, 1]
    kinds = {e.kind for e in stats.events}
    assert "fleet-stall" in kinds or "wedged" in kinds
    summary = json.loads((ckpt / "final_summary.json").read_text())
    assert summary["completed_generations"] == _STEPS
