"""One worker process of a port fleet (counterpart of ``tests/fleet_worker.py``;
imports torch and evox_tpu_torch only, never JAX).

A :class:`~evox_tpu_torch.resilience.FleetSupervisor` launches it with the
``EVOX_TPU_FLEET_*`` environment; it joins the fleet
(:func:`~evox_tpu_torch.parallel.bootstrap_fleet`), runs a
population-sharded PSO under a
:class:`~evox_tpu_torch.resilience.ResilientRunner` against the shared
checkpoint directory, publishes heartbeats, and on the primary dumps the
final state bitwise so a test can compare fleets with uninterrupted runs::

    python tests/test_torch_fleet_worker.py <checkpoint_dir> <config.json>

Config keys (those of ``tests/fleet_worker.py``): ``n_steps``, ``pop``,
``dim``, ``checkpoint_every``, ``seed``, optional ``eval_deadline``,
``slow_seconds``, ``slow_times``, ``metrics``, and a ``faults`` table keyed
by supervisor attempt::

    {"faults": {"0": {"kill": {"1": [25]}},       # attempt 0: SIGKILL rank 1
                "1": {"slow": {"1": [2, 3, 4]}}}}  # attempt 1: rank 1 slow

and the port's own: ``device`` (``"cuda"``, the default, or ``"cpu"``),
``problem`` (``"noisy_sphere"``, the default: a keyed Sphere whose streams
test the topology invariance, or ``"sphere"``), ``bound`` (the search box
is ±bound in every dimension, default 5), ``collective_timeout`` (the
group's timeout in seconds, default 60) and ``profile_segment`` (the
runner's segment, 0 = generation 1, to hold in a ``torch.profiler``
window; its copies between host and card go into the summary).

Ranks that share a card form a gloo group and compute on the card (gloo
copies the fitness blocks through the host itself).  A survivor whose peer died sees
its collective fail at once under gloo; it then waits, as a survivor of
the JAX package's fleet does in its stuck collective, for the supervisor's
stop (the supervisor charges the host that died, not the survivors) and
acknowledges it with exit code 75.

Exit codes: 0 = run complete; 75 (``EX_PREEMPTED``) = stopped by the
supervisor's SIGTERM (resumable); anything else = failure.

Besides the JAX worker's ``final_state.npz`` and ``final_summary.json``
(primary only), every rank writes ``worker_a<attempt>_p<rank>.json`` into
the checkpoint directory at every segment boundary and at its end, so a
rank killed mid-run leaves its record of the last boundary: its launches
of the PSO move and the Philox draws, the device of its rows, its fitness
exchanges, its segment times, the wall clock of its start-up stages, and
on the card one move of its first boundary's state held against the
move's plain version.  At its first progress beat it writes
``first_beat_a<attempt>_p<rank>.json`` into the heartbeat directory.
"""

import json
import os
import sys
import time
from pathlib import Path

_STARTED_AT = time.time()
ROOT = Path(__file__).resolve().parent.parent
EX_PREEMPTED = 75
# Seconds a survivor of a lost peer waits for the supervisor's stop.
PEER_LOSS_WAIT = 300.0
# What a collective raises when a peer is gone (gloo: the peer's socket
# closed, or the group's timeout expired while it was unreachable).
PEER_LOSS_SIGNATURES = (
    "Connection closed by peer",
    "Connection reset by peer",
    "Broken pipe",
    "Timed out waiting",
    "timed out",
)


def _noisy_sphere():
    from evox_tpu_torch.core import Problem, State
    from evox_tpu_torch.utils import rng

    class NoisySphere(Problem):
        """Sphere plus a normal draw of the state's key per row: a keyed
        evaluation, so the fleet comparison tests the streams' topology
        invariance, not only determinism."""

        def setup(self, key):
            return State(key=key)

        def evaluate(self, state, pop):
            noise = rng.normal(rng.child(state.key), (pop.shape[0],), pop.dtype, pop.device)
            key, _ = rng.split(state.key)
            return (pop * pop).sum(dim=-1) + 0.1 * noise, state.replace(key=key)

    return NoisySphere()


def make_problem(name):
    if name == "noisy_sphere":
        return _noisy_sphere()
    if name == "sphere":
        from evox_tpu_torch.problems.numerical import Sphere

        return Sphere()
    raise ValueError(f"unknown problem {name!r}: 'noisy_sphere' or 'sphere'")


def build(cfg, mesh, faults=None):
    """``(workflow, faulty problem)`` of the config: PSO(pop, ±bound in
    dim) over ``FaultyProblem(ShardedProblem(problem, mesh))`` with
    ``EvalMonitor(full_fit_history=False)``; the wrapper is there with or
    without faults, so every run has one structure."""
    import torch

    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.parallel import ShardedProblem
    from evox_tpu_torch.resilience import FaultyProblem
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    faults = faults or {}

    def sched(name):
        return {int(p): tuple(g) for p, g in (faults.get(name) or {}).items()}

    dim, bound = int(cfg.get("dim", 4)), float(cfg.get("bound", 5.0))
    lb = torch.full((dim,), -bound)
    prob = FaultyProblem(
        ShardedProblem(make_problem(cfg.get("problem", "noisy_sphere")), mesh),
        kill_process_at=sched("kill"),
        slow_process_at=sched("slow"),
        slow_process_seconds=float(cfg.get("slow_seconds", 1.0)),
        slow_process_times=int(cfg.get("slow_times", 1)),
        partition_process_at=sched("partition"),
        eval_deadline=cfg.get("eval_deadline"),
    )
    algo = PSO(int(cfg.get("pop", 24)), lb, -lb, device=mesh.device)
    return StdWorkflow(algo, prob, monitor=EvalMonitor(full_fit_history=False)), prob


def final_payload(state):
    """Bitwise-comparable dump of the algorithm and monitor sub-states:
    every tensor leaf keyed by its path (the checkpoint's names)."""
    from evox_tpu_torch.utils.checkpoint import _named_leaves

    out = {}
    for section in ("algorithm", "monitor"):
        if section in state:
            for name, leaf in _named_leaves(state[section], (section,)):
                out[name] = leaf.detach().cpu().numpy()
    return out


def move_vs_plain(wf, state):
    """The move of the generation after ``state`` against the
    kernel's plain version on the same operands: the number of elements
    whose bits differ (0 expected).  The launch counts are restored: a
    comparison is not a launch of the path."""
    import torch

    from evox_tpu_torch.algorithms.so.pso_variants.utils import min_by
    from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain
    from evox_tpu_torch.utils import rng

    st = state.algorithm
    gbl, _ = min_by([st.global_best_location[None, :], st.pop], [st.global_best_fit[None], st.fit])
    _, (seed,) = rng.split(st.key)
    ops = dict(pop=st.pop, velocity=st.velocity, local_best_location=st.local_best_location, fit=st.fit,
               local_best_fit=st.local_best_fit, global_best_location=gbl, lb=wf.algorithm.lb,
               ub=wf.algorithm.ub, w=st.w, phi_p=st.phi_p, phi_g=st.phi_g, seed=seed)
    counts = fused_pso_move.launches, dict(fused_pso_move.routes)
    got, want = fused_pso_move(**ops), fused_pso_move_plain(**ops)
    fused_pso_move.launches, fused_pso_move.routes = counts
    differ = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum()) for g, w in zip(got, want))
    err = max(float((g - w).abs().nan_to_num(0.0).max()) for g, w in zip(got, want))
    return {"elements": sum(int(w.numel()) for w in want), "bits_differ": differ, "max_abs_err": err}


def peer_lost(exc) -> bool:
    """Whether ``exc`` (or an exception it was raised from) is a
    collective's report of a lost peer."""
    import torch.distributed as dist

    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, getattr(dist, "DistNetworkError", ())) or any(
            s in str(exc) for s in PEER_LOSS_SIGNATURES
        ):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


class ExchangeMeter:
    """Wraps the sharded evaluation's all-gather: its calls, their host
    seconds and the devices of the gathered fitness."""

    def __init__(self):
        import evox_tpu_torch.parallel.sharded_problem as sp

        self.calls, self.seconds, self.devices = 0, 0.0, set()
        inner = sp.all_gather_rows

        def gather(local, mesh):
            t0 = time.perf_counter()
            out = inner(local, mesh)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.devices.add(str(out.device))
            return out

        sp.all_gather_rows = gather

    def summary(self):
        return {"calls": self.calls, "seconds": self.seconds, "devices": sorted(self.devices)}


def host_transfers(trace_dir):
    """The copies between host and card in the profiler window's Chrome
    traces under ``trace_dir``: ``{direction: {bytes: count}}``, the
    direction as the trace names it (``HtoD``, ``DtoH``, ``DtoD``...)."""
    out: dict = {}
    for path in sorted(Path(trace_dir).glob("*.trace.json")):
        for ev in json.loads(path.read_text()).get("traceEvents", []):
            name = str(ev.get("name", ""))
            if ev.get("cat") != "gpu_memcpy" and not name.startswith("Memcpy"):
                continue
            kind = next((k for k in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP") if k in name), name)
            size = str(int((ev.get("args") or {}).get("bytes", -1)))
            out.setdefault(kind, {})[size] = out.get(kind, {}).get(size, 0) + 1
    return out


def main(argv):
    checkpoint_dir = Path(argv[1])
    with open(argv[2]) as f:
        cfg = json.load(f)
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.parallel import (
        FLEET_ENV_ATTEMPT,
        FLEET_ENV_HEARTBEAT_DIR,
        HostHeartbeat,
        bootstrap_fleet,
        fleet_barrier,
        make_pop_mesh,
    )
    from evox_tpu_torch.resilience import Preempted, PreemptionGuard, ResilientRunner, RetryPolicy

    stages = {"imported": time.time() - _STARTED_AT}
    device = cfg.get("device", "cuda")
    topo = bootstrap_fleet(device=device, initialization_timeout=float(cfg.get("collective_timeout", 60.0)))
    stages["bootstrapped"] = time.time() - _STARTED_AT
    # The supervisor's attempt (a one-process attempt joins no group, and
    # its topology is the degenerate one).
    attempt = int(os.environ.get(FLEET_ENV_ATTEMPT) or 0)
    record = {"attempt": attempt, "process_index": topo.process_index, "world": topo.num_processes,
              "started_at": _STARTED_AT, "stages": stages, "outcome": "running"}
    record_path = checkpoint_dir / f"worker_a{attempt:02d}_p{topo.process_index:02d}.json"
    if topo.num_processes > 1:
        fleet_barrier("worker-start")  # the ranks start at different times
        stages["peers_met"] = time.time() - _STARTED_AT
        t0 = time.perf_counter()
        fleet_barrier("worker-barrier")
        record["barrier_ms"] = (time.perf_counter() - t0) * 1e3
    mesh = make_pop_mesh(device=device)
    record["mesh"] = repr(mesh)
    record["group_backend"] = dist.get_backend()
    meter = ExchangeMeter()

    # This attempt's faults: a removed host's faults leave with it.
    wf, prob = build(cfg, mesh, (cfg.get("faults") or {}).get(str(attempt), {}))
    registry = obs = tracer = None
    profile_dir = checkpoint_dir / f"profile_a{attempt:02d}_p{topo.process_index:02d}"
    if cfg.get("metrics") or cfg.get("profile_segment") is not None:
        from evox_tpu_torch.obs import MetricsRegistry, Observability, Tracer

        registry = MetricsRegistry() if cfg.get("metrics") else None
        tracer = None if cfg.get("profile_segment") is None else Tracer(
            profile_segment=int(cfg["profile_segment"]), profile_dir=profile_dir, process_index=topo.process_index)
        obs = Observability(registry=registry, tracer=tracer)
    hb_dir = Path(os.environ[FLEET_ENV_HEARTBEAT_DIR])

    class RecordingHeartbeat(HostHeartbeat):
        """Writes the wall time of its first progress beat beside the beats."""

        def beat(self, generation=None, segment_seconds=None, **fields):
            if generation is not None and "first_beat_at" not in record:
                record["first_beat_at"], record["first_beat_generation"] = time.time(), int(generation)
                (hb_dir / f"first_beat_a{attempt:02d}_p{topo.process_index:02d}.json").write_text(
                    json.dumps({"time": record["first_beat_at"], "generation": int(generation)}))
            super().beat(generation, segment_seconds, **fields)

    def update_record():
        record.update(
            launches={"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches},
            exchange=meter.summary(),
            checkpoints_written=runner.stats.checkpoints_written,
            resumed_from_generation=runner.stats.resumed_from_generation,
            completed_generations=runner.stats.completed_generations,
            segments=[[t.generation, t.execute_seconds] for t in runner.stats.segment_timings],
            chunks=list(runner.stats.chunk_sizes),
            deadline_trips=prob.deadline_trips,
        )

    class RecordingRunner(ResilientRunner):
        """Holds the first boundary's state against the plain move on the
        card, reads the profiled segment's trace at the boundary that ends
        it, and rewrites the rank's record at every boundary."""

        last_done = None

        def _boundary(self, state, done, host, stepped):
            super()._boundary(state, done, host, stepped)
            if "rows_device" not in record:
                stages["first_boundary"] = time.time() - _STARTED_AT
                record["rows_device"] = str(state.algorithm.pop.device)
                if state.algorithm.pop.device.type == "cuda":
                    record["move_vs_plain"] = move_vs_plain(wf, state)
            start = self.last_done if self.last_done is not None else (self.stats.resumed_from_generation or 0)
            self.last_done = done
            if tracer is not None and tracer.profiled_segments and "transfers" not in record:
                record["transfers"] = {"segment": tracer.profiled_segments[0], "generations": done - start,
                                       "boundary_generation": done, "copies": host_transfers(profile_dir)}
            update_record()
            record_path.write_text(json.dumps(record))

    heartbeat = RecordingHeartbeat(
        hb_dir, topo.process_index, interval=0.25,
        # The straggler self-report: every eval-deadline expiry of this rank.
        extra=lambda: {"deadline_trips": prob.deadline_trips}, metrics=registry,
    ).start()
    runner = RecordingRunner(
        wf, checkpoint_dir, checkpoint_every=int(cfg.get("checkpoint_every", 2)),
        preemption=True,  # the supervisor's SIGTERM -> a graceful boundary stop
        heartbeat=heartbeat, obs=obs,
        # A collective that lost its peer cannot be retried in-process:
        # fail fast and let the supervisor relaunch the surviving world.
        retry=RetryPolicy(max_retries=0),
    )
    # A survivor's own guard, installed under the runner's: a stop that
    # comes between the runner's exit on a lost peer and the wait below
    # is caught, not taken by the default action.
    guard = PreemptionGuard().install() if topo.num_processes > 1 else None
    fused_pso_move.launches = philox_draws.launches = 0
    state = wf.init(int(cfg.get("seed", 0)))
    stages["initialised"] = time.time() - _STARTED_AT
    code, final = 0, None
    try:
        final = runner.run(state, n_steps=int(cfg["n_steps"]))
        record["outcome"] = "complete"
    except Preempted:
        code, record["outcome"] = EX_PREEMPTED, "preempted"
    except Exception as e:  # noqa: BLE001 - classified below, re-raised unless a peer was lost
        if topo.num_processes <= 1 or not peer_lost(e):
            raise
        record["outcome"], record["peer_lost_at"], record["error"] = "peer-lost", time.time(), str(e)[:300]
        code = None
    finally:
        if registry is not None:
            # One last beat after the runner's final counter sync, then the
            # rank's registry for the aggregation comparison.
            heartbeat.beat()
            (checkpoint_dir / f"host_registry_{topo.process_index:04d}.json").write_text(
                json.dumps(registry.fleet_payload()))
        heartbeat.stop()
        update_record()
        if final is not None:
            record["final_rows_device"] = str(final.algorithm.pop.device)
        record_path.write_text(json.dumps(record))

    if code is None:
        # A survivor of a lost peer: wait for the supervisor's stop (which
        # may have come already, caught by either guard).
        deadline = time.monotonic() + PEER_LOSS_WAIT
        stopped = lambda: guard.triggered or runner.preemption.triggered  # noqa: E731
        while not stopped() and time.monotonic() < deadline:
            time.sleep(0.05)
        return EX_PREEMPTED if stopped() else 1
    if code == 0 and topo.process_index == 0:
        import numpy as np

        np.savez(checkpoint_dir / "final_state.npz", **final_payload(final))
        (checkpoint_dir / "final_summary.json").write_text(json.dumps({
            "attempt": attempt,
            "world": topo.num_processes,
            "resumed_from_generation": runner.stats.resumed_from_generation,
            "restarts": len(runner.stats.restarts),
            "completed_generations": runner.stats.completed_generations,
        }))
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv))
