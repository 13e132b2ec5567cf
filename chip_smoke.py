#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``evox_tpu_torch``) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds every kernel of the port from ``evox_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, drives the main paths
(PSO on Sphere at pop=100000, dim=1000, through ``StdWorkflow``, then the
README quick start, PSO on Ackley with an ``EvalMonitor``; NSGA-II on DTLZ2
at pop=10000, d=12, m=3, then the multi-objective example with an
``EvalMonitor(multi_obj=True)``; then the fused runs, ``run_segment`` and
``run`` as replayed CUDA graphs, on the PSO headline, PSO at pop=1024 on
Ackley and the NSGA-II headline, each against eager steps bit for bit;
RVEA on DTLZ2 at pop=10000 (9870 reference vectors), eager and fused, its
selection card against CPU; then NSGA-III at pop=10000 and RVEAa, MOEA/D
and HypE at pop=1000, eager and fused, and DTLZ1-7 card against CPU; then
the whole CEC2022 suite against its float64 oracle and the CPU, DE on
CEC2022 f5 at pop=10000, dim=20, and ODE, JaDE, SHADE, SaDE and CoDE at the
same width, eager and fused; then CMA-ES at pop=64 and OpenES at
pop=8192 on CEC2022 f1, dim=20, the covariance's decomposition on the card
against float64 on the CPU, the other ten ES algorithms, OpenES's
auxiliary history through a segment, and CMA-ES at dim=1000 with its
decomposition cadence, eager and fused, through the port's Jacobi
eigensolver (a device predicate skips the sweeps of the generations that
keep the cached factors); then CMA-ES at dim=64 and ASEBO at dim=100
fused, 4 vmapped CMA-ES(64) instances, CMA-ES(100) under the resilient
runner, and the eigensolver against its plain version and float64 on
the CPU (``cmaes_large_main_path``); then CSO, CLPSO, SL-PSO (GS, US), FS-PSO and
DMS-PSO-EL at the PSO headline's width, eager and fused; then 8 vmapped
instances of PSO at pop=1024, dim=100 on Ackley through the batched PSO
move and Philox launches, eager and as a replayed CUDA graph, each instance
against its solo run, with an unordered EvalMonitor; then 4 vmapped
instances each of NSGA-II, CMA-ES and DE through the sequential and
batched rules of the other kernels; then neuroevolution at the bench
width, OpenES at pop=2048 on cart-pole episodes of 200 steps with an MLP
4-32-32-1, eager (each rollout a replayed CUDA graph) and as run(20), the
rollout card against CPU; then pendulum, the hopper through BraxProblem,
PointMass through MujocoProblem and a supervised regression, eager and
fused; then the precision plane: the PSO headline and the NSGA-II headline
under PrecisionPolicy() (bfloat16 storage, float32 compute) with the rbg
key stream, eager and fused, with bench.py's accuracy gates, the PSO
headline in bfloat16 on the kernel's bfloat16 route, and the rbg twins of
both PSO headlines against their default twins; then the HPO nest
(``hpo_main_path``: bench.py's hpo_ladder, PSO(64) over 64 candidates of
OpenES(1024) on Sphere at dim 32, 32 inner generations an evaluation, each
evaluation a replayed CUDA graph of the vmapped batch, eager outer steps
and run(20); ``hpo_quickstart``: the README's DE(16) over
HPOProblemWrapper(iterations=25, num_instances=16) of PSO(30) at dim 8,
with a (w, phi_p, phi_g) row a candidate in the batched move, then with
num_repeats=3 under both aggregations); every candidate against its solo
run); then population-sharded evaluation over a one-rank NCCL group
(``distributed_main_path``: bench.py's distributed_8dev, PSO(8192) at dim
256 with ``enable_distributed=True``, the PSO headline through
``ShardedProblem`` and the NSGA-II headline with ``enable_distributed=True``,
eager and as run(20), whose captured graph holds the all-gather, each
against its unsharded twin bit for bit, the all-gather's device time from
the profiler, shard quarantine) and the checkpoint plane
(``checkpoint_main_path``: save, verify and load of the PSO headline's
state and pso_northstar_bf16's, seconds and GB/s, a resume after 10 of 20
generations against the uninterrupted run, the precision guards, the async
writer's cost to the generations it overlaps), then the resilient runner
(``resilient_main_path``: bench.py's pso_small_resilient, PSO(1024) at dim
100 on Ackley under ``ResilientRunner(checkpoint_every=25, fused=True)``
for 100 generations, against run(100) and eager steps bit for bit, with
its host syncs a segment, and the PSO headline under the runner with a
health probe and rollback, 1.2 GB checkpoints; ``resilient_recovery``:
kill and resume, a torn checkpoint, NaN/Inf rows in the captured
segments, a retried backend error, a watchdog trip, a real SIGTERM, each
bit-equal to the uninterrupted run; ``neuroevolution_resilient``;
``resilient_quickstart``: the README's runner quick start run twice), then
the control plane (``hpo_runner_main_path``: hpo_ladder under
``HPORunner(checkpoint_every=4)`` for 16 outer generations against run(16)
and eager steps bit for bit, its per-candidate inner histories against the
twin's telemetry, host syncs a segment, a SIGTERM and resume, with an
``IntrospectionEndpoint`` scraped throughout; ``hpo_grow``: the growth
ladder 1024 -> 2048 under a journaled ``Controller``, the memory around
it, a resume across it; ``controller_cadence``: pso_small_resilient under
self-tuning cadence, bit-equal to the controller-off run, and a journaled
trend restart), then the service core (``service_pack``: bench.py's
service_pack, 8 PSO(1024) tenants at dim 100 in one ``TenantPack`` whose
segment of 25 is one captured CUDA graph of vmapped lane-freeze
generations, every lane bit-equal to a width-1 pack and to eager steps,
one host read a segment, one capture across freeze, thaw, release and
admission; ``vmapped_instances_resilient``: the same tenants through
``torch.func.vmap(wf.run_segment)``, equal to the pack; ``service_main_path``:
``OptimizationService`` with a PSO bucket of 12 tenants under tenant-keyed
chaos and an OpenES bucket of 4, an eviction, restarts, quarantines, a
preemption resumed in a new service, each healthy tenant bit-equal to the
same tenant alone, and the README's service quick start), then the fleet
layer (``fleet_main_path``: a FleetSupervisor over 2 worker processes of
distributed_8dev's PSO on the card, ``tests/test_torch_fleet_worker.py``,
rank 1 SIGKILLed, the world relaunched on 1 and resumed bit-equal to an
uninterrupted 1-process fleet and to the run in this process, the beats'
metrics aggregated; ``fleet_straggler``: a slow rank quarantined through its
beat's deadline trips), then the serving daemon (``daemon_main_path``: a
``ServiceDaemon`` of service_pack's 8 tenants with budgets of 200, run
uninterrupted here, then in a cold process from a copy of the package with
an empty build directory, killed by ``os._exit`` after segment 3, and a
warm process that replays the journal, prewarms from the program cache with
no ``nvcc`` and finishes every tenant bit-equal to the uninterrupted
daemon; ``daemon_overload``: class budgets, structured sheds, a brown-out
and its return without a capture, the admitted tenants' gen/s against an
uncontended daemon's), then the service's HPO workload
(``service_hpo_main_path``: an ``OptimizationService`` with a bucket of 4
hpo_ladder tenants and a bucket of 2 CMA-ES(64) over PSO(1024) at dim 32
tenants, each pack segment one captured graph with the nests inline and one
launch a call of each kernel for the whole pack, every tenant bit-equal to
itself alone; ``service_hpo_grow``: a stagnating ladder regrown to 2048 and
re-keyed into the grown bucket, its decisions replayed from the journal;
``daemon_hpo_restart``: a daemon of two hpo_ladder tenants and a PSO tenant
killed in a process of its own and restarted in another from the program
cache), then the network front door (``gateway_main_path``: that daemon of
8 tenants behind a ``Gateway`` with two principals, submitted over HTTP by
four ``GatewayClient`` threads over ``FaultyTransport`` (a dropped request,
a dropped reply, a torn reply, a duplicate), CPU-built, card-built and
catalog specs, a second bucket captured mid-run while other submits are
decoded, a steer, results, checkpoint archives and a flight long-poll over
HTTP, every tenant bit-equal to the Python API's run; ``gateway_kill_restart``:
the daemon and gateway in a process of their own, SIGKILLed between the
journal append of a submit and its reply, the client's retry of that key
answered by a warm process on the same port as an idempotent replay;
``gateway_overhead``: per-tenant gen/s with and without a 1 Hz operator
process), then the tenant router (``router_main_path``: those 8 tenants
placed by a ``TenantRouter`` over two ``ServiceMember``s of 4 lanes, bucket
affinity, journal before each forward, a steer on both planes, member 1
declared dead from frozen beats and its tenants migrated, every tenant
bit-equal to the single daemon's run; ``router_kill_restart``: the router
and its members in a process of their own, SIGKILLed between the journaled
placement of the last submit and its forward, restarted warm with no
kernel build; ``router_overhead``: per-tenant gen/s routed against
direct), then the chaos plane (``chaos_main_path``: the JAX chaos suite's
acceptance plan of kills, wire, disk and lane faults and a partition over
three ``ServiceMember``s of daemon_main_path's tenants under a
``ChaosConductor``, zero invariant violations, its event journal equal to a
second run's and to a CPU run's, every tenant bit-equal to the same spec in
a fault-free daemon; ``chaos_soak``: ``tools/soak_torch.py``'s 1000-tenant
rung with a member kill, O(wave) disk and card memory, no capture a wave),
and, run after the multi-objective example, the visualization tools
(``vis_main_path``: the README quick start to its end, 100 eager steps and
``monitor.plot()`` without plotly and under a recording stand-in for
``plotly.graph_objects``; the NSGA-II headline's run(20) with every
history, plotted with DTLZ2's front and streamed to an ``.exv`` file read
back byte for byte; an ``evox_tpu_torch_ext`` plugin grafted at import in
a fresh process and stepped on the card), and last HPO instances split
over a mesh (``hpo_mesh_main_path``: hpo_ladder's candidates through
``ShardedProblem`` on a one-rank NCCL mesh and in two gloo processes
sharing the card, bit-equal to the unsharded nest) and the resilient
runner's CPU fallback from the card (``resilient_fallback``:
pso_small_resilient failing past its retries, ending on a CPU twin
bit-equal to a CPU workflow resumed from the segment's checkpoint); the
``timing`` phase also holds ``obs.xla.roofline`` of the move against this
script's own share of the HBM peak.  It checks that each path went
through its kernels, and times them.  It prints one JSON line per
phase, a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that last line.  It needs one card and
imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))

HEADLINE = (100_000, 1000)  # bench.py's pso_northstar: pop=100k, dim=1000
ROWS_SHAPE = (99_900, 1001)  # the headline's size with vectors of one element: the row layout
# (N, D, offset): the kernel's vector widths (float32 4 at D = 128, 384,
# 100, 1000, 1 at D = 37, 5; bfloat16 8, 4 at D = 100, 2 at D = 998, 1),
# its row layout (float32 D = 998, 1001, bfloat16 D = 1001) and, with
# offset 1, a contiguous view one row into a buffer, whose base is not
# 16-byte aligned (width 1).
COMPARE_SHAPES = [(100, 37, 0), (64, 128, 0), (30, 5, 0), (64, 384, 0), (64, 1001, 0), (40, 998, 0),
                  (1024, 100, 0), (100, 37, 1), (*HEADLINE, 0)]
MAIN_WARMUP, MAIN_STEPS, PROFILE_STEPS = 3, 20, 3
QUICKSTART_GENS = 50
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(tag: str, payload: dict) -> None:
    print(json.dumps({tag: payload}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ordered_bits(t):
    """Integers that order like the floats of ``t``, with -0 == +0, so a
    difference of k is k units in the last place of the dtype."""
    import torch

    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).to(torch.int64)
        mag = bits & 0x7FFF
    else:
        bits = t.view(torch.int32).to(torch.int64)
        mag = bits & 0x7FFFFFFF
    return torch.where(bits < 0, -mag, mag)


def compare(got, want) -> dict:
    """Max ulp distance and max abs error between two float tensors; NaN
    must sit at the same places in both."""
    import torch

    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError("NaN positions differ between kernel and plain version")
    ok = ~nan_w
    ulp = (ordered_bits(got) - ordered_bits(want)).abs()[ok]
    diff = (got.float() - want.float()).abs()[ok]
    diff = diff[torch.isfinite(diff)]
    return {
        "max_ulp": int(ulp.max()) if ulp.numel() else 0,
        "max_abs_err": float(diff.max()) if diff.numel() else 0.0,
    }


def move_inputs(n, d, dtype, seed, device, offset=0):
    """Inputs of one fused move, with NaN fitness rows, NaN and +inf
    personal bests, NaN positions and values beyond the bounds ±2.  With
    ``offset``, each (n, d) array is a view ``offset`` rows into an (n +
    offset, d) buffer."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    def to(x):
        x = x.to(dtype)
        if offset:
            buf = torch.empty((n + offset, d), dtype=dtype, device=device)
            buf[offset:] = x
            x = buf[offset:]
        return x

    pop = to(u(n, d) * 8 - 4)
    pop.view(-1)[:: max(1, (n * d) // 7)] = float("nan")
    fit = u(n)
    fit[::7] = float("nan")
    lbf = u(n)
    lbf[1::5] = float("inf")
    lbf[2::11] = float("nan")
    return dict(
        pop=pop,
        velocity=to(u(n, d) * 6 - 3),
        local_best_location=to(u(n, d) * 4 - 2),
        fit=fit.to(dtype),
        local_best_fit=lbf.to(dtype),
        global_best_location=(u(d) * 4 - 2).to(dtype),
        lb=torch.full((d,), -2.0, dtype=dtype, device=device),
        ub=torch.full((d,), 2.0, dtype=dtype, device=device),
        w=torch.tensor(0.6, dtype=dtype, device=device),
        phi_p=torch.tensor(2.5, dtype=dtype, device=device),
        phi_g=torch.tensor(0.8, dtype=dtype, device=device),
    ), (to(u(n, d)), to(u(n, d)))


def phase_compare(device) -> dict:
    """Kernel against plain version at every vector width, both draw modes,
    float32 and bfloat16: both must agree exactly (0 ulp; -0 == +0, NaN at
    the same places)."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain

    rows, worst = [], 0.0
    for dtype, limit in ((torch.float32, 0), (torch.bfloat16, 0)):
        for n, d, offset in COMPARE_SHAPES:
            args, draws = move_inputs(n, d, dtype, seed=n * 7919 + d, device=device, offset=offset)
            if offset and args["pop"].data_ptr() % 16 == 0:
                raise AssertionError("the offset view's base is 16-byte aligned")
            for rand in ("input", "hw"):
                kw = dict(seed=0x1234_5678_9ABC_DEF0 + n, rand=rand,
                          rand_draws=draws if rand == "input" else None)
                got = fused_pso_move(**args, **kw)
                want = fused_pso_move_plain(**args, **kw)
                torch.cuda.synchronize()
                for name, g_, w_ in zip(("pop", "velocity", "lbl", "lbf"), got, want):
                    if g_.shape != w_.shape or g_.dtype != w_.dtype:
                        raise AssertionError(f"{name}: {g_.shape}/{g_.dtype} vs {w_.shape}/{w_.dtype}")
                    c = compare(g_, w_)
                    if c["max_ulp"] > limit:
                        raise AssertionError(
                            f"fused_pso_move {dtype} ({n},{d}) rand={rand} {name}: "
                            f"{c['max_ulp']} ulp > {limit}"
                        )
                    worst = max(worst, c["max_abs_err"])
                    rows.append({"dtype": str(dtype).split(".")[-1], "shape": [n, d], "offset": offset,
                                 "rand": rand, "out": name, **c})
                del got, want
            del args, draws
            torch.cuda.empty_cache()
    by_shape = {}
    for r in rows:
        k = f"{r['dtype']} {r['shape'][0]}x{r['shape'][1]}" + (f"+{r['offset']}" if r["offset"] else "")
        by_shape[k] = max(by_shape.get(k, 0), r["max_ulp"])
    return {"checks": len(rows), "max_abs_err": worst,
            "max_ulp_f32": max(r["max_ulp"] for r in rows if r["dtype"] == "float32"),
            "max_ulp_bf16": max(r["max_ulp"] for r in rows if r["dtype"] == "bfloat16"),
            "max_ulp_by_shape": by_shape}


def phase_draws(device) -> dict:
    """In-kernel draws at the headline shape: with w=0, phi_p=1, phi_g=0,
    x=0, lbl=1 the new velocity is rp exactly (and rg with phi_p=0, phi_g=1,
    gbl=1).  Checks range [0, 1), mean and variance of the discrete uniform
    k/2^m and the rp/rg correlation, each within 6 standard errors of its
    expected value (at 1e8 draws: 1.7e-4 on the mean, 4.5e-5 on the
    variance, 6e-4 on the correlation), and that another seed gives another
    stream (equal share < 4 * 2^-m)."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    n, d = HEADLINE
    numel = n * d
    out = {}
    for dtype, m in ((torch.float32, 24), (torch.bfloat16, 7)):
        z = torch.zeros((n, d), dtype=dtype, device=device)
        one = torch.ones((n, d), dtype=dtype, device=device)

        def vec(v, size):
            return torch.full((size,), v, dtype=dtype, device=device)

        def draw(seed, which):
            lbl, gbl = (one, vec(0.0, d)) if which == "rp" else (z, vec(1.0, d))
            pp, pg = (1.0, 0.0) if which == "rp" else (0.0, 1.0)
            s = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
            _, vel, _, _ = fused_pso_move(
                z, z, lbl, vec(float("inf"), n), vec(0.0, n), gbl,
                vec(-10.0, d), vec(10.0, d), s(0.0), s(pp), s(pg), seed=seed,
            )
            return vel

        rp, rg, rp2 = draw(11, "rp"), draw(11, "rg"), draw(12, "rp")
        stats = {}
        for name, r in (("rp", rp), ("rg", rg)):
            x = r.double()
            mean, var = float(x.mean()), float(x.var())
            lo, hi = float(x.min()), float(x.max())
            want_mean, want_var = (1 - 2.0**-m) / 2, (1 - 2.0 ** (-2 * m)) / 12
            if not (lo >= 0.0 and hi < 1.0):
                raise AssertionError(f"{dtype} {name} outside [0, 1): [{lo}, {hi}]")
            if abs(mean - want_mean) > 6 * (1 / 12 / numel) ** 0.5 or abs(
                var - want_var
            ) > 6 * (1 / 180 / numel) ** 0.5:
                raise AssertionError(f"{dtype} {name} moments {mean}, {var}")
            stats[name] = {"min": lo, "max": hi, "mean": mean, "var": var}
        a, b = rp.double(), rg.double()
        corr = float(((a - a.mean()) * (b - b.mean())).mean() / (a.std() * b.std()))
        same = float((rp == rp2).double().mean())
        if abs(corr) > 6 / numel**0.5:
            raise AssertionError(f"{dtype} rp/rg correlation {corr}")
        if same > 4 * 2.0**-m:
            raise AssertionError(f"{dtype} seeds 11 and 12 agree on {same:.4f} of draws")
        out[str(dtype).split(".")[-1]] = {**stats, "corr_rp_rg": corr, "equal_share_other_seed": same}
        del z, one, rp, rg, rp2, a, b
        torch.cuda.empty_cache()
    return out


def profile_steps(step, state, steps):
    """Device time by kernel over ``steps`` generations of ``step``
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3 / steps
    # Kernel names cut to 80 characters; kernels whose names share those
    # add up (a dict keyed by the cut name kept only the last of them).
    named = {}
    for k, v in kernels.items():
        named[k[:80]] = named.get(k[:80], 0.0) + v
    top = sorted(named.items(), key=lambda kv: -kv[1])[:12]
    busy = sum(kernels.values())
    return state, {
        "steps": steps,
        "wall_ms_per_gen_profiled": wall_ms / steps,
        "device_ms_per_gen": busy if kernels else "not measured",
        "kernels_ms_per_gen": dict(top),
    }


def phase_main_path(device) -> dict:
    """bench.py's headline through the port: StdWorkflow(PSO(100000, ±10 in
    dim 1000), Sphere()), init_step then warm-up, timed and profiled steps.
    The best fitness must fall, and every step must launch the kernel."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    n, d = HEADLINE
    lb = torch.full((d,), -10.0, device=device)
    ub = torch.full((d,), 10.0, device=device)
    wf = StdWorkflow(PSO(n, lb, ub, device=device), Sphere())
    torch.cuda.reset_peak_memory_stats()
    fused_pso_move.launches = 0
    philox_draws.launches = 0
    t0 = time.perf_counter()
    state = wf.init(0)
    state = wf.init_step(state)
    best0 = float(state.algorithm.global_best_fit)
    setup_s = time.perf_counter() - t0
    setup_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(MAIN_WARMUP):
        state = wf.step(state)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(MAIN_STEPS):
        state = wf.step(state)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / MAIN_STEPS
    ms = start.elapsed_time(end) / MAIN_STEPS
    state, prof = profile_steps(wf.step, state, PROFILE_STEPS)
    launches = fused_pso_move.launches
    # The setup's two draws (positions and velocities); the steps draw in
    # the move kernel.
    if philox_draws.launches != 2:
        raise AssertionError(f"philox_draws launched {philox_draws.launches} times in the setup, expected 2")
    steps = MAIN_WARMUP + MAIN_STEPS + PROFILE_STEPS
    algo = state.algorithm
    best1 = float(torch.minimum(algo.global_best_fit, algo.fit.min()))
    if launches != steps:
        raise AssertionError(f"fused_pso_move launched {launches} times in {steps} steps")
    if not best1 < best0:
        raise AssertionError(f"best fitness did not fall: {best0} -> {best1}")
    if algo.pop.shape != (n, d) or algo.fit.shape != (n,):
        raise AssertionError("wrong state shapes")
    if not (bool(torch.isfinite(algo.pop).all()) and bool(torch.isfinite(algo.fit).all())):
        raise AssertionError("non-finite population or fitness")
    return {
        "config": "PSO pop=100000 dim=1000 Sphere f32, StdWorkflow, no monitor",
        "launches": launches, "philox_launches": philox_draws.launches, "steps": steps,
        "ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms,
        "setup_s": setup_s, "best_after_init": best0, "best_final": best1,
        "setup_peak_mem_gb": setup_peak_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": prof,
    }


def quickstart(device, gens):
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    mon = EvalMonitor(topk=3)
    wf = StdWorkflow(
        PSO(100, -32 * torch.ones(10), 32 * torch.ones(10), device=device),
        Ackley(), monitor=mon,
    )
    state = wf.init_step(wf.init(42))
    best0 = float(mon.get_best_fitness(state.monitor))
    for _ in range(gens):
        state = wf.step(state)
    return mon, state, best0


def phase_quickstart(device) -> dict:
    """README quick start on the card: PSO pop=100, dim=10, Ackley,
    EvalMonitor(topk=3), 50 generations; the best fitness must improve more
    than 10x.  Then the same run for 3 generations on the card and on the
    CPU (plain versions; the draws are the same Philox bits) must agree
    within rtol 1e-4 / atol 1e-5 (the problem's sums run in another
    order)."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    fused_pso_move.launches = 0
    mon, state, best0 = quickstart(device, QUICKSTART_GENS)
    best = float(mon.get_best_fitness(state.monitor))
    launches = fused_pso_move.launches
    if launches != QUICKSTART_GENS:
        raise AssertionError(f"quick start launched {launches} kernels in {QUICKSTART_GENS} steps")
    if not best * 10 < best0:
        raise AssertionError(f"quick start improved only {best0} -> {best}")
    if len(mon.fitness_history) != QUICKSTART_GENS + 1:
        raise AssertionError("fitness history length")
    _, s_gpu, _ = quickstart(device, 3)
    _, s_cpu, _ = quickstart("cpu", 3)
    worst = 0.0
    for k in ("pop", "velocity", "local_best_location", "local_best_fit", "fit", "global_best_fit"):
        a, b = s_gpu.algorithm[k].cpu(), s_cpu.algorithm[k]
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        worst = max(worst, float((a - b).abs().max()))
    return {"launches": launches, "best_after_init": best0, "best_final": best,
            "improvement": best0 / best, "cpu_vs_card_max_abs_diff": worst}


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(device) -> dict:
    """Kernel and plain version at the headline shape, both dtypes and draw
    modes, timed with CUDA events; each (N, D) array is 200-400 MB, far
    beyond the 50 MB L2, so every launch reads from device memory.  Then
    the in-kernel-draw route of both dtypes at (99900, 1001), whose vectors
    are one element wide, the kernel's row layout (``ROWS_SHAPE``), and the
    batched route at vmapped_instances' shape.  Each bound is
    :func:`move_bound` of the inputs timed."""
    import torch
    from evox_tpu_torch.ops.pso_step import (
        _launch_plan,
        fused_pso_move,
        fused_pso_move_batched,
        fused_pso_move_batched_plain,
        fused_pso_move_plain,
    )
    from evox_tpu_torch.utils import rng

    n, d = HEADLINE
    out = {}
    # A device key, as the path's: an integer seed is copied to the card
    # on every call, which waits for the host.
    seed = rng.child(rng.key(99, device))
    for dtype in (torch.float32, torch.bfloat16):
        args, draws = move_inputs(n, d, dtype, seed=5, device=device)
        size = torch.tensor([], dtype=dtype).element_size()
        key = str(dtype).split(".")[-1]
        kept = kept_rows(args["fit"], args["local_best_fit"])
        for rand in ("hw", "input"):
            kw = dict(seed=seed, rand=rand, rand_draws=draws if rand == "input" else None)
            out[f"{key}_{rand}"] = {
                "ms": time_ms(lambda: fused_pso_move(**args, **kw), 20),
                "plain_ms": time_ms(lambda: fused_pso_move_plain(**args, **kw), 3, warmup=1),
                "kept_rows": kept, **move_bound(1, n, d, size, kept, rand),
            }
            torch.cuda.empty_cache()
        del args, draws
        torch.cuda.empty_cache()
    n, d = ROWS_SHAPE
    for dtype in (torch.float32, torch.bfloat16):
        args, _ = move_inputs(n, d, dtype, seed=5, device=device)
        size = torch.tensor([], dtype=dtype).element_size()
        kept = kept_rows(args["fit"], args["local_best_fit"])
        if not _launch_plan(1, n, d, dtype, [args["pop"].data_ptr()], 1, lambda *_: 1).rows:
            raise AssertionError(f"fused_pso_move: ({n}, {d}) {dtype} does not take the row layout")
        out[f"{str(dtype).split('.')[-1]}_hw_rows"] = {
            "shape": [n, d],
            "ms": time_ms(lambda: fused_pso_move(**args, seed=seed), 20),
            "plain_ms": time_ms(lambda: fused_pso_move_plain(**args, seed=seed), 3, warmup=1),
            "kept_rows": kept, **move_bound(1, n, d, size, kept, "hw"),
        }
        del args
        torch.cuda.empty_cache()
    # The batched route at vmapped_instances' shape, launch-bound: the
    # profiler's device time is the kernel's own.
    b, (n, d) = VMAP_INSTANCES, VMAP_PSO
    keys = torch.stack([rng.key(99 + i, device) for i in range(b)])
    for dtype in (torch.float32, torch.bfloat16):
        args = batched_move_args(b, n, d, dtype, device) + (keys,)
        key = str(dtype).split(".")[-1]
        kept = kept_rows(args[3], args[4])
        out[f"batched_{key}_hw"] = {
            "shape": [b, n, d],
            "ms": time_ms(lambda: fused_pso_move_batched(*args), 50),
            "device_ms": launches_per_call(lambda: fused_pso_move_batched(*args), calls=20)["device_ms"],
            "plain_ms": time_ms(lambda: fused_pso_move_batched_plain(*args), 5),
            "kept_rows": kept, **move_bound(b, n, d, torch.tensor([], dtype=dtype).element_size(), kept, "hw"),
        }
    out["roofline"] = roofline_check(out["float32_hw"], device)
    return out


def roofline_check(move, device) -> dict:
    """``obs.xla.roofline`` of the PSO headline's move (float32, in-kernel
    draws): ``move_bound``'s bytes and float operations at the measured
    calls per second, at the module's default peaks (the card's).  Its
    ``pct_of_hbm_peak`` must equal this script's own share of
    ``PEAK_BYTES_PER_S`` to the rounding (0.05 points), and a captured CUDA
    graph has no cost model: ``program_costs``/``program_memory`` None."""
    import torch
    from evox_tpu_torch.obs import xla as obs_xla

    n, d = HEADLINE
    calls_per_s = 1e3 / move["ms"]
    roof = obs_xla.roofline(flops_per_gen=16 * n * d + n, bytes_per_gen=move["bytes"], gen_per_sec=calls_per_s)
    share = 100 * move["bytes"] * calls_per_s / PEAK_BYTES_PER_S
    if obs_xla.DEFAULT_HBM_PEAK_GBPS * 1e9 != PEAK_BYTES_PER_S or obs_xla.DEFAULT_FLOP_PEAK_TFLOPS * 1e12 != PEAK_F32_FLOPS:
        raise AssertionError(f"obs.xla's peaks {obs_xla.DEFAULT_HBM_PEAK_GBPS} GB/s, "
                             f"{obs_xla.DEFAULT_FLOP_PEAK_TFLOPS} TFLOP/s are not the card's")
    if abs(roof["pct_of_hbm_peak"] - share) > 0.05 + 1e-9:
        raise AssertionError(f"obs.xla.roofline's {roof['pct_of_hbm_peak']} % of the HBM peak, this script's {share} %")
    x = torch.ones(1024, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        x * 2
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x * 2
    if (obs_xla.program_costs(g), obs_xla.program_memory(g), obs_xla.program_analysis(g)) != (None, None, {}):
        raise AssertionError("obs.xla reads a cost model from a captured CUDA graph")
    return {"roofline": roof, "script_pct_of_hbm_peak": share, "graph_costs": None}


def batched_move_args(b, n, d, dtype, device):
    """The operands of a batched move but its keys: ``b`` instances of
    ``move_inputs`` (each its own seed) stacked, bounds shared, the
    scalars a (b, 3) float32 row each."""
    import torch

    inst = [move_inputs(n, d, dtype, seed=7 + i, device=device)[0] for i in range(b)]
    stack = [torch.stack([x[k] for x in inst]) for k in
             ("pop", "velocity", "local_best_location", "fit", "local_best_fit", "global_best_location")]
    scal = torch.stack([torch.stack([x[k].float() for k in ("w", "phi_p", "phi_g")]) for x in inst])
    return (*stack, inst[0]["lb"], inst[0]["ub"], scal)


def kept_rows(fit, local_best_fit) -> int:
    """Rows whose local best the move reads: those the fold does not
    improve.  An improved row's local best becomes its position, and the
    kernel does not read it."""
    return int((~(fit.float() < local_best_fit.float())).sum())


def move_bound(b, n, d, size, kept, rand) -> dict:
    """The bound of a move of ``b`` instances of (``n``, ``d``), elements of
    ``size`` bytes, whose fold keeps the local best of ``kept`` rows: the
    larger of the bytes over the memory rate and the operations.  Bytes,
    each once: position and velocity read, the three (b, n, d) outputs
    written, the local best of the kept rows read, with ``rand="input"``
    the two draws; fitness and local best fitness read and the new one
    written, the global best, bounds shared by the instances, the float32
    scalars and, with ``rand="hw"``, the int64 keys.  Operations: the float
    operations (16 an element and the fold's compare a row) over the
    float32 rate, plus, with ``rand="hw"``, one Philox4x32-10 evaluation an
    element with two of its words put in final form over the lane rate (its
    two uniforms come from one evaluation)."""
    elements = b * n * d
    arrays = 5 + (2 if rand == "input" else 0)
    nbytes = size * (arrays * elements + kept * d + 3 * b * n + b * d + 2 * d) + 12 * b
    nbytes += 16 * b if rand == "hw" else 0
    draw_ops = elements * (PHILOX_OPS + 2 * PHILOX_OPS_PER_OUT) if rand == "hw" else 0
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (16 * elements + b * n) / PEAK_F32_FLOPS * 1e3 + draw_ops / PEAK_LANE_OPS * 1e3
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "draw_ops": draw_ops,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# ---------------------------------------------------------------------------
# Slice 2: NSGA-II on DTLZ2 and its kernels (dominance, lex_rank, crowding,
# the capability probe).
# ---------------------------------------------------------------------------

NSGA2_POP, NSGA2_DIM, NSGA2_OBJ = 10_000, 12, 3  # bench.py's nsga2_dtlz2
MO_SIZES = [1, 2, 33, 1000, 20_000, 50_000]
# The radix kernels' crossover: their one-block route's largest n, then the
# multi-block route; compare_mo adds these offsets from it to MO_SIZES.
CROSSOVER_OFFSETS = (-1, 0, 1)
MO_EXAMPLE_GENS = 30
# The crowding kernel's (costs, mask) at init_step and at the last timed
# step of the NSGA-II headline, set by that phase and timed by timing_mo.
PATH_INPUTS: dict = {}
# bench.py's large shapes: packed dominance at 100k rows, crowding_50k and
# topk_50k at 50k.
BIG_DOMINANCE, BIG_CROWDING = 100_000, 50_000
# Lane operations a second: 132 SMs x 128 lanes x ~1.98 GHz (compare,
# select and logic operations each count one).
PEAK_LANE_OPS = 132 * 128 * 1.98e9


def mo_costs(n, m, device, seed, specials=True):
    """Quantized objectives (heavy ties) with ±inf entries and NaN rows."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    f = torch.round(torch.rand((n, m), generator=g, device=device) * 16) / 16
    if specials and n > 8:
        f[3, 0] = float("inf")
        f[5, m - 1] = float("-inf")
        f[7] = float("nan")
        f[n - 2, 0] = float("nan")
    return f.contiguous()


def drift_inputs(n, m, device):
    """bench.py's crowding_50k / topk_50k recipe (normal noise plus a
    linear drift, quantized to 1/64), rebuilt in PyTorch."""
    import torch

    g = torch.Generator(device=device).manual_seed(0)
    f = torch.randn((n, m), generator=g, device=device)
    f = f + torch.linspace(0.0, 3.0, n, device=device)[:, None]
    return (torch.round(f * 64) / 64).contiguous()


def exact(got, want, what) -> float:
    """Raise unless the values are equal (floats bit for bit, signed zeros
    included, NaN at the same places); return the largest absolute
    difference, NaN places left out (equal infinities differ by 0)."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{list(got.shape)} vs {want.dtype}{list(want.shape)}")
    if got.is_floating_point():
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError(f"{what}: NaN positions differ")
        ok = ~torch.isnan(want)
        g, w = got[ok].double(), want[ok].double()
        diff = torch.where(g == w, 0.0, (g - w).abs())
    else:
        diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if err != 0.0 or (got.is_floating_point() and not torch.equal(
            torch.signbit(got[~torch.isnan(got)]), torch.signbit(want[~torch.isnan(want)]))):
        raise AssertionError(f"{what}: values differ (max abs difference {err})")
    return err


def phase_compare_mo(device) -> dict:
    """Each multi-objective kernel against its plain version on the card,
    exactly: equal ints and bits, equal floats, NaN at the same places.
    Sizes 1, 2, 33, 1000, 20000 and 50000, and for lex_rank and crowding
    also the radix kernels' crossover ±1; m in {2, 3}, ties, ±inf, NaN
    rows, masks with no, one, some and all rows valid; lex_rank in int32
    and float32 with k in {1, n/2, n}; the packed words in float32 and
    float64, and the generic kernel (m = 5); peel_fronts with until_count
    in {None, 1, n/2, n}, and its design's own cases (``peel_cases``,
    ``captured_peel``).  Then the capability probe."""
    import torch
    from evox_tpu_torch.ops import crowding, dominance, probe, topk

    # The largest absolute difference from the plain version, by wrapper
    # (crowding_distance_kernel under crowding_neighbors, masked_top_k
    # under lex_rank: each runs that kernel).
    errs = {k: 0.0 for k in ("dominance_packed", "dominance_matrix", "peel_fronts",
                             "crowding_neighbors", "lex_rank", "scale_by_two")}
    checks = 0

    def check(kernel, got, want, what):
        nonlocal checks
        errs[kernel] = max(errs[kernel], exact(got, want, what))
        checks += 1

    cap = topk.radix_capacity()
    for n in MO_SIZES + [cap + d for d in CROSSOVER_OFFSETS]:
        for m in (2, 3):
            f = mo_costs(n, m, device, seed=n * 10 + m)
            masks = {
                "none": torch.zeros(n, dtype=torch.bool, device=device),
                "one": torch.arange(n, device=device) == n // 2,
                "some": torch.rand(n, device=device) > 0.3,
                "all": torch.ones(n, dtype=torch.bool, device=device),
            }
            for kind, mask in masks.items():
                for g, w in zip(crowding.crowding_neighbors(f, mask), crowding.crowding_neighbors_plain(f, mask)):
                    check("crowding_neighbors", g, w, f"crowding_neighbors n={n} m={m} mask={kind}")
                check("crowding_neighbors", crowding.crowding_distance_kernel(f, mask),
                      crowding.crowding_distance_plain(f, mask), f"crowding_distance n={n} m={m} mask={kind}")
            if n not in MO_SIZES:
                continue  # the crossover sizes are the sort kernels' only
            words = dominance.dominance_packed(f)
            check("dominance_packed", words, dominance.dominance_packed_plain(f), f"dominance_packed n={n} m={m}")
            check("dominance_packed", dominance.dominance_packed(f.double()),
                  dominance.dominance_packed_plain(f.double()), f"dominance_packed f64 n={n} m={m}")
            for u in (None, 1, n // 2, n):
                check("peel_fronts", dominance.peel_fronts(words, u), dominance.peel_fronts_plain(words, u),
                      f"peel_fronts n={n} m={m} until_count={u}")
            check("dominance_matrix", dominance.dominance_matrix(f), dominance.dominance_matrix_plain(f),
                  f"dominance_matrix n={n}")
            check("dominance_matrix", dominance.dominance_matrix(f.double()),
                  dominance.dominance_matrix_plain(f.double()), f"dominance_matrix f64 n={n}")
            del words
        if n in MO_SIZES:
            # The generic words kernel (m outside 2-4).
            f5 = mo_costs(n, 5, device, seed=n * 10 + 5)
            check("dominance_packed", dominance.dominance_packed(f5), dominance.dominance_packed_plain(f5),
                  f"dominance_packed n={n} m=5")
            del f5
        ranks = torch.randint(0, 40, (n,), device=device, dtype=torch.int32)
        for v in (ranks, mo_costs(n, 1, device, seed=n)[:, 0].contiguous()):
            check("lex_rank", topk.lex_rank(v), topk.lex_rank_plain(v), f"lex_rank n={n} {v.dtype}")
            mask = torch.rand(n, device=device) > 0.3
            for k in sorted({1, max(1, n // 2), n}):
                for mk in (None, mask):
                    for g, w in zip(topk.masked_top_k(v, k, mk), topk.masked_top_k_plain(v, k, mk)):
                        check("lex_rank", g, w, f"masked_top_k n={n} k={k} {v.dtype}")
        torch.cuda.empty_cache()
    for what, words, u in peel_cases(device):
        check("peel_fronts", dominance.peel_fronts(words, u), dominance.peel_fronts_plain(words, u), what)
    for u in (None, NSGA2_POP):
        for k, (got, want) in enumerate(captured_peel(device, u)):
            check("peel_fronts", got, want, f"peel_fronts captured, replay {k}, until_count={u}")
    torch.cuda.empty_cache()
    # Values up to 3e38, so the largest double to +inf.
    x = mo_costs(8 * 128, 1, device, seed=3).reshape(8, 128) * 3e38
    check("scale_by_two", probe.scale_by_two(x), probe.scale_by_two_plain(x), "scale_by_two")
    torch.cuda.synchronize()
    result = probe.run_capability_probe()
    if not result.get("ok"):
        raise AssertionError(f"capability probe failed: {result}")
    return {"checks": checks, "max_abs_err": errs, "probe": result}


# The front peel's design cases (csrc/dominance.cu): n not a
# multiple of 32 (a partial last tile) nor of 4 (loads of 2 words: 130,
# 20,002; of one: 31, 33, 127, 129, 4095, 4097, 20,001), a multiple of 4
# but not of 32 (132, 20,004); a total order of PEEL_TOTAL_ORDER rows.
PEEL_EDGE_SIZES = [31, 33, 127, 129, 130, 132, 4095, 4097, 20_001, 20_002, 20_004]
PEEL_TOTAL_ORDER = 4096


def peel_cases(device):
    """(what, words, until_count) of the peel's design cases: every load
    width and partial tiles, with until_count None, 0, n / 2, n and n + 1;
    every column in front 0 (20,000 points on a line); a total order (a
    front a row: a barrier a front); NaN rows."""
    import torch
    from evox_tpu_torch.ops import dominance

    for n in PEEL_EDGE_SIZES:
        words = dominance.dominance_packed(mo_costs(n, 3, device, seed=n + 17))
        for u in (None, 0, n // 2, n, n + 1):
            yield f"peel_fronts n={n} until_count={u}", words, u
    x = torch.linspace(0, 1, 2 * NSGA2_POP, device=device)
    words = dominance.dominance_packed(torch.stack([x, 1 - x], 1))
    for u in (None, NSGA2_POP):
        yield f"peel_fronts one front of {2 * NSGA2_POP} until_count={u}", words, u
    g = torch.Generator(device=device).manual_seed(4)
    order = torch.randperm(PEEL_TOTAL_ORDER, generator=g, device=device).float()
    words = dominance.dominance_packed(torch.stack([order, 2 * order], 1))
    for u in (None, PEEL_TOTAL_ORDER // 2):
        yield f"peel_fronts total order of {PEEL_TOTAL_ORDER} until_count={u}", words, u
    for n in (33, 2049, 2 * NSGA2_POP):
        f = mo_costs(n, 3, device, seed=n + 5)
        f[::7, 1] = float("nan")
        f[::13] = float("nan")
        words = dominance.dominance_packed(f)
        for u in (None, n // 2):
            yield f"peel_fronts NaN rows n={n} until_count={u}", words, u


def captured_peel(device, until_count):
    """A peel at the NSGA-II path's 20,000 columns captured in a CUDA graph
    and replayed on the words of two other inputs copied into its buffer:
    each replay's ranks and the plain version's on those words."""
    import torch
    from evox_tpu_torch.ops import dominance

    n = 2 * NSGA2_POP
    words = dominance.dominance_packed(mo_costs(n, 3, device, seed=1))
    dominance.peel_fronts(words, until_count)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rank = dominance.peel_fronts(words, until_count)
    out = []
    for seed in (2, 3):
        words.copy_(dominance.dominance_packed(drift_inputs(n, 3, device) * seed))
        graph.replay()
        torch.cuda.synchronize()
        out.append((rank.clone(), dominance.peel_fronts_plain(words, until_count)))
    return out


def mo_counters():
    from evox_tpu_torch.ops import crowding, dominance, philox, topk

    return {
        "dominance_packed": dominance.dominance_packed,
        "peel_fronts": dominance.peel_fronts,
        "lex_rank": topk.lex_rank,
        "crowding_neighbors": crowding.crowding_neighbors,
        "dominance_matrix": dominance.dominance_matrix,
        "philox_draws": philox.philox_draws,
    }


def time_draws(device, reps=5) -> dict:
    """The three Philox draw calls of one generation, alone: host clock
    (enqueue and launch cost) and CUDA events (device time)."""
    import torch
    from evox_tpu_torch.operators.crossover.sbx import sbx_draws
    from evox_tpu_torch.operators.mutation.pm_mutation import pm_draws
    from evox_tpu_torch.utils import rng

    keys = [rng.key(s, device) for s in (1, 2, 3)]

    def draws():
        sbx_draws(keys[0], (NSGA2_POP // 2, NSGA2_DIM), torch.float32, device)
        pm_draws(keys[1], (NSGA2_POP, NSGA2_DIM), torch.float32, device)
        rng.randint(rng.child(keys[2]), (NSGA2_POP, 2), 0, 2 * NSGA2_POP, device)

    draws()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_ms = time_ms(draws, reps, warmup=0)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    return {"host_ms": host_ms, "device_ms": device_ms}


def phase_nsga2_main_path(device) -> dict:
    """bench.py's nsga2_dtlz2 through the port: StdWorkflow(NSGA2(10000, 3,
    zeros(12), ones(12)), DTLZ2(d=12, m=3)), float32, no monitor; init_step,
    warm-up, timed and profiled steps.  Every kernel of the path must
    launch as often as the generation needs it (one peel_fronts a ranking,
    one Philox draw for each of the three operators), IGD must fall, survivor selection on the last timed
    step's inputs must make no host sync and equal the CPU route's bit for
    bit."""
    import torch
    from evox_tpu_torch.algorithms.mo import nsga2
    from evox_tpu_torch.metrics import igd
    from evox_tpu_torch.operators.selection import non_dominate

    counters = mo_counters()
    wf, problem, _ = mo_workflow("NSGA2", NSGA2_POP, device)
    pf = problem.pf()
    # The crowding kernel's inputs as the path gives them (the merged
    # objectives and the boundary-front mask), kept for timing_mo, and the
    # survivor selection's (merged population, merged objectives).
    seen, merged = [], []
    distance = non_dominate.crowding_distance_kernel
    select = nsga2.nd_environmental_selection

    def recording(costs, mask=None):
        full = torch.ones(costs.shape[0], dtype=torch.bool, device=costs.device)
        seen[:] = [(costs, full if mask is None else mask)]
        return distance(costs, mask)

    def recording_selection(x, f, topk):
        merged[:] = [(x, f)]
        return select(x, f, topk)

    def fronts_ranked(rank_max):
        # The survivors hold every front ranked (the last one in part).
        return int(rank_max) + 1

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    non_dominate.crowding_distance_kernel = recording
    nsga2.nd_environmental_selection = recording_selection
    try:
        t0 = time.perf_counter()
        state = wf.init_step(wf.init(0))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        init_launches = {k: c.launches for k, c in counters.items()}
        PATH_INPUTS["init"] = seen[0]
        init_fronts = fronts_ranked(state.algorithm.rank.max())
        igd0 = float(igd(state.algorithm.fit, pf))

        rank_max = []  # each step's largest surviving rank, read after the run

        def step(s):
            s = wf.step(s)
            rank_max.append(s.algorithm.rank.max())
            return s

        for _ in range(MAIN_WARMUP):
            state = step(state)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(MAIN_STEPS):
            state = step(state)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / MAIN_STEPS
        ms = start.elapsed_time(end) / MAIN_STEPS
        PATH_INPUTS["last_timed_step"] = seen[0]
        PATH_INPUTS["selection"] = merged[0]
        state, prof = profile_steps(step, state, PROFILE_STEPS)
    finally:
        non_dominate.crowding_distance_kernel = distance
        nsga2.nd_environmental_selection = select
    fronts = [fronts_ranked(r) for r in rank_max]
    timed_fronts = fronts[MAIN_WARMUP:MAIN_WARMUP + MAIN_STEPS]
    steps = MAIN_WARMUP + MAIN_STEPS + PROFILE_STEPS
    launches = {k: c.launches for k, c in counters.items()}
    # Launches each step needs: one dominance_packed, one peel_fronts, one
    # lex_rank, one crowding_neighbors, three Philox draws (tournament, SBX,
    # mutation); init_step: one dominance_packed, one peel_fronts, one
    # crowding_neighbors; the setup one draw (the first population).
    want = {
        "dominance_packed": 1 + steps,
        "peel_fronts": 1 + steps,
        "lex_rank": steps,
        "crowding_neighbors": 1 + steps,
        "dominance_matrix": 0,
        "philox_draws": 1 + 3 * steps,
    }
    for k, v in want.items():
        if launches[k] != v:
            raise AssertionError(f"{k} launched {launches[k]} times, expected {v} ({steps} steps + init)")
    # Survivor selection on the last timed step's inputs: device operations
    # and host syncs per call, and bit for bit the CPU route's survivors.
    x_m, f_m = PATH_INPUTS["selection"]
    selection = launches_per_call(lambda: non_dominate.nd_environmental_selection(x_m, f_m, NSGA2_POP), calls=3)
    if selection["host_syncs"] != 0:
        raise AssertionError(f"survivor selection made host syncs: {selection}")
    got = non_dominate.nd_environmental_selection(x_m, f_m, NSGA2_POP)
    want_cpu = non_dominate.nd_environmental_selection(x_m.cpu(), f_m.cpu(), NSGA2_POP)
    for name, g, w in zip(("x", "f", "rank", "dis"), got, want_cpu):
        exact(g.cpu(), w, f"survivor selection {name}, card vs CPU")
    per_gen = launches_per_call(lambda: wf.step(state), calls=3)
    algo = state.algorithm
    igd1 = float(igd(algo.fit, pf))
    if not igd1 < igd0:
        raise AssertionError(f"IGD did not fall: {igd0} -> {igd1}")
    if algo.pop.shape != (NSGA2_POP, NSGA2_DIM) or algo.fit.shape != (NSGA2_POP, NSGA2_OBJ):
        raise AssertionError("wrong state shapes")
    if not bool(torch.isfinite(algo.pop).all()) or not bool(torch.isfinite(algo.fit).all()):
        raise AssertionError("non-finite population or fitness")
    if float(algo.pop.min()) < 0.0 or float(algo.pop.max()) > 1.0 or int(algo.rank.min()) < 0:
        raise AssertionError("population outside [0, 1] or negative rank")
    draws = time_draws(device)
    return {
        "config": "NSGA2 pop=10000 d=12 m=3 DTLZ2 f32, StdWorkflow, no monitor",
        "steps": steps, "launches": launches, "init_launches": init_launches,
        "ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms,
        "fronts_per_gen": {"timed_mean": sum(timed_fronts) / len(timed_fronts),
                           "first": fronts[0], "last_timed": timed_fronts[-1],
                           "init": init_fronts},
        "selection": {"launches_per_call": selection["launches"], "host_syncs_per_gen": selection["host_syncs"],
                      "device_ms": selection["device_ms"], "equal_to_cpu_route": True},
        "per_gen": {k: per_gen[k] for k in ("launches", "host_syncs", "device_ms")},
        "draws": {**draws, "share_of_host_ms": draws["host_ms"] / host_ms},
        "setup_s": setup_s, "igd_after_init": igd0, "igd_final": igd1,
        "crowding_valid_rows": {k: int(PATH_INPUTS[k][1].sum()) for k in ("init", "last_timed_step")},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile": prof,
    }


def mo_example(device, gens):
    from evox_tpu_torch.metrics import igd
    from evox_tpu_torch.workflows import EvalMonitor

    mon = EvalMonitor(multi_obj=True)
    wf, problem, _ = mo_workflow("NSGA2", 128, device, monitor=mon)
    pf = problem.pf()
    state = wf.init_step(wf.init(0))
    igds = {}
    for gen in range(gens):
        state = wf.step(state)
        if (gen + 1) % 10 == 0:
            igds[gen + 1] = float(igd(mon.get_latest_fitness(state.monitor), pf))
    return mon, state, igds


def phase_mo_example(device) -> dict:
    """examples/03_multiobjective.py through the port on the card: NSGA-II
    pop=128 on DTLZ2(d=12, m=3) with EvalMonitor(multi_obj=True), 30
    generations; IGD must fall from generation 10 to 30 and the pooled
    front must be non-empty.  Then init_step + 1 step on the card and on
    the CPU (plain versions, the same Philox draws) must agree within rtol
    1e-4 / atol 1e-5 (sin, cos and pow round differently on the two)."""
    import torch

    counters = mo_counters()
    for c in counters.values():
        c.launches = 0
    mon, state, igds = mo_example(device, MO_EXAMPLE_GENS)
    if not igds[30] < igds[10]:
        raise AssertionError(f"example IGD did not fall: {igds}")
    front = mon.get_pf_fitness()
    if front.shape[0] == 0 or front.device.type != torch.device(device).type:
        raise AssertionError("empty pooled front")
    launches = {k: c.launches for k, c in counters.items()}
    if min(launches[k] for k in ("dominance_packed", "peel_fronts", "lex_rank", "crowding_neighbors")) < 1:
        raise AssertionError(f"a kernel of the example's path never launched: {launches}")
    wf_g = mo_workflow("NSGA2", 128, device)[0]
    wf_c = mo_workflow("NSGA2", 128, "cpu")[0]
    s_g = wf_g.step(wf_g.init_step(wf_g.init(0)))
    s_c = wf_c.step(wf_c.init_step(wf_c.init(0)))
    worst = 0.0
    for k in ("pop", "fit", "dis"):
        a, b = s_g.algorithm[k].cpu(), s_c.algorithm[k]
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        fin = torch.isfinite(b)
        worst = max(worst, float((a[fin] - b[fin]).abs().max()))
    if not torch.equal(s_g.algorithm.rank.cpu(), s_c.algorithm.rank):
        raise AssertionError("card and CPU ranks differ")
    return {"igd": igds, "pooled_front": front.shape[0], "launches": launches,
            "cpu_vs_card_max_abs_diff": worst}


def dominance_ops(f) -> float:
    """Lane operations the dominance relation of ``f`` needs on this data:
    for each ordered pair, a ``<=`` and a ``<`` per objective up to the
    first objective that fails ``<=``, and one to combine."""
    import torch

    n, m = f.shape
    total = 0
    for r0 in range(0, n, 256):
        le = f[r0 : r0 + 256, None, :] <= f[None, :, :]  # (c, n, m)
        fails = ~le
        first = torch.where(fails.any(-1), fails.to(torch.int8).argmax(-1) + 1, m)
        total += int(first.sum(dtype=torch.int64))
    return 2.0 * total + n * n


def bound(nbytes, ops) -> dict:
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_LANE_OPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def sort_ops(rows, queries=0) -> float:
    """Compares a comparison sort of ``rows`` keys needs (n·log2 n), plus a
    binary search among them for each of ``queries`` keys: the work of a
    rank or of sorted neighbours, whatever algorithm computes it."""
    import math

    return float((rows + queries) * math.log2(max(rows, 2)))


def radix_passes(values) -> list[int]:
    """Radix passes the sort kernels run on ``values`` (n,) or each column
    of (n, m): the 8-bit digits on which the keys (``order_key``, the
    kernels' own map) do not all agree; at least one."""
    from evox_tpu_torch.ops.crowding import order_key

    keys = order_key(values.reshape(values.shape[0], -1))
    out = []
    for col in keys.T:
        digits = [(col >> (8 * p)) & 0xFF for p in range(4)]
        out.append(max(1, sum(int(d.min() != d.max()) for d in digits)))
    return out


def radix_bytes(n, passes, capacity, crowding) -> int:
    """Device-memory bytes one call of a radix kernel moves, by its design
    (csrc/radix_sort.cuh), summed over the ``passes`` of each sorted
    column.  Cluster route (n <= capacity; the passes stay in shared
    memory): lex_rank reads the values, writes the order, and its second
    kernel reads the order and writes the ranks (16n); crowding reads the
    values and the mask twice, writes three lists, and its second kernel
    reads them, gathers two neighbour values and writes four outputs (54n).
    Multi-block route, per column: keys and indices written once (8n after
    reading 4n), each pass reads the keys to count (4n), reads and writes
    keys and indices (16n; the last pass writes 4n of ranks or order
    instead of 8n) and moves its (digit, tile) counts four times; crowding
    then reads the order and mask twice (10n), writes the lists (12n) and
    finishes as on the cluster route (36n)."""
    total = 0
    tiles = -(-n // 5120)
    for p in passes:
        if n <= capacity:
            total += 54 * n if crowding else 16 * n
            continue
        total += 12 * n + p * (4 * n + 16 * n + 16 * 256 * tiles) - 4 * n
        if crowding:
            total += (10 + 12 + 36) * n
    return total


# Profiler windows launches_per_call takes before it gives up on one that
# shows a device operation.
PROFILE_ATTEMPTS = 3
PROFILE_PAD_S = 0.005
PROFILE_SPARE = 32  # late in a long process a window lost its first 10 device operations


def launches_per_call(fn, calls=5, count_names=()) -> dict:
    """Device operations (kernels, memsets, copies), host syncs and device
    busy time per call of ``fn``, read from torch.profiler.  One call runs
    in the profiler's warm-up step, whose events are dropped; the recorded
    step holds ``PROFILE_SPARE`` marker kernels (``torch.cuda._sleep``),
    a ``record_function`` range with only a synchronize (its syncs are
    subtracted), then the counted calls in a range that ends with a
    synchronize.  Every device operation of the recorded step but the
    markers belongs to the counted calls.  The markers go first because
    the profiler can lose the first device operations of a recorded step;
    ``PROFILE_PAD_S`` of host time around each step boundary keeps
    operations out of the step they do not belong to, as the card's clock
    and the host's disagree by microseconds.  A window that keeps no
    marker (it may have lost a counted operation too) or shows no counted
    operation is taken again, and the phase fails if every window is:
    each ``fn`` measured here launches at least one kernel.  With
    ``count_names``, ``named`` gives the device operations a call whose
    name holds each of those substrings."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    syncs_named = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
            time.sleep(PROFILE_PAD_S)
            for _ in range(PROFILE_SPARE):
                torch.cuda._sleep(1)
            with record_function("baseline_range"):
                torch.cuda.synchronize()
            with record_function("counted_calls"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
        # The profiler's raw events (what prof.events() would wrap, less
        # its hidden ones), read without building its Python event tree,
        # which is slow for steps of thousands of device operations.
        events = [(e.name(), "CUDA" in str(e.device_type()), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if not getattr(e, "is_hidden_event", lambda: False)()]
        on_device = [e for e in events if e[1] and e[0] not in ("counted_calls", "baseline_range")
                     and not e[0].startswith("ProfilerStep")]
        marks = [e for e in on_device if "spin_kernel" in e[0]]
        device = [e for e in on_device if "spin_kernel" not in e[0]]

        def cpu_range(name):
            e = next(e for e in events if e[0] == name and not e[1])
            return e[2], e[3]

        def syncs_in(lo, hi):
            return sum(1 for e in events if e[0] in syncs_named and lo <= e[2] <= hi)

        b0, b1 = cpu_range("baseline_range")
        t0, t1 = cpu_range("counted_calls")
        if marks and device:
            break
    else:
        raise AssertionError(f"the profiler showed no device operation in {PROFILE_ATTEMPTS} windows "
                             f"(last: {len(device)} counted, {len(marks)} of {PROFILE_SPARE} markers)")
    return {"launches": len(device) / calls,
            "host_syncs": (syncs_in(t0, t1) - syncs_in(b0, b1)) / calls,
            "device_ms": sum(e[3] - e[2] for e in device) / calls / 1e6,
            "kernels": [n[:60] for n in sorted({e[0] for e in device})],
            **({"named": {k: sum(1 for e in device if k in e[0]) / calls for k in count_names}}
               if count_names else {})}


def fronts_of(rank) -> int:
    """Fronts ranked: the largest rank below the sentinel n, plus one."""
    n = rank.shape[0]
    ranked = rank[rank < n]
    return int(ranked.max()) + 1 if ranked.numel() else 0


def peel_bound(words, rank, until_count) -> dict:
    """Bytes and operations of the front peel on this data: the words once
    for the dominate count, then for each front whose successor is built
    (every ranked front but the last when ``until_count`` stops the peel;
    all of them, the last finding an empty front, when it does not) the
    word rows holding that front's rows; the ranks written (4n) and the
    counts (4n).  Operations: an AND, a popcount and an add per word read.
    ``all_words_bytes`` is the cruder count that reads every word for each
    ranked front and the dominate count ((fronts + 1) x 4·⌈n/32⌉·n + 8n)."""
    import torch

    nw, n = words.shape
    fronts = fronts_of(rank)
    built = fronts if until_count is None else fronts - 1
    front_words = sum(int(torch.unique(torch.nonzero(rank == r)[:, 0] // 32).numel()) for r in range(built))
    read = (nw + front_words) * n
    b = bound(4 * read + 8 * n, 3.0 * read)
    b["all_words_bytes"] = (fronts + 1) * 4 * nw * n + 8 * n
    b["all_words_bound_ms"] = b["all_words_bytes"] / PEAK_BYTES_PER_S * 1e3
    return b


def path_inputs():
    """The main path's inputs at its last timed step: the merged 2N
    objectives and boundary-front mask that the crowding kernel was given,
    with the rank survivor selection computed from the same objectives
    (checked against that mask); and the N objectives of init_step."""
    import torch
    from evox_tpu_torch.operators.selection import non_dominate_rank
    from evox_tpu_torch.ops import topk

    merged, mask = PATH_INPUTS["last_timed_step"]
    rank = non_dominate_rank(merged, until_count=NSGA2_POP)
    worst = topk.masked_top_k(rank, NSGA2_POP)[0][-1]
    if not torch.equal(rank == worst, mask):
        raise AssertionError("the path's boundary-front mask differs from the one its objectives give")
    return PATH_INPUTS["init"][0], merged, rank, mask


def phase_timing_mo(device) -> dict:
    """Each multi-objective kernel beside its plain version and, where one
    exists, a library call, timed with CUDA events, at the main path's
    inputs (its last timed step, and init_step) and at bench.py's 50k
    shapes (100k for the packed words).  Bounds: bytes (each input read
    once, each output written once) over 3.35 TB/s, and lane operations
    (each compare, select or logic operation one) over 132 x 128 x 1.98e9
    a second, counting the work the function needs (a rank or sorted
    neighbours: n·log2 n compares); the larger is the bound.  Each kernel
    on the path's own inputs (every row but the 50k and 100k ones) is
    first held exactly against its plain version.  Beside the radix
    kernels stand their design's own figures: radix passes run (per
    column), bytes moved per call, and, at the path's sizes, the device
    operations and host syncs per call read from the profiler (at most two
    and none, or the phase fails), as for the front peel; the packed words
    and the whole ranking report theirs."""
    import torch
    from evox_tpu_torch.operators.selection import non_dominate_rank
    from evox_tpu_torch.ops import crowding, dominance, probe, topk

    out = {}
    fit10k, merged, rank, mask = path_inputs()
    n2 = merged.shape[0]

    cap = topk.radix_capacity()

    def radix(values, crowding_kernel, fn=None):
        passes = radix_passes(values)
        row = {"route": "cluster" if values.shape[0] <= cap else "multi-block", "passes": passes,
               "bytes_moved": radix_bytes(values.shape[0], passes, cap, crowding_kernel)}
        if fn is not None:
            row["profile"] = launches_per_call(fn)
            if row["profile"]["launches"] > 2 or row["profile"]["host_syncs"] != 0:
                raise AssertionError(f"radix kernel at the path's size: {row['profile']}")
        return row

    def entry(name, fn, plain, b, iters=20, plain_iters=3, library=None, held=False, **extra):
        row = {}
        if held:
            # The main path's own inputs: the kernel against its plain
            # version, exactly, before either is timed.
            got, want = fn(), plain()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            row["max_abs_err"] = max(exact(g, w, f"{name} against its plain version") for g, w in pairs)
            del got, want, pairs
        row.update({"ms": time_ms(fn, iters), "plain_ms": time_ms(plain, plain_iters, warmup=1), **b, **extra})
        row["library_ms"] = time_ms(library, iters) if library is not None else None
        out[name] = row
        torch.cuda.empty_cache()

    # dominance: packed words at the path's 20000 and 10000 rows, and at
    # 100000 rows (1.25 GB of words).
    for tag, f in (("20k", merged), ("10k", fit10k)):
        n = f.shape[0]
        entry(f"dominance_packed_{tag}", lambda: dominance.dominance_packed(f),
              lambda: dominance.dominance_packed_plain(f),
              bound(f.numel() * 4 + 4 * (-(-n // 32)) * n, dominance_ops(f)), held=True,
              launches_per_call=launches_per_call(lambda: dominance.dominance_packed(f)))
    big = drift_inputs(BIG_DOMINANCE, 3, device)
    entry("dominance_packed_100k", lambda: dominance.dominance_packed(big),
          lambda: dominance.dominance_packed_plain(big),
          bound(big.numel() * 4 + 4 * (-(-BIG_DOMINANCE // 32)) * BIG_DOMINANCE, dominance_ops(big)),
          iters=3, plain_iters=1)
    del big
    words = dominance.dominance_packed(merged)
    # The whole front peel of survivor selection at the path's shape (its
    # until_count N), one cooperative kernel: at most two device operations
    # and no host sync per call, or the phase fails.
    peel = lambda: dominance.peel_fronts(words, NSGA2_POP)  # noqa: E731
    entry("peel_fronts_20k", peel, lambda: dominance.peel_fronts_plain(words, NSGA2_POP),
          peel_bound(words, rank, NSGA2_POP), held=True, fronts=fronts_of(rank),
          launches_per_call=launches_per_call(peel, calls=20))
    row = out["peel_fronts_20k"]
    if row["launches_per_call"]["launches"] > 2 or row["launches_per_call"]["host_syncs"] != 0:
        raise AssertionError(f"peel_fronts at the path's size: {row['launches_per_call']}")
    del words
    # init_step's ranking: every front of the first population (no
    # until_count), the most fronts the path peels in one call.
    words = dominance.dominance_packed(fit10k)
    rank10k = dominance.peel_fronts(words)
    entry("peel_fronts_10k_init", lambda: dominance.peel_fronts(words), lambda: dominance.peel_fronts_plain(words),
          peel_bound(words, rank10k, None), held=True, fronts=fronts_of(rank10k),
          launches_per_call=launches_per_call(lambda: dominance.peel_fronts(words), calls=20))
    del words
    # The whole ranking of survivor selection (words, then the peel) at the
    # path's shape: host clock against its kernels' time.
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        non_dominate_rank(merged, until_count=NSGA2_POP)
    torch.cuda.synchronize()
    out["non_dominate_rank_20k"] = {
        "host_ms": (time.perf_counter() - t0) * 1e3 / reps, "fronts": fronts_of(rank),
        "kernel_ms": out["dominance_packed_20k"]["ms"] + row["ms"],
        "launches_per_call": launches_per_call(lambda: non_dominate_rank(merged, until_count=NSGA2_POP)),
    }
    # lex_rank / masked_top_k on the path's int32 ranks (k = N), and the
    # 50k float32 top-k of bench.py (k = 25000).
    def argsort_inverse(v):
        order = torch.argsort(v, stable=True)
        r = torch.empty_like(order)
        r.scatter_(0, order, torch.arange(v.shape[0], device=v.device))
        return r

    entry("lex_rank_20k", lambda: topk.lex_rank(rank), lambda: topk.lex_rank_plain(rank),
          bound(8 * n2, sort_ops(n2)), library=lambda: argsort_inverse(rank), held=True,
          masked_top_k_ms=time_ms(lambda: topk.masked_top_k(rank, NSGA2_POP), 20),
          **radix(rank, False, lambda: topk.lex_rank(rank)))
    nb = BIG_CROWDING
    v50 = drift_inputs(nb, 1, device)[:, 0].contiguous()
    entry("lex_rank_50k_f32", lambda: topk.lex_rank(v50), lambda: topk.lex_rank_plain(v50),
          bound(8 * nb, sort_ops(nb)), library=lambda: argsort_inverse(v50),
          masked_top_k_ms=time_ms(lambda: topk.masked_top_k(v50, nb // 2), 10),
          masked_top_k_plain_ms=time_ms(lambda: topk.masked_top_k_plain(v50, nb // 2), 10),
          **radix(v50, False))
    # crowding: the path's merged objectives and boundary-front mask at its
    # last timed step, all rows at init_step, and bench.py's crowding_50k
    # (all valid).  The function sorts each column's valid rows and finds
    # every row's place among them; the kernel sorts all rows of each
    # column and scans for the valid ones beside each.
    ones10k = torch.ones(fit10k.shape[0], dtype=torch.bool, device=device)
    c50 = drift_inputs(nb, 3, device)
    ones50k = torch.ones(nb, dtype=torch.bool, device=device)
    for tag, f, mk in (("20k_path", merged, mask), ("10k_init", fit10k, ones10k), ("50k", c50, ones50k)):
        n, m = f.shape
        valid = int(mk.sum())
        entry(f"crowding_neighbors_{tag}", lambda: crowding.crowding_neighbors(f, mk),
              lambda: crowding.crowding_neighbors_plain(f, mk),
              bound(4 * n * m + n + 16 * n * m, m * sort_ops(valid, n)),
              library=lambda: crowding.crowding_distance_plain(f, mk), valid_rows=valid, held=tag != "50k",
              distance_kernel_route_ms=time_ms(lambda: crowding.crowding_distance_kernel(f, mk), 20),
              **radix(f, True, None if tag == "50k" else lambda: crowding.crowding_neighbors(f, mk)))
    del c50
    x = torch.randn(8, 128, device=device)
    # Beside the event times, the profiler's device time a call of the
    # kernel and of ``x * 2``: whether a gap between the two is the
    # kernel's or the wrapper's.
    entry("scale_by_two_probe", lambda: probe.scale_by_two(x), lambda: probe.scale_by_two_plain(x),
          bound(8 * x.numel(), float(x.numel())), iters=100, plain_iters=100, library=lambda: x * 2,
          device_profile=launches_per_call(lambda: probe.scale_by_two(x), calls=20),
          library_device_profile=launches_per_call(lambda: x * 2, calls=20))
    return out


# ---------------------------------------------------------------------------
# Slice 5: the Philox draw kernel, and fused runs as replayed CUDA graphs.
# ---------------------------------------------------------------------------

PHILOX_SIZES = [1, 3, 4, 5, 1000, 1001, 65_537, 1_000_003]
PHILOX_BIG = 100_000_000  # the PSO headline's setup draws: 1e5 x 1e3
# Lane operations of one Philox4x32-10 evaluation: ten rounds of two 32-bit
# multiplies, their high halves and four XORs (the key schedule is per
# thread); then three a word put in its final form (shift, convert, scale;
# or multiply, shift, add).
PHILOX_OPS, PHILOX_OPS_PER_OUT = 80, 3
SEGMENT_GENS = 20


def philox_bound(numel, kinds) -> dict:
    import torch

    size = sum(8 if isinstance(k, tuple) else torch.tensor([], dtype=k).element_size() for k in kinds)
    return bound(numel * size + 16, float(numel) * (PHILOX_OPS + PHILOX_OPS_PER_OUT * len(kinds)))


def de_philox_layouts():
    """(numel, kinds) of the draws de_cec makes at its width: the first
    population, the index table of DE/rand/1 (3 x pop), the binary
    crossover's uniforms and forced dimensions, the exponential
    crossover's start dimensions and uniforms, the p-best pick (top 5 %)."""
    import torch

    return [
        (DE_POP * DE_DIM, [torch.float32]),
        (3 * DE_POP, [(0, DE_POP)]),
        (DE_POP * DE_DIM, [torch.float32, (0, DE_DIM)]),
        (DE_POP, [(0, DE_DIM), torch.float32]),
        (DE_POP, [(0, DE_POP // 20)]),
    ]


def phase_philox(device) -> dict:
    """The draw kernel against its plain version, bit for bit: child seeds
    of keys whose seed words span 0 to 2^64 - 1 and whose counters are 0, 5
    and 2^40, and integer seeds (used as they are); sizes 1 to 10^6 + 3
    that are and are not multiples of 4, and 10^8; every output kind
    (float32, bfloat16, float64, float16, int64 ranges) in one to four
    outputs a call; the DE family's layouts at de_cec's width
    (``de_philox_layouts``).  Then timing at the main paths' shapes: the
    PSO headline's setup draw (10^8 float32), the three draws of an NSGA-II
    generation, and de_cec's binary crossover and index table."""
    import torch
    from evox_tpu_torch.ops import philox
    from evox_tpu_torch.utils import rng

    kinds_list = [
        [torch.float32], [torch.bfloat16], [torch.float64], [torch.float16], [(0, 2)],
        [torch.float32, (0, 2), torch.float32, torch.float32],
        [torch.float32, torch.float32], [(0, 2 * NSGA2_POP)], [(-7, 2**31 - 7), torch.bfloat16],
    ]
    seeds, keys = [12345, 2**63 + 3], []
    for s_ in (0, 7, 2**63, 2**64 - 1):
        k = rng.key(s_, device)
        for advance in (0, 5, 2**40):
            k_adv = k.clone()
            k_adv[1] += advance
            keys.append(k_adv)
            seeds += [rng.child(k_adv, 0), rng.child(k_adv, 3)]
    checks, worst = 0, 0.0
    # The plain version is elementwise in the element's counter, so its draw
    # of n elements is the first n of a longer one: one plain draw of the
    # largest size serves every size, and each output's draws at every size
    # are held against it in one comparison.
    top = max(PHILOX_SIZES)
    for seed in seeds:
        for kinds in kinds_list:
            want = philox.philox_draws_plain(seed, top, kinds, device)
            got = [philox.philox_draws(seed, numel, kinds, device) for numel in PHILOX_SIZES]
            for k, w in enumerate(want):
                worst = max(worst, exact(torch.cat([g[k] for g in got]),
                                         torch.cat([w[:numel] for numel in PHILOX_SIZES]),
                                         f"philox_draws {kinds} output {k}, numel {PHILOX_SIZES}"))
                checks += len(PHILOX_SIZES)
    for kinds in ([torch.float32], [torch.float32, (0, 2), torch.bfloat16, torch.float16]):
        got = philox.philox_draws(seeds[-1], PHILOX_BIG, kinds, device)
        want = philox.philox_draws_plain(seeds[-1], PHILOX_BIG, kinds, device)
        for g, w in zip(got, want):
            worst = max(worst, exact(g, w, f"philox_draws {kinds} numel={PHILOX_BIG}"))
            checks += 1
        del got, want
        torch.cuda.empty_cache()
    # The DE family's layouts at de_cec's width (the population, the index
    # table, both crossovers, the p-best pick), from the seeds its
    # operators use: rng.as_seed(child, 0..3) of each key above.
    for k_adv in keys:
        for offset in range(4):
            seed = rng.as_seed(rng.child(k_adv, 1), offset)
            for numel, kinds in de_philox_layouts():
                got = philox.philox_draws(seed, numel, kinds, device)
                want = philox.philox_draws_plain(seed, numel, kinds, device)
                for g, w in zip(got, want):
                    worst = max(worst, exact(g, w, f"philox_draws {kinds} numel={numel} (DE)"))
                    checks += 1

    c, w = philox_design_checks(device)
    checks += c
    worst = max(worst, w)

    timing = {}
    k = rng.key(2**63 + 1, device)
    for tag, numel, kinds, iters in (
        ("pso_setup_1e8_f32", PHILOX_BIG, [torch.float32], 10),
        ("nsga2_sbx_60k", NSGA2_POP // 2 * NSGA2_DIM, [torch.float32, (0, 2), torch.float32, torch.float32], 50),
        ("nsga2_pm_120k", NSGA2_POP * NSGA2_DIM, [torch.float32, torch.float32], 50),
        ("nsga2_tournament_20k", NSGA2_POP * 2, [(0, NSGA2_POP)], 50),
        ("de_cec_bin_cx_200k", DE_POP * DE_DIM, [torch.float32, (0, DE_DIM)], 50),
        ("de_cec_table_30k", 3 * DE_POP, [(0, DE_POP)], 50),
    ):
        seed = rng.child(k, 1)
        row = {"numel": numel, "outputs": len(kinds),
               "ms": time_ms(lambda: philox.philox_draws(seed, numel, kinds, device), iters),
               "plain_ms": time_ms(lambda: philox.philox_draws_plain(seed, numel, kinds, device), 3, warmup=1),
               **philox_bound(numel, kinds), "library_ms": None}
        if tag.startswith("pso"):
            # torch.rand draws other bits (its own Philox stream), so it is no
            # library call for this function; its time is kept beside it.
            row["torch_rand_ms"] = time_ms(lambda: torch.rand(numel, device=device), iters)
            row["launches_per_call"] = launches_per_call(lambda: philox.philox_draws(seed, numel, kinds, device))
        else:
            row["launches_per_call"] = launches_per_call(lambda: philox.philox_draws(seed, numel, kinds, device))
        if row["launches_per_call"]["launches"] > 1 or row["launches_per_call"]["host_syncs"] != 0:
            raise AssertionError(f"philox_draws {tag}: {row['launches_per_call']}")
        timing[tag] = row
        torch.cuda.empty_cache()
    # hpo_ladder's batched draw: OpenES's normals of 64 candidates, 16,384
    # a candidate, one launch an inner generation.
    b, numel = HPO_LADDER["candidates"], HPO_LADDER["inner_pop"] // 2 * HPO_LADDER["dim"]
    keys = torch.stack([rng.key(s_, device) for s_ in range(b)])
    kinds = [torch.float32]
    draw = lambda: philox.philox_draws_batched(keys, 0, numel, kinds)  # noqa: E731
    worst = max(worst, max(exact(g, w, f"philox_draws_batched {b} x {numel}")
                           for g, w in zip(draw(), philox.philox_draws_batched_plain(keys, 0, numel, kinds))))
    timing["hpo_ladder_batched_64x16384_f32"] = {
        "streams": b, "numel": numel, "ms": time_ms(draw, 50),
        "plain_ms": time_ms(lambda: philox.philox_draws_batched_plain(keys, 0, numel, kinds), 3, warmup=1),
        "launches_per_call": launches_per_call(draw, calls=20), **philox_bound(b * numel, kinds), "library_ms": None,
    }
    return {"checks": checks, "max_abs_err": worst, "timing": timing}


# The draw kernel's design cases (csrc/philox.cu), held
# against the plain version: every size to two vectors and one, sizes
# around each boundary of the host's launch plan, no element, 1 and 4,096
# streams, and 2^19 + 1 bfloat16 draws for 4,095 and 4,097 streams (each
# side of 2^31 elements in all: the 32- and 64-bit index routes; ~4.3 GB).
PHILOX_DESIGN_KINDS = [["float32"], ["float32", (0, 2), "bfloat16", "float64"]]
PHILOX_WIDE = (2**19 + 1, (4095, 4097))


def philox_plan_sizes(batch, count):
    """numel values around each boundary of the draw kernel's launch plan
    for ``batch`` streams of ``count`` outputs on this card: where the
    scalar route ends, where the one-pass grid ends, and the third and
    fourth passes of the resident grid."""
    import torch
    from evox_tpu_torch.ops import _build, philox

    index = torch.cuda.current_device()
    sms = _build.sm_count(index)
    resident = sms * philox._blocks_per_sm(index, count, False, philox._VEC)
    per_pass = max(1, resident // batch) * philox._THREADS * philox._VEC
    centers = [philox._SCALAR_BLOCKS * sms * philox._THREADS // batch,
               philox._ONE_PASS_WAVES * resident * philox._THREADS * philox._VEC // batch,
               3 * per_pass, 4 * per_pass]
    return sorted({c + d for c in centers for d in (-1, 0, 1) if c + d > 0})


def philox_design_checks(device) -> tuple[int, float]:
    """The draw kernel's design cases (above), each output of each call
    against the plain version bit for bit: (checks, largest difference)."""
    import torch
    from evox_tpu_torch.ops import philox
    from evox_tpu_torch.utils import rng

    checks, worst = 0, 0.0

    def keys_of(b, seed):
        g = torch.Generator().manual_seed(seed + b)
        return torch.randint(-(2**63), 2**63 - 1, (b, 2), generator=g, dtype=torch.int64).to(device)

    def held(keys, numel, kinds, what, rows=None):
        nonlocal checks, worst
        got = philox.philox_draws_batched(keys, 1, numel, kinds)
        sel = keys if rows is None else keys[rows]
        for g, w in zip(got, philox.philox_draws_batched_plain(sel, 1, numel, kinds)):
            worst = max(worst, exact(g if rows is None else g[rows], w, what))
            checks += 1

    kinds_list = [[getattr(torch, k) if isinstance(k, str) else k for k in kinds] for kinds in PHILOX_DESIGN_KINDS]
    for kinds in kinds_list:
        for b in (1, 3):
            for numel in range(0, 2 * philox._VEC + 2):
                held(keys_of(b, 1), numel, kinds, f"philox_draws {b} x {numel} {kinds}")
            for numel in philox_plan_sizes(b, len(kinds)):
                held(keys_of(b, 2), numel, kinds, f"philox_draws {b} x {numel} {kinds} (plan boundary)")
        for b in (8, 64):
            for numel in philox_plan_sizes(b, len(kinds)):
                held(keys_of(b, 3), numel, kinds, f"philox_draws {b} x {numel} {kinds} (plan boundary)")
        # 4,096 streams: the rows at both ends and every 97th against the
        # plain version (each stream is the same code on its own key).
        rows = sorted({0, 1, 2, 3, 4093, 4094, 4095, *range(0, 4096, 97)})
        for numel in (1, 7, 1000):
            held(keys_of(4096, 4), numel, kinds, f"philox_draws 4096 x {numel} {kinds}", rows)
        torch.cuda.empty_cache()
    # A solo draw of no element launches nothing.
    before = philox.philox_draws.launches
    if any(g.numel() for g in philox.philox_draws(rng.child(rng.key(1, device)), 0, kinds_list[-1], device)) \
            or philox.philox_draws.launches != before:
        raise AssertionError("philox_draws of no element: elements drawn or a kernel launched")
    numel, batches = PHILOX_WIDE
    for b in batches:
        # The rows at both ends, the middle one and those around flat
        # element 2^31 (rows 4095 and 4096 of 2^19 + 1).
        rows = sorted({0, 1, b // 2, b - 2, b - 1} | ({4094, 4095, 4096} & set(range(b))))
        held(keys_of(b, 5), numel, [torch.bfloat16], f"philox_draws {b} x {numel} bfloat16 (index route)", rows)
        torch.cuda.empty_cache()
    return checks, worst


def same_state(got, want, what) -> int:
    """Raise unless two nests of tensors are equal leaf for leaf, bit for
    bit (``exact``); return the number of leaves."""
    from evox_tpu_torch.utils import graph

    lg, sg = graph.flatten(got)
    lw, sw = graph.flatten(want)
    if sg != sw:
        raise AssertionError(f"{what}: the state's structure differs")
    for i, (g, w) in enumerate(zip(lg, lw)):
        if g.device != w.device:
            raise AssertionError(f"{what}: leaf {i} on {g.device}, expected {w.device}")
        exact(g, w, f"{what}, leaf {i}")
    return len(lg)


def segment_workflow(path, device, monitor, problem=None, **kw):
    """One of the fused paths (bench.py's pso_northstar_fused,
    pso_small_fused, nsga2_dtlz2), with an EvalMonitor when asked."""
    import torch
    from evox_tpu_torch.algorithms import NSGA2, PSO
    from evox_tpu_torch.problems.numerical import DTLZ2, Ackley, Sphere
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    if path == "nsga2_headline":
        mon = EvalMonitor(multi_obj=True) if monitor else None
        algo = NSGA2(NSGA2_POP, NSGA2_OBJ, torch.zeros(NSGA2_DIM), torch.ones(NSGA2_DIM), device=device)
        return StdWorkflow(algo, problem or DTLZ2(d=NSGA2_DIM, m=NSGA2_OBJ, device=device), monitor=mon, **kw)
    mon = EvalMonitor(full_fit_history=True) if monitor else None
    if path == "pso_headline":
        n, d = HEADLINE
        algo = PSO(n, torch.full((d,), -10.0), torch.full((d,), 10.0), device=device)
        return StdWorkflow(algo, problem or Sphere(), monitor=mon, **kw)
    algo = PSO(1024, torch.full((100,), -32.0), torch.full((100,), 32.0), device=device)
    return StdWorkflow(algo, problem or Ackley(), monitor=mon, **kw)


def path_counters(path):
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    if path.startswith("pso"):
        return {"fused_pso_move": fused_pso_move}
    return {k: v for k, v in mo_counters().items() if k != "dominance_matrix"}


def timed(fn, gens):
    """(event ms, host ms) per generation of one call of ``fn`` covering
    ``gens`` generations, and its result."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / gens, (time.perf_counter() - t0) * 1e3 / gens, out


def segment_history_check(path, device) -> dict:
    """With an EvalMonitor: run_segment(20) + flush_telemetry and run(20)
    from the same state as 20 eager steps: every state leaf bit for bit,
    and the history entries flushed equal to the stepped ones (same
    values, same device, same count)."""
    wf = segment_workflow(path, device, monitor=True)
    s0 = wf.step(wf.init_step(wf.init(0)))
    hist = wf.monitor._history
    h0 = {t: len(v) for t, v in hist.items()}
    ref = s0
    for _ in range(SEGMENT_GENS):
        ref = wf.step(ref)
    seg, tel = wf.run_segment(s0, SEGMENT_GENS)
    leaves = same_state(seg, ref, f"{path}: run_segment vs eager steps")
    if bool(tel.stopped) or int(tel.executed) != SEGMENT_GENS:
        raise AssertionError(f"{path}: telemetry {tel.stopped} {tel.executed}")
    wf.flush_telemetry(tel)
    run = wf.run(s0, SEGMENT_GENS, init=False)
    same_state(run, ref, f"{path}: run vs eager steps")
    entries = 0
    for t, v in hist.items():
        stepped = v[h0[t]: h0[t] + SEGMENT_GENS]
        for k, block in (("run_segment", 1), ("run", 2)):
            flushed = v[h0[t] + block * SEGMENT_GENS: h0[t] + (block + 1) * SEGMENT_GENS]
            if len(flushed) != len(stepped):
                raise AssertionError(f"{path}: {k} history has {len(flushed)} entries, stepping {len(stepped)}")
            for (ga, ia, sa, a), (gb, ib, sb, b) in zip(flushed, stepped):
                if a.device != b.device:
                    raise AssertionError(f"{path}: {k} history on {a.device}, stepping on {b.device}")
                if (int(ga), int(ia), sa) != (int(gb), int(ib), sb):
                    raise AssertionError(f"{path}: {k} history tags {(int(ga), int(ia), sa)}, "
                                         f"stepping {(int(gb), int(ib), sb)}")
                exact(a, b, f"{path}: {k} history entry")
                entries += 1
    return {"leaves": leaves, "history_entries_checked": entries}


def phase_segment(device) -> dict:
    """run_segment and run on the card: replays of captured CUDA graphs,
    held bit for bit against eager steps on the three target paths (with a
    monitor: the history flushed too), then timed against eager steps on
    the bench configurations (no monitor): CUDA events and host clock per
    generation, device busy time from the profiler (idle share), capture
    time, device operations and host syncs per generation, the state's
    size and the memory a capture adds, and what copying the state once
    costs (the copy-back a graph replayed every generation would pay).
    ``run`` must not be slower than eager steps (by more than 10 %).  The
    launch counters count wrapper calls: a first run_segment runs one
    generation (warm-up on a clone) and then the captured ones through the
    wrappers, so it must count exactly (n + 1) / n of the launches of n
    eager steps; a replayed one counts none.  Then the early stop on PSO
    pop=1024: a problem that turns NaN at a chosen evaluation (quarantine
    off) stops the segment there, with the state of the eager steps up to
    it; with no NaN the stop-guarded segment equals 20 eager steps."""
    import torch

    from evox_tpu_torch.utils import graph

    out = {}
    for path in ("pso_headline", "pso_small", "nsga2_headline"):
        torch.cuda.reset_peak_memory_stats()
        row = {"history": segment_history_check(path, device)}
        history_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        wf = segment_workflow(path, device, monitor=False)
        s0 = wf.step(wf.init_step(wf.init(0)))
        for _ in range(MAIN_WARMUP):
            ref = wf.step(s0)
        del ref

        def eager():
            s = s0
            for _ in range(SEGMENT_GENS):
                s = wf.step(s)
            return s

        counters = path_counters(path)
        for c in counters.values():
            c.launches = 0
        eager_ms, eager_host_ms, ref = timed(eager, SEGMENT_GENS)
        stepped = {k: c.launches for k, c in counters.items()}
        want_first = {k: v // SEGMENT_GENS * (SEGMENT_GENS + 1) for k, v in stepped.items()}
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        state_bytes = sum(t.numel() * t.element_size() for t in graph.flatten(s0)[0])
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        seg, _ = wf.run_segment(s0, SEGMENT_GENS)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        capture_peak_gb = (torch.cuda.max_memory_allocated() - allocated) / 1e9
        first = {k: c.launches for k, c in counters.items()}
        same_state(seg, ref, f"{path}: run_segment vs eager steps (no monitor)")
        for c in counters.values():
            c.launches = 0
        seg_ms, seg_host_ms, (seg, _) = timed(lambda: wf.run_segment(s0, SEGMENT_GENS), SEGMENT_GENS)
        replayed = {k: c.launches for k, c in counters.items()}
        same_state(seg, ref, f"{path}: replayed run_segment vs eager steps")
        if (min(stepped.values()) < 1 or any(v % SEGMENT_GENS for v in stepped.values())
                or first != want_first or max(replayed.values()) != 0):
            raise AssertionError(f"{path}: launches in {SEGMENT_GENS} eager steps {stepped}, at capture "
                                 f"{first} (want {want_first}), at replay {replayed}")
        # Without the end-of-segment health scan, and run(): one replay of
        # the same captured graph.
        nometrics_ms, _, (seg, _) = timed(lambda: wf.run_segment(s0, SEGMENT_GENS, metrics=False), SEGMENT_GENS)
        same_state(seg, ref, f"{path}: run_segment(metrics=False) vs eager steps")
        graphs = len(wf._graphs)
        run_ms, run_host_ms, run_state = timed(lambda: wf.run(s0, SEGMENT_GENS, init=False), SEGMENT_GENS)
        same_state(run_state, ref, f"{path}: run vs eager steps")
        if len(wf._graphs) != graphs or run_ms > 1.10 * eager_ms:
            raise AssertionError(f"{path}: run {run_ms} ms/gen against {eager_ms} eager, "
                                 f"{len(wf._graphs) - graphs} new captures")
        # One copy of the state into buffers of its own.
        buffers = [t.clone() for t in graph.flatten(run_state)[0]]
        copy_ms, _, _ = timed(lambda: [b.copy_(t) for b, t in zip(buffers, graph.flatten(s0)[0])], 1)
        del run_state, buffers
        _, seg_prof = profile_steps(lambda s: wf.run_segment(s, SEGMENT_GENS)[0], s0, 1)
        per_gen = launches_per_call(lambda: wf.step(s0), calls=3)
        per_seg = launches_per_call(lambda: wf.run_segment(s0, SEGMENT_GENS), calls=1)
        if per_seg["host_syncs"] != 0:
            raise AssertionError(f"{path}: a segment made host syncs: {per_seg}")
        row.update({
            "eager_ms_per_gen": eager_ms, "eager_host_ms_per_gen": eager_host_ms,
            "segment_ms_per_gen": seg_ms, "segment_host_ms_per_gen": seg_host_ms,
            "segment_no_metrics_ms_per_gen": nometrics_ms,
            "run_ms_per_gen": run_ms, "run_host_ms_per_gen": run_host_ms,
            "capture_s": capture_s, "capture_peak_gb": capture_peak_gb, "state_gb": state_bytes / 1e9,
            "state_copy_ms": copy_ms,
            "segment_kernels_ms_per_segment": seg_prof["kernels_ms_per_gen"],
            "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
            "eager_device_ms_per_gen": per_gen["device_ms"],
            "eager_idle_share": 1 - per_gen["device_ms"] / eager_ms,
            "segment_device_ops_per_gen": per_seg["launches"] / SEGMENT_GENS,
            "segment_host_syncs_per_gen": per_seg["host_syncs"] / SEGMENT_GENS,
            "segment_device_ms_per_gen": per_seg["device_ms"] / SEGMENT_GENS,
            "segment_idle_share": 1 - per_seg["device_ms"] / SEGMENT_GENS / seg_ms,
            "launches_first_call": first, "launches_replayed_call": replayed,
            "history_check_peak_mem_gb": history_peak_gb,
        })
        out[path] = row
        del wf, s0, seg, ref
        torch.cuda.empty_cache()
    out["early_stop"] = segment_early_stop(device)
    return out


def segment_early_stop(device) -> dict:
    import torch
    from evox_tpu_torch.core import Problem, State

    class Poisoned(Problem):
        """Ackley whose ``at``-th evaluation (from 0) is NaN."""

        def __init__(self, at):
            from evox_tpu_torch.problems.numerical import Ackley

            self.at, self.inner = at, Ackley()

        def setup(self, key):
            return State(evals=torch.zeros((), dtype=torch.int32, device=device))

        def evaluate(self, state, pop):
            fit, _ = self.inner.evaluate(State(), pop)
            fit = torch.where(state.evals == self.at, torch.full_like(fit, float("nan")), fit)
            return fit, state.replace(evals=state.evals + 1)

    out = {}
    # init_step and one step are evaluations 0 and 1; the segment's k-th
    # generation (from 1) is evaluation k + 1.
    for at, want_executed in ((7, 6), (10**6, SEGMENT_GENS)):
        wf = segment_workflow("pso_small", device, monitor=True, problem=Poisoned(at), quarantine_nonfinite=False)
        s0 = wf.step(wf.init_step(wf.init(0)))
        final, tel = wf.run_segment(s0, SEGMENT_GENS, stop_on_unhealthy=True)
        executed, stopped = int(tel.executed), bool(tel.stopped)
        if executed != want_executed or stopped != (want_executed < SEGMENT_GENS):
            raise AssertionError(f"early stop at evaluation {at}: executed {executed}, stopped {stopped}")
        ref = s0
        for _ in range(executed):
            ref = wf.step(ref)
        same_state(final, ref, f"early stop at evaluation {at}")
        out[f"nan_at_{at}"] = {"executed": executed, "stopped": stopped}
    return out


# ---------------------------------------------------------------------------
# Slice 6: RVEA on DTLZ2 at the bench width, and the rest of the
# multi-objective family (RVEAa, NSGA-III, MOEA/D, HypE, DTLZ1-7).
# ---------------------------------------------------------------------------

RVEA_POP = 10_000  # bench.py's rvea_dtlz2: Das-Dennis keeps 9870 vectors
# The family's widths: NSGA-III at its full width (9870 reference points),
# the others at pop 1000 (990 Das-Dennis vectors for RVEAa and MOEA/D).
MO_FAMILY = [("NSGA3", 10_000), ("RVEAa", 1000), ("MOEAD", 1000), ("HypE", 1000)]
DTLZ_SUITE = ["DTLZ1", "DTLZ3", "DTLZ4", "DTLZ5", "DTLZ6", "DTLZ7"]
DTLZ_ROWS = 10_000
# Philox launches a generation: one a random operator (mating, SBX,
# mutation; NSGA-III's two shuffles, RVEAa's regeneration, HypE's two
# hypervolume estimates); the ranking kernels once a generation where the
# step ranks the merged population.
PATH_LAUNCHES = {
    "RVEA": {"philox_draws": 3, "dominance_packed": 0, "peel_fronts": 0},
    "NSGA3": {"philox_draws": 5, "dominance_packed": 1, "peel_fronts": 1},
    "RVEAa": {"philox_draws": 4, "dominance_packed": 1, "peel_fronts": 1},
    "MOEAD": {"philox_draws": 3, "dominance_packed": 0, "peel_fronts": 0},
    "HypE": {"philox_draws": 5, "dominance_packed": 1, "peel_fronts": 1},
}
# The card's selection against the CPU's, by limits stated here and not
# taken from what the card computes.  Each device's cosine of a (row,
# vector) pair lies within about 8 units of 2^-24 of the exact value (the
# three-entry norm 2, the division 1, the three-term product 3, rounding 2),
# so the two devices' within twice that.
COS_ABS_LIMIT = 16 * 2.0**-24
# The APD (1 + m·theta·angle)·||obj|| of a row: the card's cosine moves the
# angle anywhere over arccos of [c - COS_ABS_LIMIT, c + COS_ABS_LIMIT]; each
# device's arccos errs by up to 2 units of the angle (8·2^-24 relative for
# both), and the norm, the add and the product by 16·2^-24 of the APD for
# both (``apd_allowance``).
ACOS_REL, APD_REL = 8 * 2.0**-24, 16 * 2.0**-24
# A flip between two near-equal values is accepted within this many float32
# units in the last place beyond those limits.
FLIP_ULP = 4


def path_launch_counters():
    return {k: v for k, v in mo_counters().items() if k in ("philox_draws", "dominance_packed", "peel_fronts")}


def mo_workflow(name, pop, device, monitor=None):
    """``StdWorkflow(name(pop, 3, zeros(12), ones(12)), DTLZ2(d=12,
    m=3))`` on ``device``: the workflow, the problem and the algorithm."""
    import torch
    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems.numerical import DTLZ2
    from evox_tpu_torch.workflows import StdWorkflow

    problem = DTLZ2(d=NSGA2_DIM, m=NSGA2_OBJ, device=device)
    algo = getattr(algorithms, name)(pop, NSGA2_OBJ, torch.zeros(NSGA2_DIM), torch.ones(NSGA2_DIM), device=device)
    return StdWorkflow(algo, problem, monitor=monitor), problem, algo


def igd_valid(fit, pf) -> float:
    """IGD of the rows that are not empty (NaN) slots."""
    import torch
    from evox_tpu_torch.metrics import igd

    return float(igd(fit[~torch.isnan(fit).any(dim=1)], pf))


def fused_vs_eager(wf, s0, gens, counters, what, eager_context=contextlib.nullcontext,
                   profile_gens=None) -> tuple[dict, object]:
    """``gens`` eager steps from ``s0`` (timed, launches counted, inside
    ``eager_context()``), then ``run(gens)`` (the capture, then a replay)
    and ``run_segment(gens)``, each equal to the eager steps on every leaf
    bit for bit (NaN rows at the same places), with no host sync in a
    segment: the profiled segment is ``run_segment(profile_gens)`` (by
    default ``gens``; fewer, a capture of its own, where a generation is
    thousands of device operations that the profiler is slow to read)."""
    import torch

    for c in counters.values():
        c.launches = 0

    def eager():
        s = s0
        with eager_context():
            for _ in range(gens):
                s = wf.step(s)
        return s

    eager_ms, eager_host_ms, ref = timed(eager, gens)
    launches = {k: c.launches for k, c in counters.items()}
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fused = wf.run(s0, gens, init=False)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_peak_gb = (torch.cuda.max_memory_allocated() - allocated) / 1e9
    leaves = same_state(fused, ref, f"{what}: run({gens}) vs {gens} eager steps (capture)")
    run_ms, run_host_ms, fused = timed(lambda: wf.run(s0, gens, init=False), gens)
    same_state(fused, ref, f"{what}: replayed run({gens}) vs eager steps")
    seg_ms, _, (seg, _) = timed(lambda: wf.run_segment(s0, gens), gens)
    same_state(seg, ref, f"{what}: run_segment({gens}) vs eager steps")
    pg = profile_gens or gens
    per_seg = launches_per_call(lambda: wf.run_segment(s0, pg, metrics=False), calls=1)
    if per_seg["host_syncs"] != 0:
        raise AssertionError(f"{what}: a segment made host syncs: {per_seg}")
    del fused, seg
    row = {
        "eager_ms_per_gen": eager_ms, "eager_host_ms_per_gen": eager_host_ms,
        "run_ms_per_gen": run_ms, "run_host_ms_per_gen": run_host_ms,
        "segment_ms_per_gen": seg_ms, "capture_s": capture_s, "capture_peak_gb": capture_peak_gb,
        "segment_device_ops_per_gen": per_seg["launches"] / pg,
        "segment_host_syncs_per_gen": per_seg["host_syncs"] / pg,
        "segment_device_ms_per_gen": per_seg["device_ms"] / pg,
        "segment_idle_share": 1 - per_seg["device_ms"] / pg / run_ms,
        "leaves_equal": leaves, "launches_in_eager_steps": launches,
    }
    if pg != gens:
        row["profiled_segment_gens"] = pg
    return row, ref


def check_launches(name, launches, gens, what):
    want = {k: v * gens for k, v in PATH_LAUNCHES[name].items()}
    if launches != want:
        raise AssertionError(f"{name} {what}: launches {launches}, expected {want} in {gens} generations")


def ulps(a, b):
    """Units in the last place between float32 tensors (0-dim or not)."""
    return (ordered_bits(a.float()) - ordered_bits(b.float())).abs()


def ulp32(x):
    """The float32 spacing above each value of ``x``, as float64."""
    import torch

    x = x.float()
    return (torch.nextafter(x, torch.full_like(x, float("inf"))) - x).double()


def apd_allowance(cos, norm, theta, m):
    """The largest card-against-CPU APD disagreement of each row that the
    stated limits allow, from the CPU's best cosine ``cos`` and objective
    norm ``norm`` alone (float64)."""
    import torch

    c = cos.double()
    span = torch.arccos(torch.clamp(c - COS_ABS_LIMIT, min=0.0)) - torch.arccos(
        torch.clamp(c + COS_ABS_LIMIT, max=1.0))
    angle = torch.arccos(c)
    apd = (1.0 + m * float(theta) * angle) * norm.double()
    return m * float(theta) * norm.double() * (span + ACOS_REL * angle) + APD_REL * apd


def table_entries(obj, v, rows, cols):
    """Entries of the full clipped (n, r) cosine table, as the selection
    computes it on ``obj``'s device."""
    from evox_tpu_torch.operators.selection import rvea_selection as rs

    table = rs._cosine_similarity(obj, v).clamp_(0.0, 1.0)
    out = table[rows.to(obj.device), cols.to(obj.device)].cpu()
    del table
    return out


def selection_card_vs_cpu(x, f, v, theta) -> dict:
    """One ``ref_vec_guided`` on the same merged inputs on the card and on
    the CPU.  The card's selection must equal the survivors of its own APD
    terms.  The card's best cosine of every finite row must lie within
    ``COS_ABS_LIMIT`` of the CPU's, and its APD within ``apd_allowance``
    of the CPU's.  Where the two devices' survivors or empty (NaN) vectors
    differ, each difference must be a flip between near-equal values: a
    row that the devices place in different vectors has its cosines to
    both vectors within ``COS_ABS_LIMIT`` on the two devices, and on the
    CPU within ``2·COS_ABS_LIMIT`` plus ``FLIP_ULP`` units of each other;
    or two rows that both devices place in the vector have CPU APDs within
    the sum of their allowances plus ``FLIP_ULP`` units."""
    import torch
    from evox_tpu_torch.operators.selection import rvea_selection as rs

    nv, m = v.shape[0], f.shape[1]
    got_x, got_f = rs.ref_vec_guided(x, f, v, theta)
    terms_g = rs._apd_terms(f, v, theta)
    ind_g, null_g = rs._survivor_rows(terms_g[0], terms_g[2], terms_g[3], nv)
    nan = torch.full((), float("nan"), device=f.device)
    exact(got_f, torch.where(null_g[:, None], nan, f[ind_g]), "card selection vs its own APD terms")
    exact(got_x, torch.where(null_g[:, None], nan, x[ind_g]), "card selection rows vs its own APD terms")
    fc, vc, tc = f.cpu(), v.cpu(), theta.cpu()
    assoc_c, cos_c, vals_c, nan_c = rs._apd_terms(fc, vc, tc)
    ind_c, null_c = rs._survivor_rows(assoc_c, vals_c, nan_c, nv)
    assoc_g, cos_g, vals_g = (t.cpu() for t in terms_g[:3])
    ind_g, null_g = ind_g.cpu(), null_g.cpu()

    def objectives(t):
        return torch.clamp(t - torch.nan_to_num(t, nan=float("inf")).amin(dim=0), min=1e-32)

    obj_g, obj_c = objectives(f), objectives(fc)
    finite = ~nan_c
    cos_diff = (cos_g - cos_c).double().abs()[finite]
    allowed = apd_allowance(cos_c, torch.linalg.vector_norm(obj_c, dim=1), tc, m)
    apd_diff = (vals_g.double() - vals_c.double()).abs()
    if not torch.equal(~torch.isfinite(vals_g), ~torch.isfinite(vals_c)):
        raise AssertionError("RVEA selection: the devices' non-finite APD rows differ")
    if cos_diff.numel() and float(cos_diff.max()) > COS_ABS_LIMIT:
        raise AssertionError(f"RVEA selection: a card cosine differs from the CPU's by {float(cos_diff.max())}"
                             f" > {COS_ABS_LIMIT}")
    excess = (apd_diff - allowed)[finite]
    if excess.numel() and float(excess.max()) > 0:
        r = int(torch.nonzero(finite).flatten()[int(excess.argmax())])
        raise AssertionError(f"RVEA selection: row {r}'s card APD differs from the CPU's by {float(apd_diff[r])}"
                             f" > the allowed {float(allowed[r])}")

    # Rows in different vectors: both devices' cosines to both vectors.
    moved = torch.nonzero(assoc_g != assoc_c).flatten()
    rows2 = moved.repeat_interleave(2)
    cols2 = torch.stack([assoc_g[moved], assoc_c[moved]], dim=1).flatten()
    pair_g = table_entries(obj_g, v, rows2, cols2).view(-1, 2)
    pair_c = table_entries(obj_c, vc, rows2, cols2).view(-1, 2)
    if pair_g.numel() and float((pair_g.double() - pair_c.double()).abs().max()) > COS_ABS_LIMIT:
        raise AssertionError("RVEA selection: a moved row's card cosines differ from the CPU's beyond the limit")
    tie = {}
    for i, r in enumerate(moved.tolist()):
        gap = float((pair_c[i, 1].double() - pair_c[i, 0].double()).abs())
        tie[r] = (gap, gap <= 2 * COS_ABS_LIMIT + FLIP_ULP * float(ulp32(pair_c[i].max())))

    differ = torch.nonzero((ind_g != ind_c) & ~null_c & ~null_g | (null_g != null_c)).flatten().tolist()
    flips, kinds = [], {"vector": 0, "apd": 0}
    for j in differ:
        rows = [int(i[j]) for i, null in ((ind_g, null_g), (ind_c, null_c)) if not bool(null[j])]
        row = {"vector": j, "card_row": None if bool(null_g[j]) else rows[0],
               "cpu_row": None if bool(null_c[j]) else rows[-1]}
        ok = False
        for r in rows:
            if r in tie:
                row[f"row_{r}_cpu_cos_gap"] = tie[r][0]
                ok = ok or tie[r][1]
        if ok:
            kinds["vector"] += 1
        elif len(rows) == 2:
            a, b = rows
            gap = abs(float(vals_c[a]) - float(vals_c[b]))
            limit = float(allowed[a] + allowed[b]) + FLIP_ULP * float(ulp32(vals_c[[a, b]].max()))
            row.update({"cpu_apd_gap": gap, "apd_gap_limit": limit})
            ok = gap <= limit
            kinds["apd"] += ok
        row["explained"] = ok
        flips.append(row)
        if not ok:
            raise AssertionError(f"RVEA selection: vector {j} differs beyond a flip: {row}")
    return {
        "vectors": nv, "empty_vectors_card": int(null_g.sum()), "empty_vectors_cpu": int(null_c.sum()),
        "vectors_differ": len(differ), "vector_flips": kinds["vector"], "apd_flips": kinds["apd"],
        "rows_changing_vector": int(moved.numel()),
        "max_cos_abs_diff": float(cos_diff.max()) if cos_diff.numel() else 0.0,
        "cos_abs_limit": COS_ABS_LIMIT,
        "max_apd_ulp": int(ulps(vals_g[finite], vals_c[finite]).max()) if bool(finite.any()) else 0,
        "max_apd_share_of_allowance": float((apd_diff / allowed)[finite].max()) if bool(finite.any()) else 0.0,
        "flips": flips[:10],
    }


def cosine_passes(f, v, device_ms_per_gen) -> dict:
    """The selection's passes over its (2r, r) cosine table on the path's
    merged objectives, timed alone with CUDA events: the matrix product
    that writes it, the in-place clip, the row max (value and index); and
    their share of a generation's device time."""
    import torch
    from evox_tpu_torch.operators.selection import rvea_selection as rs

    obj = torch.clamp(f - torch.nan_to_num(f, nan=float("inf")).amin(dim=0), min=1e-32)
    table = rs._cosine_similarity(obj, v)
    out = {
        "table_mb": table.numel() * table.element_size() / 1e6,
        "product_ms": time_ms(lambda: rs._cosine_similarity(obj, v), 10),
        "clip_ms": time_ms(lambda: table.clamp_(0.0, 1.0), 10),
        "row_max_ms": time_ms(lambda: torch.max(table, dim=1), 10),
    }
    total = out["product_ms"] + out["clip_ms"] + out["row_max_ms"]
    out["bytes_bound_ms"] = 4 * table.numel() * table.element_size() / PEAK_BYTES_PER_S * 1e3
    out["share_of_device_ms"] = total / device_ms_per_gen
    del table
    return out


def phase_rvea_main_path(device) -> dict:
    """bench.py's rvea_dtlz2 through the port: StdWorkflow(RVEA(10000, 3,
    zeros(12), ones(12)), DTLZ2(d=12, m=3)), float32, no monitor; 9870
    reference vectors, 19,740 merged rows.  init_step, warm-up, timed and
    profiled eager steps (the Philox draws launch three times a
    generation), then run(20) and run_segment(20) bit for bit against 20
    eager steps with no host sync in a segment; IGD of the valid rows must
    fall; one selection on the last timed step's merged inputs on the card
    and on the CPU (``selection_card_vs_cpu``)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on: the cosine tables must be full float32")
    counters = path_launch_counters()
    wf, problem, algo = mo_workflow("RVEA", RVEA_POP, device)
    pf = problem.pf()
    merged = []
    select = algo.selection

    def recording(x, f, v, theta):
        merged[:] = [(x, f, v, theta)]
        return select(x, f, v, theta)

    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    algo.selection = recording
    try:
        t0 = time.perf_counter()
        state = wf.init_step(wf.init(0))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        igd0 = igd_valid(state.algorithm.fit, pf)
        for _ in range(MAIN_WARMUP):
            state = wf.step(state)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(MAIN_STEPS):
            state = wf.step(state)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / MAIN_STEPS
        ms = start.elapsed_time(end) / MAIN_STEPS
        inputs = merged[0]
        state, prof = profile_steps(wf.step, state, PROFILE_STEPS)
    finally:
        algo.selection = select
    steps = MAIN_WARMUP + MAIN_STEPS + PROFILE_STEPS
    launches = {k: c.launches for k, c in counters.items()}
    # The setup's one draw (the first population), then the steps'.
    want = {k: v * steps + (k == "philox_draws") for k, v in PATH_LAUNCHES["RVEA"].items()}
    if launches != want:
        raise AssertionError(f"RVEA launches {launches}, expected {want} ({steps} steps + setup)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_gen = launches_per_call(lambda: wf.step(state), calls=3)
    fused, ref = fused_vs_eager(wf, state, SEGMENT_GENS, counters, "RVEA")
    check_launches("RVEA", fused.pop("launches_in_eager_steps"), SEGMENT_GENS, "eager steps")
    algo_state = ref.algorithm
    igd1 = igd_valid(algo_state.fit, pf)
    if not igd1 < igd0:
        raise AssertionError(f"RVEA IGD did not fall: {igd0} -> {igd1}")
    n_vec = algo.pop_size
    if algo_state.pop.shape != (n_vec, NSGA2_DIM) or algo_state.fit.shape != (n_vec, NSGA2_OBJ):
        raise AssertionError("wrong RVEA state shapes")
    valid = ~torch.isnan(algo_state.fit).any(dim=1)
    if not bool(torch.isfinite(algo_state.fit[valid]).all()) or int(valid.sum()) == 0:
        raise AssertionError("RVEA: no valid row, or a valid row that is not finite")
    x_m, f_m, v_m, theta_m = inputs
    selection = selection_card_vs_cpu(x_m, f_m, v_m, theta_m)
    cosine = cosine_passes(f_m, v_m, per_gen["device_ms"])
    return {
        "config": f"RVEA pop={RVEA_POP} ({n_vec} vectors) d=12 m=3 DTLZ2 f32, StdWorkflow, no monitor",
        "merged_rows": int(f_m.shape[0]), "steps": steps, "launches": launches,
        "ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms,
        "per_gen": {k: per_gen[k] for k in ("launches", "host_syncs", "device_ms")},
        "idle_share": 1 - per_gen["device_ms"] / ms,
        "fused": fused, "setup_s": setup_s, "igd_after_init": igd0, "igd_final": igd1,
        "valid_rows_final": int(valid.sum()), "selection_card_vs_cpu": selection,
        "cosine_passes": cosine, "peak_mem_gb": peak_gb, "profile": prof,
    }


# The family's algorithms that rank their merged population, by module.
RANKING_MODULES = {"NSGA3": "nsga3", "RVEAa": "rveaa", "HypE": "hype"}


@contextlib.contextmanager
def recording_ranks(name, seen):
    """While active, the ``non_dominate_rank`` that algorithm ``name``'s
    module calls keeps the objectives and ``until_count`` of its last call
    in ``seen`` (nothing for an algorithm that does not rank)."""
    import importlib

    if name not in RANKING_MODULES:
        yield
        return
    module = importlib.import_module(f"evox_tpu_torch.algorithms.mo.{RANKING_MODULES[name]}")
    rank = module.non_dominate_rank

    def recording(f, until_count=None):
        seen[:] = [(f, until_count)]
        return rank(f, until_count=until_count)

    module.non_dominate_rank = recording
    try:
        yield
    finally:
        module.non_dominate_rank = rank


def ranking_on_path(name, f, until_count) -> dict:
    """The ranking kernels on the objectives and ``until_count`` that the
    last eager step of ``name`` gave ``non_dominate_rank``, each held
    exactly against its plain version."""
    import torch
    from evox_tpu_torch.ops import dominance

    f = f.contiguous()
    words = dominance.dominance_packed(f)
    errs = {"dominance_packed": exact(words, dominance.dominance_packed_plain(f),
                                      f"{name}: dominance_packed on the path's objectives")}
    rank = dominance.peel_fronts(words, until_count)
    errs["peel_fronts"] = exact(rank, dominance.peel_fronts_plain(words, until_count),
                                f"{name}: peel_fronts on the path's words, until_count={until_count}")
    return {"rows": int(f.shape[0]), "until_count": until_count,
            "inf_rows": int(torch.isinf(f).all(dim=1).sum()), "fronts_ranked": fronts_of(rank),
            "ranked_rows": int((rank < f.shape[0]).sum()), "max_abs_err": errs}


def phase_mo_family(device) -> dict:
    """The rest of the family on DTLZ2(d=12, m=3): NSGA-III at pop 10000,
    RVEAa, MOEA/D and HypE at pop 1000.  Each: init_step, warm-up, 20
    eager steps (launches counted: the ranking kernels once a generation
    on NSGA-III, RVEAa and HypE), run(20) and run_segment(20) bit for bit
    against them, IGD falling; on those three, both ranking kernels held
    exactly against their plain versions on the last eager step's merged
    objectives and until_count (``ranking_on_path``).  Then DTLZ1 and
    DTLZ3-7 on 10000 rows and their fronts, card against CPU (rtol 1e-5)."""
    import torch
    from evox_tpu_torch.problems import numerical

    counters = path_launch_counters()
    out, launches_total = {}, {k: 0 for k in counters}
    max_err = {"dominance_packed": 0.0, "peel_fronts": 0.0}
    for name, pop in MO_FAMILY:
        torch.cuda.reset_peak_memory_stats()
        wf, problem, algo = mo_workflow(name, pop, device)
        pf = problem.pf()
        state = wf.init_step(wf.init(0))
        igd0 = igd_valid(state.algorithm.fit, pf)
        for _ in range(MAIN_WARMUP):
            state = wf.step(state)
        seen = []
        row, ref = fused_vs_eager(wf, state, SEGMENT_GENS, counters, name,
                                  lambda: recording_ranks(name, seen))
        launches = row.pop("launches_in_eager_steps")
        check_launches(name, launches, SEGMENT_GENS, "eager steps")
        if name in RANKING_MODULES:
            row["ranking_on_path"] = ranking_on_path(name, *seen[0])
            for k, e in row["ranking_on_path"]["max_abs_err"].items():
                max_err[k] = max(max_err[k], e)
        for k, v in launches.items():
            launches_total[k] += v
        igd1 = igd_valid(ref.algorithm.fit, pf)
        if not igd1 < igd0:
            raise AssertionError(f"{name} IGD did not fall: {igd0} -> {igd1}")
        per_gen = launches_per_call(lambda: wf.step(state), calls=3)
        if name == "RVEAa":
            # The final-generation truncation, computed every generation
            # (a torch.where keeps it only at max_gen).
            final = ref.algorithm
            row["truncation"] = {
                "ms": time_ms(lambda: algo._batch_truncation(final.pop, final.fit), 10),
                **{k: v for k, v in launches_per_call(
                    lambda: algo._batch_truncation(final.pop, final.fit), calls=3).items() if k != "kernels"},
            }
        row.update({
            "pop": algo.pop_size, "igd_after_init": igd0, "igd_final": igd1,
            "launches_per_gen": {k: v / SEGMENT_GENS for k, v in launches.items()},
            "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
            "eager_device_ms_per_gen": per_gen["device_ms"],
            "eager_idle_share": 1 - per_gen["device_ms"] / row["eager_ms_per_gen"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        })
        out[name] = row
        del wf, state, ref
        torch.cuda.empty_cache()
    suite = {}
    for name in DTLZ_SUITE:
        on_card = getattr(numerical, name)(device=device)
        on_cpu = getattr(numerical, name)(device="cpu")
        g = torch.Generator(device=device).manual_seed(len(name))
        x = torch.rand((DTLZ_ROWS, on_card.d), generator=g, device=device)
        got, _ = on_card.evaluate(None, x)
        want, _ = on_cpu.evaluate(None, x.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(on_card.pf().cpu(), on_cpu.pf(), rtol=1e-5, atol=1e-7)
        suite[name] = {"d": on_card.d, "max_abs_diff": float((got.cpu() - want).abs().max()),
                       "pf_rows": int(on_cpu.pf().shape[0])}
    out["dtlz_suite"] = suite
    out["launches"] = launches_total
    out["max_abs_err"] = max_err
    return out


# ---------------------------------------------------------------------------
# Slice 7: the CEC2022 suite and the DE family.
# ---------------------------------------------------------------------------

DE_POP, DE_DIM, DE_FN = 10_000, 20, 5  # bench.py's de_cec: DE(10_000, ±100 in dim 20), CEC2022(5, 20)
# The rest of the family at de_cec's width (bench.py has no config for
# them).
DE_FAMILY = ["ODE", "JaDE", "SHADE", "SaDE", "CoDE"]
# Philox launches a generation, one a random operator: DE and ODE the index
# table and the crossover; JaDE the F/CR normals, the table, the p-best
# pick and the crossover; SHADE the memory permutation, the normals, the
# difference table, the p-best pick and the crossover; SaDE the
# strategies, the CR normals, the F normals, the table, the p-best pick and
# both crossovers; CoDE the parameter ids and, for each of its three
# strategies, the table and the binary crossover (none for the arithmetic
# one).
DE_PHILOX = {"DE": 2, "ODE": 2, "JaDE": 4, "SHADE": 5, "SaDE": 7, "CoDE": 6}
CEC_ROWS = 10_000
# The card's float32 CEC2022 against the CPU's: the CPU tests' tolerance
# against JAX (tests/test_torch_cec2022.py): the rotation is summed in
# another order and F1/F3/F5 are ill-conditioned (sines of arguments up to
# ~400, Zakharov's fourth power of a cancelling sum).
CEC_RTOL = 2e-4
CEC_GOLDEN_RTOL = 1e-8  # the JAX package's own oracle limit (tests/test_cec2022.py)


def cec_pairs():
    return [(fn, d) for d in (2, 10, 20) for fn in range(1, 13) if not (fn in (6, 7, 8) and d == 2)]


def de_workflow(name, device):
    """``StdWorkflow(name(DE_POP, full(20, -100), full(20, 100)),
    CEC2022(5, 20))`` on ``device``."""
    import torch
    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems.numerical import CEC2022
    from evox_tpu_torch.workflows import StdWorkflow

    lb, ub = torch.full((DE_DIM,), -100.0), torch.full((DE_DIM,), 100.0)
    return StdWorkflow(getattr(algorithms, name)(DE_POP, lb, ub, device=device),
                       CEC2022(DE_FN, DE_DIM, device=device))


def phase_cec2022_suite(device) -> dict:
    """Every defined (function, D) pair on the card: in float64 on the
    oracle's probe points (tests/cec2022_golden.json, read in place) at
    rtol 1e-8; in float32 on 10,000 seeded rows in [-100, 100]^D plus every
    shift point (each composition component's, exactly on it) against the
    CPU at CEC_RTOL; the rotation must give the same bits when the process
    allows TF32 (it takes its product in float64).  Then device ms and
    device operations per evaluation at (10000, 20) for each function."""
    import torch
    from evox_tpu_torch.problems.numerical import CEC2022

    with open(os.path.join(ROOT, "tests", "cec2022_golden.json")) as f:
        golden = json.load(f)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on at the start of the CEC2022 phase")
    out, worst64, worst32 = {}, 0.0, 0.0
    for fn, d in cec_pairs():
        x64 = torch.tensor(golden["inputs"][str(d)], dtype=torch.float64, device=device)
        got64, _ = CEC2022(fn, d, dtype=torch.float64, device=device).evaluate(None, x64)
        want64 = torch.tensor(golden["golden"][f"{fn}_{d}"], dtype=torch.float64)
        rel64 = float(((got64.cpu() - want64).abs() / want64.abs()).max())
        if not rel64 <= CEC_GOLDEN_RTOL:
            raise AssertionError(f"CEC2022 f{fn} D={d} float64: {rel64} from the oracle")
        on_card = CEC2022(fn, d, device=device)
        g = torch.Generator(device=device).manual_seed(100 * fn + d)
        x = torch.cat([torch.rand((CEC_ROWS, d), generator=g, device=device) * 200 - 100,
                       on_card.shift.reshape(-1, d)])
        got, _ = on_card.evaluate(None, x)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32, _ = on_card.evaluate(None, x)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        exact(got_tf32, got, f"CEC2022 f{fn} D={d} with TF32 allowed by the process")
        want, _ = CEC2022(fn, d, device="cpu").evaluate(None, x.cpu())
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"CEC2022 f{fn} D={d}: a value that is not finite")
        rel = float(((got.cpu() - want).abs() / want.abs()).max())
        if not rel <= CEC_RTOL:
            raise AssertionError(f"CEC2022 f{fn} D={d} float32 card vs CPU: rtol {rel} > {CEC_RTOL}")
        worst64, worst32 = max(worst64, rel64), max(worst32, rel)
        row = {"float64_max_rel_vs_oracle": rel64, "float32_max_rel_vs_cpu": rel, "rows": int(x.shape[0])}
        if d == DE_DIM:
            xt = x[:CEC_ROWS].contiguous()
            row["ms_per_eval_10000x20"] = time_ms(lambda: on_card.evaluate(None, xt), 20)
            prof = launches_per_call(lambda: on_card.evaluate(None, xt), calls=3)
            row["device_ops_per_eval"] = prof["launches"]
            row["device_ms_per_eval"] = prof["device_ms"]
            row["host_syncs_per_eval"] = prof["host_syncs"]
            if prof["host_syncs"] != 0:
                raise AssertionError(f"CEC2022 f{fn}: an evaluation made host syncs: {prof}")
        out[f"f{fn}_D{d}"] = row
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products were left on")
    return {"pairs": len(out), "float64_max_rel_vs_oracle": worst64, "float32_max_rel_vs_cpu": worst32,
            "float32_rtol": CEC_RTOL, "functions": out}


@contextlib.contextmanager
def recording_draws(seen):
    """While active, every launch of the Philox kernel (``ops.philox``'s
    ``_launch``: the solo route, and the batched one a vmap's rule takes)
    appends (keys, index, derive, numel, kinds, solo, outputs) to
    ``seen``, with the keys and outputs copied.  The entry points'
    ``.launches`` are restored on exit: a recorded step is not counted on
    the path."""
    from evox_tpu_torch.ops import philox

    launch = philox._launch
    counts = philox.philox_draws.launches, philox.philox_draws_batched.launches

    def recording(keys, index, derive, numel, codes, lows, spans, solo):
        out = launch(keys, index, derive, numel, codes, lows, spans, solo)
        seen.append((keys.clone(), index, derive, numel, philox._kinds(codes, lows, spans), solo,
                     [o.clone() for o in out]))
        return out

    philox._launch = recording
    try:
        yield
    finally:
        philox._launch = launch
        philox.philox_draws.launches, philox.philox_draws_batched.launches = counts


def draws_on_path(name, seen) -> dict:
    """Each launch that one eager step of ``name`` made (``recording_draws``)
    replayed through philox_draws_batched_plain on the same keys, bit for
    bit; the launches by route, and the layouts (streams x elements:
    kinds)."""
    from evox_tpu_torch.ops import philox

    if not seen:
        raise AssertionError(f"{name}: the recorded step made no draw")
    worst, layouts = 0.0, set()
    routes = {"philox_draws": 0, "philox_draws_batched": 0}
    for keys, index, derive, numel, kinds, solo, got in seen:
        want = philox.philox_draws_batched_plain(keys, index, numel, kinds, derive)
        for g, w in zip(got, want):
            worst = max(worst, exact(g, w, f"{name}: philox {keys.shape[0]} x {numel} {kinds} on the path"))
        routes["philox_draws" if solo else "philox_draws_batched"] += 1
        layouts.add(f"{keys.shape[0]}x{numel}:" + ",".join(str(k).replace("torch.", "").replace(" ", "")
                                                        for k in kinds))
    return {"calls": len(seen), "launches": routes, "layouts": sorted(layouts), "max_abs_err": worst}


def de_path(name, device, timed_eager) -> tuple[dict, object]:
    """One DE-family path at de_cec's width: init_step, warm-up, (for the
    main path, timed and profiled eager steps), then 20 eager steps against
    run(20) and run_segment(20) bit for bit (``fused_vs_eager``, no host
    sync in a segment); Philox launches a generation checked, and the draws
    of one eager step replayed through the plain version bit for bit
    (``recording_draws``); the best fitness must fall from init_step to the last step; the population
    stays finite and in the box."""
    import torch
    from evox_tpu_torch.ops.philox import philox_draws

    counters = {"philox_draws": philox_draws}
    torch.cuda.reset_peak_memory_stats()
    wf = de_workflow(name, device)
    philox_draws.launches = 0
    t0 = time.perf_counter()
    state = wf.init_step(wf.init(0))
    best0 = float(state.algorithm.fit.min())
    torch.cuda.synchronize()
    row = {"setup_s": time.perf_counter() - t0}
    for _ in range(MAIN_WARMUP):
        state = wf.step(state)
    steps = MAIN_WARMUP
    if timed_eager:
        def eager(s=state):
            for _ in range(MAIN_STEPS):
                s = wf.step(s)
            return s

        ms, host_ms, state = timed(eager, MAIN_STEPS)
        state, prof = profile_steps(wf.step, state, PROFILE_STEPS)
        steps += MAIN_STEPS + PROFILE_STEPS
        row.update({"ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms, "profile": prof})
    # The setup's one draw (the first population), then the steps'.
    want = 1 + DE_PHILOX[name] * steps
    if philox_draws.launches != want:
        raise AssertionError(f"{name}: philox_draws launched {philox_draws.launches} times, expected {want}")
    launches = philox_draws.launches
    seen = []
    with recording_draws(seen):
        wf.step(state)
    on_path = draws_on_path(name, seen)
    if on_path["calls"] != DE_PHILOX[name]:
        raise AssertionError(f"{name}: {on_path['calls']} draws recorded in one step")
    del seen
    per_gen = launches_per_call(lambda: wf.step(state), calls=3)
    fused, ref = fused_vs_eager(wf, state, SEGMENT_GENS, counters, name)
    eager_launches = fused.pop("launches_in_eager_steps")["philox_draws"]
    if eager_launches != DE_PHILOX[name] * SEGMENT_GENS:
        raise AssertionError(f"{name}: {eager_launches} Philox launches in {SEGMENT_GENS} eager steps")
    algo = ref.algorithm
    best1 = float(algo.fit.min())
    if not best1 < best0:
        raise AssertionError(f"{name}: the best fitness did not fall: {best0} -> {best1}")
    if algo.pop.shape != (DE_POP, DE_DIM) or algo.fit.shape != (DE_POP,):
        raise AssertionError(f"{name}: wrong state shapes")
    if not (bool(torch.isfinite(algo.pop).all()) and bool(torch.isfinite(algo.fit).all())):
        raise AssertionError(f"{name}: a population or fitness value that is not finite")
    if float(algo.pop.min()) < -100.0 or float(algo.pop.max()) > 100.0:
        raise AssertionError(f"{name}: the population left the box")
    eager_ms = row.get("ms_per_gen", fused["eager_ms_per_gen"])
    row.update({
        "config": f"{name} pop={DE_POP} dim={DE_DIM} CEC2022 f{DE_FN} f32, StdWorkflow, no monitor",
        "steps": steps, "launches": {"philox_draws": launches + eager_launches},
        "philox_per_gen": DE_PHILOX[name], "philox_on_path_vs_plain": on_path,
        "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
        "eager_device_ms_per_gen": per_gen["device_ms"],
        "eager_idle_share": 1 - per_gen["device_ms"] / eager_ms,
        "fused": fused, "best_after_init": best0, "best_final": best1,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    del wf, state, ref
    torch.cuda.empty_cache()
    return row


def phase_de_main_path(device) -> dict:
    """bench.py's de_cec through the port at full width:
    StdWorkflow(DE(10000, full(20, -100), full(20, 100)), CEC2022(5, 20)),
    float32, no monitor (``de_path``, with timed and profiled eager
    steps)."""
    import torch

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matrix products are on: the CEC2022 rotation must be full float32")
    return de_path("DE", device, timed_eager=True)


def phase_de_family(device) -> dict:
    """ODE, JaDE, SHADE, SaDE and CoDE at de_cec's width on CEC2022(5, 20)
    (``de_path``: eager against run(20) and run_segment(20) bit for bit)."""
    out = {name: de_path(name, device, timed_eager=False) for name in DE_FAMILY}
    out["launches"] = {"philox_draws": sum(out[n]["launches"]["philox_draws"] for n in DE_FAMILY)}
    return out


# ---------------------------------------------------------------------------
# Slice 8: the ES family (cmaes_cec and openes_cec at bench width).
# ---------------------------------------------------------------------------

ES_DIM, ES_FN = 20, 1  # bench.py's cmaes_cec and openes_cec: CEC2022(1, 20)
CMAES_POP = 64  # bench.py's cmaes_cec: CMAES(zeros(20), 5.0, pop_size=64)
OPENES_POP = 8192  # bench.py's openes_cec: OpenES(8192, zeros(20), 0.05, 1.0, optimizer="adam")
CADENCE_DIM = 1000  # CMAES(zeros(1000), 1.0): pop 24, decomp_per_iter 8
CADENCE_GENS = 16
# The other ten at openes_cec's width (pop 8192, D = 20, CEC2022 f1; ESMC
# 8193, an odd size), XNES and SeparableNES at cmaes_cec's pop 64;
# bench.py has no config for them.  The variants that step by the raw
# gradient estimate (GuidedES, PersistentES, NoiseReuseES, ESMC) diverge
# on f1, whose fitness starts near 1e13, with their default rate, so they
# run with Adam at rate 0.5.
ES_FAMILY = {
    "XNES": lambda c, d: ("XNES", (c, d["eye"]), dict(pop_size=CMAES_POP)),
    "SeparableNES": lambda c, d: ("SeparableNES", (c, d["ones"]), dict(pop_size=CMAES_POP)),
    "SNES": lambda c, d: ("SNES", (OPENES_POP, c), {}),
    "DES": lambda c, d: ("DES", (OPENES_POP, c), {}),
    "ARS": lambda c, d: ("ARS", (OPENES_POP, c), {}),
    "ASEBO": lambda c, d: ("ASEBO", (OPENES_POP, c), {}),
    "GuidedES": lambda c, d: ("GuidedES", (OPENES_POP, c), dict(optimizer="adam", lr=0.5)),
    "PersistentES": lambda c, d: ("PersistentES", (OPENES_POP, c), dict(optimizer="adam", lr=0.5)),
    "NoiseReuseES": lambda c, d: ("NoiseReuseES", (OPENES_POP, c), dict(optimizer="adam", lr=0.5)),
    "ESMC": lambda c, d: ("ESMC", (OPENES_POP + 1, c), dict(optimizer="adam", lr=0.5)),
}
# Philox launches: one a draw; every algorithm draws once a generation but
# GuidedES (twice, and once at setup for its first gradient subspace).
ES_PHILOX = {"GuidedES": 2}
ES_SETUP_PHILOX = {"GuidedES": 1}
# cuSOLVER syevjBatched calls (ops.linalg.eigh on the card) a generation:
# CMA-ES decomposes its covariance, ASEBO takes its SVD from the Gram
# matrix's eigenvectors.
ES_EIGH = {"CMAES": 1, "ASEBO": 1}
# The card's decomposition of a cmaes_cec step's C against a float64 CPU
# eigh of the same C (symmetrised, eigenvalues clipped at 1e-8, as the
# step does): eigenvalues within EIGVAL_RTOL of the largest, A A^T and
# C^{-1/2} within these relative Frobenius errors.  cuSOLVER's Jacobi
# sweeps stop at float32's machine accuracy: the probe measured 2.3e-6 on
# eigenvalues and 2.9e-6 on the reconstruction of a (20, 20) matrix of
# condition ~10; C^{-1/2} adds a factor of up to sqrt(cond(C)).
EIGVAL_RTOL = 1e-5
RECON_RTOL = 1e-5
INVSQRT_RTOL = 1e-4


def es_workflow(name, device, monitor=None):
    """One ES path: cmaes_cec (``CMAES``), openes_cec (``OpenES``) or a
    member of ES_FAMILY, on CEC2022(1, 20), float32."""
    import torch
    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems.numerical import CEC2022
    from evox_tpu_torch.workflows import StdWorkflow

    c = torch.zeros(ES_DIM)
    if name == "CMAES":
        algo = algorithms.CMAES(c, 5.0, pop_size=CMAES_POP, device=device)
    elif name == "OpenES":
        algo = algorithms.OpenES(OPENES_POP, c, 0.05, 1.0, optimizer="adam", device=device)
    else:
        cls, args, kw = ES_FAMILY[name](c, {"eye": torch.eye(ES_DIM), "ones": torch.ones(ES_DIM)})
        algo = getattr(algorithms, cls)(*args, device=device, **kw)
    return StdWorkflow(algo, CEC2022(ES_FN, ES_DIM, device=device), monitor=monitor)


def decomposition_vs_cpu(state) -> dict:
    """The card's decomposition of one cmaes_cec step's C (``A`` and
    ``C^{-1/2}`` of the state, and ``ops.linalg.eigh`` of the symmetrised C
    called again) against ``torch.linalg.eigh`` of the same C in float64
    on the CPU."""
    import torch
    from evox_tpu_torch.ops import linalg

    C = state.C
    C_sym = (C + C.T) / 2
    w_card, _ = linalg.eigh(C_sym)
    C64 = C_sym.double().cpu()
    w64, B64 = torch.linalg.eigh(C64)
    w64 = torch.clamp(w64, min=1e-8)
    eig_err = float((w_card.double().cpu().clamp(min=1e-8) - w64).abs().max() / w64.abs().max())
    A = state.A.double().cpu()
    recon_err = float(torch.linalg.norm(A @ A.T - C64) / torch.linalg.norm(C64))
    inv64 = (B64 * (1.0 / torch.sqrt(w64))) @ B64.T
    inv_err = float(torch.linalg.norm(state.C_invsqrt.double().cpu() - inv64) / torch.linalg.norm(inv64))
    cond = float(w64.max() / w64.min())
    row = {"eigval_max_rel": eig_err, "recon_rel_fro": recon_err, "c_invsqrt_rel_fro": inv_err,
           "condition": cond, "eigval_rtol": EIGVAL_RTOL, "recon_rtol": RECON_RTOL, "invsqrt_rtol": INVSQRT_RTOL}
    if not (eig_err <= EIGVAL_RTOL and recon_err <= RECON_RTOL and inv_err <= INVSQRT_RTOL):
        raise AssertionError(f"cmaes_cec: the card's decomposition against float64 on the CPU: {row}")
    return row


def es_path(name, device, timed_eager) -> dict:
    """One ES path at its width: init_step, warm-up, (for the main paths,
    timed and profiled eager steps), then 20 eager steps against run(20)
    and run_segment(20) bit for bit (``fused_vs_eager``, no host sync in a
    segment); Philox launches and cuSOLVER eigh calls a generation
    checked, the draws of one eager step replayed through the plain version
    bit for bit (``recording_draws``); the best fitness falls from
    init_step to the last step and every leaf stays finite."""
    import torch
    from evox_tpu_torch.ops import linalg
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.utils import graph

    counters = {"philox_draws": philox_draws, "eigh": linalg.eigh}
    per_gen = {"philox_draws": ES_PHILOX.get(name, 1), "eigh": ES_EIGH.get(name, 0)}
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    wf = es_workflow(name, device)
    t0 = time.perf_counter()
    state = wf.init_step(wf.init(0))
    best0 = float(state.algorithm.fit.min())
    torch.cuda.synchronize()
    a = wf.algorithm
    row = {"config": f"{name} pop={a.pop_size} dim={a.dim} CEC2022 f{ES_FN} f32, StdWorkflow, no monitor",
           "setup_s": time.perf_counter() - t0}
    for _ in range(MAIN_WARMUP):
        state = wf.step(state)
    steps = 1 + MAIN_WARMUP  # init_step is a generation of the ES family
    if timed_eager:
        def eager(s=state):
            for _ in range(MAIN_STEPS):
                s = wf.step(s)
            return s

        ms, host_ms, state = timed(eager, MAIN_STEPS)
        state, prof = profile_steps(wf.step, state, PROFILE_STEPS)
        steps += MAIN_STEPS + PROFILE_STEPS
        row.update({"ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms, "profile": prof})
    setup = {"philox_draws": ES_SETUP_PHILOX.get(name, 0), "eigh": 0}
    for k, c in counters.items():
        want = setup[k] + per_gen[k] * steps
        if c.launches != want:
            raise AssertionError(f"{name}: {k} launched {c.launches} times, expected {want}")
    launches = {k: c.launches for k, c in counters.items()}
    seen = []
    with recording_draws(seen):
        wf.step(state)
    on_path = draws_on_path(name, seen)
    if on_path["calls"] != per_gen["philox_draws"]:
        raise AssertionError(f"{name}: {on_path['calls']} draws recorded in one step")
    del seen
    eager_prof = launches_per_call(lambda: wf.step(state), calls=3)
    fused, ref = fused_vs_eager(wf, state, SEGMENT_GENS, counters, name)
    eager_launches = fused.pop("launches_in_eager_steps")
    for k in counters:
        if eager_launches[k] != per_gen[k] * SEGMENT_GENS:
            raise AssertionError(f"{name}: {eager_launches[k]} {k} launches in {SEGMENT_GENS} eager steps")
    algo = ref.algorithm
    best1 = float(algo.fit.min())
    if not best1 < best0:
        raise AssertionError(f"{name}: the best fitness did not fall: {best0} -> {best1}")
    leaves, _ = graph.flatten(algo)
    if not all(bool(torch.isfinite(x).all()) for x in leaves if x.is_floating_point()):
        raise AssertionError(f"{name}: a state value that is not finite")
    eager_ms = row.get("ms_per_gen", fused["eager_ms_per_gen"])
    row.update({
        "steps": steps, "launches": {k: launches[k] + eager_launches[k] for k in counters},
        "per_gen": per_gen, "philox_on_path_vs_plain": on_path,
        "eager_device_ops_per_gen": eager_prof["launches"], "eager_host_syncs_per_gen": eager_prof["host_syncs"],
        "eager_device_ms_per_gen": eager_prof["device_ms"],
        "eager_idle_share": 1 - eager_prof["device_ms"] / eager_ms,
        "fused": fused, "best_after_init": best0, "best_final": best1,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if name == "CMAES":
        row["sigma_final"] = float(algo.sigma)
        row["decomposition_vs_cpu"] = decomposition_vs_cpu(algo)
        C = ((algo.C + algo.C.T) / 2).contiguous()
        row["eigh_ms_20"] = time_ms(lambda: linalg.eigh(C), 50)
        row["eigh_profile_20"] = launches_per_call(lambda: linalg.eigh(C), calls=5)
        row["torch_linalg_eigh_ms_20"] = time_ms(lambda: torch.linalg.eigh(C), 50)
    del wf, state, ref
    torch.cuda.empty_cache()
    return row


def phase_cmaes_main_path(device) -> dict:
    """bench.py's cmaes_cec through the port at full width:
    StdWorkflow(CMAES(zeros(20), 5.0, pop_size=64), CEC2022(1, 20)),
    float32, no monitor (``es_path`` with timed and profiled eager steps,
    and the decomposition against float64 on the CPU)."""
    return es_path("CMAES", device, timed_eager=True)


def phase_openes_main_path(device) -> dict:
    """bench.py's openes_cec at full width: StdWorkflow(OpenES(8192,
    zeros(20), 0.05, 1.0, optimizer="adam"), CEC2022(1, 20))."""
    return es_path("OpenES", device, timed_eager=True)


def aux_history_check(device) -> dict:
    """OpenES at openes_cec's width with EvalMonitor(full_pop_history=True):
    20 eager steps, then run_segment(20) + flush_telemetry from the same
    state: the auxiliary history key by key, generation by generation, and
    the fitness history, equal bit for bit, on the card."""
    from evox_tpu_torch.workflows import EvalMonitor

    mon = EvalMonitor(full_pop_history=True)
    wf = es_workflow("OpenES", device, monitor=mon)
    s0 = wf.step(wf.init_step(wf.init(1)))
    n0 = {k: len(v) for k, v in mon._history.items()}
    ref = s0
    for _ in range(SEGMENT_GENS):
        ref = wf.step(ref)
    seg, tel = wf.run_segment(s0, SEGMENT_GENS)
    same_state(seg, ref, "OpenES with full_pop_history: run_segment vs eager steps")
    wf.flush_telemetry(tel)
    entries = 0
    aux = mon.aux_history
    if list(aux) != ["center"]:
        raise AssertionError(f"OpenES auxiliary keys {list(aux)}")
    for key, hist in list(aux.items()) + [("fitness", mon.fitness_history)]:
        start = n0[2] if key != "fitness" else n0[0]
        stepped, flushed = hist[start: start + SEGMENT_GENS], hist[start + SEGMENT_GENS:]
        if len(stepped) != SEGMENT_GENS or len(flushed) != SEGMENT_GENS:
            raise AssertionError(f"OpenES {key} history: {len(stepped)} stepped, {len(flushed)} flushed")
        for a, b in zip(flushed, stepped):
            exact(a, b, f"OpenES {key} history entry")
            entries += 1
    if not bool((aux["center"][-1] == ref.algorithm.center.cpu()).all()):
        raise AssertionError("OpenES: the last auxiliary record is not the last center")
    return {"keys": list(aux), "entries_checked": entries}


def phase_es_family(device) -> dict:
    """XNES, SeparableNES, SNES, DES, ARS, ASEBO, GuidedES, PersistentES,
    NoiseReuseES and ESMC (``es_path``: eager against run(20) and
    run_segment(20) bit for bit, the best fitness falling), then OpenES's
    auxiliary history eager against a segment (``aux_history_check``)."""
    out = {name: es_path(name, device, timed_eager=False) for name in ES_FAMILY}
    out["aux_history"] = aux_history_check(device)
    out["launches"] = {k: sum(out[n]["launches"][k] for n in ES_FAMILY) for k in ("philox_draws", "eigh")}
    return out


# The Jacobi eigensolver (csrc/eigh_jacobi.cu) against a float64 CPU eigh,
# relative to |C|_2: eigenvalues, the residual |V diag(w) V^T - C|_2 and
# the orthogonality max |V^T V - I|, and its eigenvalues against the plain
# version's.  float32: 1e-4 at n = 1000, 2e-5 at n <= 100 (the first chip
# runs measured at most 2.8e-5 at n = 1000, a spectrum of condition 1e3,
# and 2.6e-6 at n <= 100); float64: 1e-11 (measured at most 1.7e-12).
EIGH_TOL = {"float32": (2e-5, 1e-4), "float64": (1e-11, 1e-11)}
# NVIDIA's H100 SXM data sheet: float64 on the tensor cores, the card's
# fastest float64 rate (34 TFLOP/s outside them), so the least time.
PEAK_F64_FLOPS = 67e12
# The kernel's cases at n <= 100 (cmaes_large_main_path): spectra of
# condition 1e3 and norm 1 and the identity at each n, and at n = 100 three
# values (0.2, 0.5, 1.0) of multiplicity n/3.
EIGH_SIZES = (33, 64, 100)


def eigh_flops(n, sweeps) -> float:
    """The rotations of ``sweeps`` cyclic Jacobi sweeps over a symmetric
    n x n matrix and its eigenvectors: n(n-1)/2 rotations a sweep, each
    updating one side of A (two rows, 2n entries: the other side is their
    transpose) and two columns of V (2n), three operations an entry (two
    products and a sum), so 12n a rotation."""
    return sweeps * n * (n - 1) / 2 * 12 * n


def eigh_bound(n, sweeps, dtype) -> dict:
    """The least time for the decomposition the kernel computed: C read
    once, the eigenvalues and eigenvectors written once, against the
    rotations' operations in the sweeps it took at the card's peak of
    ``dtype``.  Beside it, ``dense_ms``: the same at the 9 n^3 operations
    of the symmetric QR algorithm with eigenvectors (Golub and Van Loan,
    Matrix Computations, section 8.3), a count no sweep number enters."""
    size = 8 if dtype == "float64" else 4
    peak = PEAK_F64_FLOPS if dtype == "float64" else PEAK_F32_FLOPS
    nbytes = (2 * n * n + n) * size
    ops = eigh_flops(n, sweeps)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return {"bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "dense_ms": max(bytes_ms, 9 * n ** 3 / peak * 1e3)}


def spectrum_matrix(n, kind, dtype, device, seed=0):
    """A symmetric test matrix of norm 1 from a seed: ``spread`` (eigenvalues
    geometric from 1e-3 to 1), ``repeated`` (0.2, 0.5 and 1.0, each n/3
    times) or ``identity``."""
    import torch

    if kind == "identity":
        return torch.eye(n, dtype=dtype, device=device)
    g = torch.Generator().manual_seed(seed * 1000 + n)
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    if kind == "spread":
        w = torch.logspace(-3, 0, n, dtype=torch.float64)
    else:
        w = torch.tensor([0.2, 0.5, 1.0], dtype=torch.float64).repeat_interleave(-(-n // 3))[:n]
    return ((q * w) @ q.T).to(dtype).to(device)


def eigh_case(C, what, plain=True, timing=False) -> dict:
    """The Jacobi kernel on the symmetric ``C`` against a float64 CPU eigh
    (eigenvalues, residual, orthogonality relative to |C|_2) and, with
    ``plain``, against ``eigh_jacobi_plain`` on the card (eigenvalues,
    absolute and relative; its seconds); raises beyond ``EIGH_TOL``.  The
    identity must take no sweep and come back exact.  With ``timing``, the
    kernel's ms, torch.linalg.eigh's on the same matrix, and the bound."""
    import torch
    from evox_tpu_torch.ops import linalg

    n, dt = C.shape[-1], str(C.dtype).removeprefix("torch.")
    w, V, sweeps, off = linalg.eigh_jacobi(C[None])
    torch.cuda.synchronize()
    C64 = C.double().cpu()
    norm = float(torch.linalg.matrix_norm(C64, 2))
    w64 = torch.linalg.eigvalsh(C64)
    Vd, wd = V[0].double().cpu(), w[0].double().cpu()
    row = {"n": n, "dtype": dt, "sweeps": int(sweeps[0]), "off_rel_fro": float(off[0]) / float(torch.linalg.norm(C64)),
           "eigval_err": float((wd - w64).abs().max()) / norm,
           "residual": float(torch.linalg.matrix_norm((Vd * wd) @ Vd.T - C64, 2)) / norm,
           "orthogonality": float((Vd.T @ Vd - torch.eye(n, dtype=torch.float64)).abs().max())}
    if plain:
        t0 = time.perf_counter()
        wp, Vp, sp, op = linalg.eigh_jacobi_plain(C[None])
        torch.cuda.synchronize()
        row.update({"plain_s": time.perf_counter() - t0, "plain_sweeps": int(sp[0]),
                    "vs_plain_abs": float((w[0] - wp[0]).abs().max()),
                    "bits_equal_plain": bool(torch.equal(w, wp) and torch.equal(V, Vp) and torch.equal(off, op))})
        row["vs_plain"] = row["vs_plain_abs"] / norm
        if row["plain_sweeps"] != row["sweeps"]:
            raise AssertionError(f"{what}: the kernel took {row['sweeps']} sweeps, its plain version {row['plain_sweeps']}")
    tol = EIGH_TOL[dt][n >= 1000]
    row["tol"] = tol
    errs = [row[k] for k in ("eigval_err", "residual", "orthogonality", "vs_plain") if k in row]
    if not all(e <= tol for e in errs):
        raise AssertionError(f"{what}: the Jacobi kernel at n={n} {dt} beyond {tol}: {row}")
    if bool((C == torch.eye(n, dtype=C.dtype, device=C.device)).all()):
        if row["sweeps"] != 0 or not (torch.equal(V[0], C) and bool((w[0] == 1).all())):
            raise AssertionError(f"{what}: the identity took {row['sweeps']} sweeps or came back inexact")
    if timing:
        iters = 3 if n >= 1000 else 10
        row["ms"] = time_ms(lambda: linalg.eigh_jacobi(C[None]), iters, warmup=1)
        row["torch_linalg_eigh_ms"] = time_ms(lambda: torch.linalg.eigh(C), iters, warmup=1)
        row.update(eigh_bound(n, row["sweeps"], dt))
    return row


def jacobi_counters():
    from evox_tpu_torch.ops import linalg
    from evox_tpu_torch.ops.philox import philox_draws

    return {"eigh": linalg.eigh, "eigh_batched": linalg.eigh_batched, "eigh_jacobi": linalg.eigh_jacobi,
            "philox_draws": philox_draws}


# The Jacobi eigensolver's one kernel (one cooperative launch a call).
SOLVER_KERNELS = ("eigh_jacobi_kernel",)


def phase_cmaes_cadence(device) -> dict:
    """CMAES(zeros(1000), 1.0) (pop 24, decomp_per_iter 8) on Sphere: 16
    eager steps against run(16) (captured, then replayed) and
    run_segment(16) bit for bit, with no host sync in a segment
    (``fused_vs_eager``).  The decomposition goes through the Jacobi
    kernel, which reads ``iteration % 8 == 0`` on the card and does no
    sweep on the other generations: the device operations, host syncs and
    device time of a due and of a not-due eager generation, and of a
    not-due eigh alone (its one solver launch returns on the predicate):
    each makes exactly one launch of the solver's kernel.
    Then the path's (1000, 1000) C through the kernel in float32 (against
    the plain version and a float64 CPU eigh) and in float64 (against the
    CPU eigh), each with its ms, sweeps, bound and torch.linalg.eigh's ms,
    and the float32 call's device time by kernel."""
    import torch
    from evox_tpu_torch.algorithms import CMAES
    from evox_tpu_torch.ops import linalg
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    counters = jacobi_counters()
    for c in counters.values():
        c.launches = 0
    algo = CMAES(torch.zeros(CADENCE_DIM), 1.0, device=device)
    if algo.decomp_per_iter != 8 or algo.pop_size != 24:
        raise AssertionError(f"CMAES(zeros(1000)): pop {algo.pop_size}, decomp_per_iter {algo.decomp_per_iter}")
    wf = StdWorkflow(algo, Sphere())
    state = wf.init_step(wf.init(0))
    for _ in range(2):
        state = wf.step(state)  # iteration 3: its next step is not due
    s_due = state
    for _ in range(4):
        s_due = wf.step(s_due)  # iteration 7: its next step is due
    setup = {k: c.launches for k, c in counters.items()}
    fused, ref = fused_vs_eager(wf, state, CADENCE_GENS, counters, "cmaes_cadence", profile_gens=8)
    eager_launches = fused.pop("launches_in_eager_steps")
    expect(eager_launches, {"eigh": CADENCE_GENS, "eigh_batched": 0, "eigh_jacobi": CADENCE_GENS,
                            "philox_draws": CADENCE_GENS}, "cmaes_cadence: launches in the eager steps")
    per_gen = {}
    for name, s in (("due", s_due), ("not_due", state)):
        due = int(s.algorithm.iteration) + 1
        if (due % algo.decomp_per_iter == 0) != (name == "due"):
            raise AssertionError(f"cmaes_cadence: the {name} generation is iteration {due}")
        per_gen[name] = launches_per_call(lambda s=s: wf.step(s), calls=1, count_names=SOLVER_KERNELS)
        if per_gen[name]["host_syncs"] != 0:
            raise AssertionError(f"cmaes_cadence: an eager {name} generation made host syncs: {per_gen[name]}")
        if per_gen[name]["named"] != {k: 1 for k in SOLVER_KERNELS}:
            raise AssertionError(f"cmaes_cadence: a {name} generation launched the solver {per_gen[name]['named']}")
    launches = {k: c.launches for k, c in counters.items()}
    # The probes and comparisons below launch the kernel outside the path:
    # not counted.
    C = ((ref.algorithm.C + ref.algorithm.C.T) / 2).contiguous()
    no = torch.zeros((), dtype=torch.bool, device=device)
    not_due_eigh = launches_per_call(lambda: linalg.eigh(C, due=no), calls=1, count_names=SOLVER_KERNELS)
    if not_due_eigh["named"] != {k: 1 for k in SOLVER_KERNELS}:
        raise AssertionError(f"cmaes_cadence: a not-due eigh launched the solver {not_due_eigh['named']}")
    if not (bool(torch.isfinite(ref.algorithm.A).all()) and bool(torch.isfinite(ref.algorithm.sigma))):
        raise AssertionError("CMAES d=1000: a value that is not finite")
    f32 = eigh_case(C, "cmaes_cadence C float32", plain=True, timing=True)
    f32["profile"] = launches_per_call(lambda: linalg.eigh_jacobi(C[None]), calls=1, count_names=SOLVER_KERNELS)
    f64 = eigh_case(C.double(), "cmaes_cadence C float64", plain=False, timing=True)
    return {
        "config": f"CMAES(zeros({CADENCE_DIM}), 1.0) pop {algo.pop_size} decomp_per_iter {algo.decomp_per_iter}, "
                  f"Sphere, f32", "fused": fused, "setup_launches": setup, "launches": launches,
        "eager_ms_per_gen": fused["eager_ms_per_gen"], "captured_ms_per_gen": fused["run_ms_per_gen"],
        "per_gen": per_gen, "not_due_eigh": not_due_eigh,
        "decompositions_per_gen": 1 / algo.decomp_per_iter, "eigh_1000": {"float32": f32, "float64": f64},
        "best_final": float(ref.algorithm.fit.min()),
    }


def phase_cmaes_large_main_path(device) -> dict:
    """CMA-ES and ASEBO above d = 32, fused on the card: bench.py's smoke
    lane CMAES(zeros(64), 1.0, pop_size=32) and ASEBO(32, zeros(100)) on
    Sphere, each run(20) against 20 eager steps bit for bit
    (``fused_vs_eager``); 4 vmapped CMAES(64) through eigh_batched, one
    launch of the Jacobi kernel a generation (``family_case``);
    a ResilientRunner(checkpoint_every=10) run of CMAES(zeros(100), 1.0)
    for 20 generations on the card against run(20).  Then the kernel
    against its plain version and a float64 CPU eigh at n = 33, 64, 100
    in float32 and float64: spectra of condition 1e3, the identity (no
    sweep, exact) and three eigenvalues of multiplicity n/3, with the
    kernel's ms and torch.linalg.eigh's (``eigh_case``)."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.algorithms import ASEBO, CMAES
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.resilience import ResilientRunner
    from evox_tpu_torch.utils import graph
    from evox_tpu_torch.workflows import StdWorkflow

    counters = jacobi_counters()
    out = {}
    total = {k: 0 for k in counters}
    for name, make in (("CMAES_64", lambda: CMAES(torch.zeros(64), 1.0, pop_size=32, device=device)),
                       ("ASEBO_100", lambda: ASEBO(32, torch.zeros(100), device=device))):
        for c in counters.values():
            c.launches = 0
        wf = StdWorkflow(make(), Sphere())
        s0 = wf.step(wf.init_step(wf.init(0)))
        fused, ref = fused_vs_eager(wf, s0, SEGMENT_GENS, counters, name)
        eager = fused.pop("launches_in_eager_steps")
        expect(eager, {"eigh": SEGMENT_GENS, "eigh_batched": 0, "eigh_jacobi": SEGMENT_GENS,
                       "philox_draws": SEGMENT_GENS}, f"{name}: launches in the eager steps")
        leaves, _ = graph.flatten(ref.algorithm)
        if not all(bool(torch.isfinite(x).all()) for x in leaves if x.is_floating_point()):
            raise AssertionError(f"{name}: a state value that is not finite")
        out[name] = {"fused": fused, "launches": {k: c.launches for k, c in counters.items()},
                     "best_final": float(ref.algorithm.fit.min())}
        for k, c in counters.items():
            total[k] += c.launches
        del wf, s0, ref
    for c in counters.values():
        c.launches = 0
    out["vmapped_CMAES_64"] = family_case(
        "CMAES_64", lambda: StdWorkflow(CMAES(torch.zeros(64), 1.0, pop_size=32, device=device), Sphere()),
        counters, {"eigh": 0, "eigh_batched": 1, "eigh_jacobi": 1, "philox_draws": 0}, FAMILY_BATCHED_RTOL,
        device, gram=("A",))
    for k, c in counters.items():
        total[k] += c.launches
    out["vmapped_CMAES_64"]["launches"] = {k: c.launches for k, c in counters.items()}

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cmaes_runner_"))
    try:
        for c in counters.values():
            c.launches = 0
        wf = StdWorkflow(CMAES(torch.zeros(100), 1.0, device=device), Sphere())
        runner = ResilientRunner(wf, root, checkpoint_every=10)
        final = quiet_run(runner, wf.init(0), SEGMENT_GENS, fresh=True)
        torch.cuda.synchronize()
        no_cpu_fallback(runner, "CMAES(100) under the runner")
        runner_launches = {k: c.launches for k, c in counters.items()}
        ref = wf.run(wf.init(0), SEGMENT_GENS)
        same_state(final, ref, "CMAES(100): ResilientRunner vs run(20)")
        out["resilient_CMAES_100"] = {"stats": runner_stats(runner), "launches": runner_launches,
                                      "decomp_per_iter": wf.algorithm.decomp_per_iter}
        for k, v in runner_launches.items():
            total[k] += v
        del wf, runner, final, ref
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = total

    cases = []
    for n in EIGH_SIZES:
        for dt in (torch.float32, torch.float64):
            for kind in ("spread", "identity") + (("repeated",) if n == EIGH_SIZES[-1] else ()):
                C = spectrum_matrix(n, kind, dt, device)
                row = eigh_case(C, f"cmaes_large kernel case {kind}", timing=kind == "spread" and n > 33)
                cases.append({"kind": kind, **row})
    out["kernel_cases"] = cases
    out["max_abs_err"] = max(r["vs_plain_abs"] for r in cases)
    torch.cuda.empty_cache()
    return out


# The slice-2 kernels in the kernels line: wrapper, source, the TPU
# kernel (or XLA route) it replaces, and its timing_mo entry.
# ---------------------------------------------------------------------------
# Slice 9: the other PSO variants at the PSO headline's width; vmapped
# workflow instances (bench.py's vmapped_instances) and the other batching
# rules.
# ---------------------------------------------------------------------------

VARIANTS = ["CSO", "CLPSO", "SLPSOGS", "SLPSOUS", "FSPSO", "DMSPSOEL"]
# DMS-PSO-EL at the headline's 100,000 particles: 9000 dynamic swarms of 10
# and a following swarm of 10,000.  Regrouping every 5 iterations and a
# max_iteration of 20 put the regroups (iterations 5, 10, 15) and the
# switch to strategy 2 (int(0.9 * 20) = 18) inside the 20 timed
# generations, which start at iteration 2.
DMS_SHAPE = dict(dynamic_sub_swarm_size=10, dynamic_sub_swarms_num=9000, following_sub_swarm_size=10_000)
DMS_REGROUP, DMS_MAX_ITERATION = 5, 20
# Philox launches: two at setup (positions, velocities), two a generation
# (CSO: the pairing and the three uniforms; CLPSO: the coefficients and the
# tournament; SL-PSO: the demonstrator draw and three uniforms; FS-PSO: four
# uniforms and the tournament; DMS-PSO-EL: the regroup's permutation and
# two uniforms, every generation, whichever branch it keeps).
VARIANT_SETUP_PHILOX, VARIANT_PHILOX = 2, 2
# The (N, D) float32 arrays a generation must read and write at least once:
# the positions and velocities, and the personal/local bests where the
# variant keeps them (CLPSO, FS-PSO, DMS-PSO-EL).
VARIANT_ARRAYS = {"CSO": 4, "CLPSO": 6, "SLPSOGS": 4, "SLPSOUS": 4, "FSPSO": 6, "DMSPSOEL": 6}
# FS-PSO mutates each gene of a refilled particle with this probability:
# one gene a particle at D = 1000.  Its default, 0.01, mutates ten, and the
# best fitness the swarm has seen then never falls (on the card, 22
# generations: 29437.6 throughout while the population's best rose to
# 32705.8; on the CPU at pop 10000 the same from generation 5 to 60).
FSPSO_MUTATE_RATE = 1 / HEADLINE[1]
VMAP_INSTANCES = 8
VMAP_PSO = (1024, 100)  # bench.py's vmapped_instances: 8 x PSO(1024, ±32 in dim 100) on Ackley
VMAP_MONITOR_GENS = 10
FAMILY_INSTANCES = 4
FAMILY_CHECK_GENS = 3
FAMILY_NSGA2_POP, FAMILY_DE_POP = 1000, 1000
# Each vmapped CMA-ES step against the solo steps from the same states,
# relative to each leaf's largest magnitude: the batched covariance
# products (bmm against gemm) round in another order, and cuSOLVER's Jacobi
# sweeps over a batch of 4 stop at other points than over one matrix.  The
# eigen factor A is compared as A A^T: inside a near-degenerate eigenspace
# (cmaes_cec's C starts at the identity) the eigenvectors are not
# determined, and a solo run may pick others and then draw other samples,
# so runs of several generations are not compared.  The limit lies between
# what sound batching gives over FAMILY_CMAES_SEEDS and what a planted
# fault gives (``rolled_eigh``: each instance handed its neighbour's
# decomposition); both are in the phase's row.
FAMILY_BATCHED_RTOL = 1e-4
FAMILY_CMAES_SEEDS = (1, 2, 3, 4, 5)


def best_seen(algo) -> float:
    """The best fitness a PSO variant's state holds: the current fitness
    and the personal, local and global bests it keeps (a variant whose
    moved particles may land worse, FS-PSO's elites, keeps the best in its
    global best)."""
    import torch

    leaves = [algo[k] for k in ("fit", "personal_best_fit", "local_best_fit", "global_best_fit") if k in algo]
    return float(torch.cat([t.reshape(-1) for t in leaves]).min())


def variant_workflow(name, device):
    """``StdWorkflow(name(100000, ±10 in dim 1000), Sphere())``, float32,
    no monitor (DMS-PSO-EL as DMS_SHAPE)."""
    import torch
    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    n, d = HEADLINE
    lb, ub = torch.full((d,), -10.0), torch.full((d,), 10.0)
    if name == "DMSPSOEL":
        algo = algorithms.DMSPSOEL(lb, ub, **DMS_SHAPE, regrouped_iteration_num=DMS_REGROUP,
                                   max_iteration=DMS_MAX_ITERATION, device=device)
    else:
        kw = {"mutate_rate": FSPSO_MUTATE_RATE} if name == "FSPSO" else {}
        algo = getattr(algorithms, name)(n, lb, ub, device=device, **kw)
    return StdWorkflow(algo, Sphere())


def dms_branches(wf, state) -> dict:
    """DMS-PSO-EL's parts at full width, each timed alone on ``state``: the
    regroup's gather (run every generation, by the identity when it does
    not fire), strategy 1's and strategy 2's velocities (both computed
    every generation; one is kept)."""
    import torch
    from evox_tpu_torch.utils import rng

    algo, st = wf.algorithm, state.algorithm
    n, d = HEADLINE
    (u0, u1) = (torch.rand((n, d), device=st.pop.device) for _ in range(2))
    perm = rng.permutation(rng.child(rng.key(3, st.pop.device)), algo._dyn, st.pop.device)
    fire = torch.ones((), dtype=torch.bool, device=st.pop.device)
    pb, pbf = st.personal_best_location, st.personal_best_fit
    out = {
        "regroup_gather_ms": time_ms(lambda: algo._regroup(st, perm, fire), 5),
        "strategy1_velocity_ms": time_ms(lambda: algo._velocity_1(st, pb, u0, u1), 5),
        "strategy2_velocity_ms": time_ms(lambda: algo._velocity_2(st, pb, pbf, u0, u1), 5),
        "select_ms": time_ms(lambda: torch.where(fire, u0, u1), 5),
    }
    # What computing both strategies costs a generation over computing the
    # one it keeps: the other's velocity and the select between them.
    out["two_branch_cost_ms"] = (min(out["strategy1_velocity_ms"], out["strategy2_velocity_ms"])
                                 + out["select_ms"])
    return out


def variant_path(name, device) -> dict:
    """One PSO variant at the headline's width: setup and init_step (two
    Philox launches), one warm-up generation, the device operations and
    host syncs of an eager generation, then 20 eager steps against run(20)
    and run_segment(20) bit for bit (``fused_vs_eager``: no host sync in a
    segment), two Philox launches a generation, the best fitness falling;
    ms/gen beside the bytes bound of VARIANT_ARRAYS."""
    import torch
    from evox_tpu_torch.ops.philox import philox_draws

    counters = {"philox_draws": philox_draws}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    philox_draws.launches = 0
    wf = variant_workflow(name, device)
    t0 = time.perf_counter()
    state = wf.init_step(wf.init(0))
    best0 = best_seen(state.algorithm)
    setup_s = time.perf_counter() - t0
    setup_launches = philox_draws.launches
    if setup_launches != VARIANT_SETUP_PHILOX:
        raise AssertionError(f"{name}: {setup_launches} Philox launches at setup")
    s0 = wf.step(state)
    del state
    per_gen = launches_per_call(lambda: wf.step(s0), calls=2)
    fused, ref = fused_vs_eager(wf, s0, SEGMENT_GENS, counters, name)
    eager_launches = fused.pop("launches_in_eager_steps")["philox_draws"]
    if eager_launches != VARIANT_PHILOX * SEGMENT_GENS:
        raise AssertionError(f"{name}: {eager_launches} Philox launches in {SEGMENT_GENS} eager steps")
    algo = ref.algorithm
    best1 = best_seen(algo)
    if not best1 < best0:
        raise AssertionError(f"{name}: the best fitness did not fall: {best0} -> {best1}")
    if not bool(torch.isfinite(algo.pop).all()) or float(algo.pop.abs().max()) > 10.0:
        raise AssertionError(f"{name}: the population left the box or is not finite")
    n, d = HEADLINE
    b = bound(VARIANT_ARRAYS[name] * n * d * 4, 0.0)
    row = {
        "config": f"{name} pop={wf.algorithm.pop_size} dim={d} Sphere f32, StdWorkflow, no monitor",
        "setup_s": setup_s, "philox_per_gen": VARIANT_PHILOX,
        "launches": {"philox_draws": setup_launches + eager_launches},
        "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
        "eager_device_ms_per_gen": per_gen["device_ms"],
        "eager_idle_share": 1 - per_gen["device_ms"] / fused["eager_ms_per_gen"],
        "fused": fused, "best_after_init": best0, "best_final": best1,
        "min_fit_final": float(algo.fit.min()),
        "state_arrays_bound_ms": b["bound_ms"], "bound_share_of_run": b["bound_ms"] / fused["run_ms_per_gen"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if name == "DMSPSOEL":
        # Iterations 2 .. 21 ran: regroups at 5, 10, 15, strategy 2 from 18.
        if int(s0.algorithm.iteration) != 2 or int(algo.iteration) != 2 + SEGMENT_GENS:
            raise AssertionError(f"DMSPSOEL: iterations {int(s0.algorithm.iteration)} .. {int(algo.iteration)}")
        row["iterations"] = [2, 1 + SEGMENT_GENS]
        row["branches"] = dms_branches(wf, ref)
    del wf, s0, ref, algo
    torch.cuda.empty_cache()
    return row


def phase_pso_variants(device) -> dict:
    """CSO, CLPSO, SLPSOGS, SLPSOUS, FSPSO and DMSPSOEL at the PSO
    headline's width (``variant_path``), each freed before the next."""
    out = {name: variant_path(name, device) for name in VARIANTS}
    out["launches"] = {"philox_draws": sum(out[n]["launches"]["philox_draws"] for n in VARIANTS)}
    return out


def vmapped_pso_workflow(device, monitor=None):
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import StdWorkflow

    n, d = VMAP_PSO
    return StdWorkflow(PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device), Ackley(),
                       monitor=monitor)


def instance(state, b):
    """Instance ``b`` of a vmapped state."""
    from evox_tpu_torch.utils import graph

    leaves, spec = graph.flatten(state)
    return graph.unflatten(spec, [x[b] for x in leaves])


def vmapped_graph(step, states, gens):
    """``gens`` vmapped generations as one replay of a captured CUDA graph
    (the port's capture machinery, ``utils/graph.py``), the
    counterpart of ``jax.jit(jax.vmap(wf.step))`` in a loop; returns the
    runner (each call a replay, after the first call's capture)."""
    from evox_tpu_torch.utils import graph

    cache = graph.Cache()

    def program(carry, n):
        s = carry[0]
        for _ in range(n):
            s = step(s)
        return (s,), {}, None

    return lambda: graph.run(cache, "vmapped_step", program, (states,), gens)[0][0]


def batched_kernels_vs_plain(states, device) -> dict:
    """The batched PSO move and Philox draw on the card against their plain
    versions at the path's shape (8 x (1024, 100) and 8 streams of the
    setup's 102,400 draws), exact, and timed with their bounds.  Launches
    made here are not the path's."""
    import torch
    from evox_tpu_torch.ops import philox, pso_step
    from evox_tpu_torch.utils import rng

    a = states.algorithm
    b, (n, d) = VMAP_INSTANCES, VMAP_PSO
    scal = torch.stack([a.w, a.phi_p, a.phi_g], 1).float()
    lb, ub = torch.full((d,), -32.0, device=device), torch.full((d,), 32.0, device=device)
    args = (a.pop, a.velocity, a.local_best_location, a.fit, a.local_best_fit, a.global_best_location,
            lb, ub, scal, a.key)
    got = pso_step.fused_pso_move_batched(*args, index=0)
    want = pso_step.fused_pso_move_batched_plain(*args, 0)
    move_err = max(exact(g, w, "fused_pso_move_batched vs plain") for g, w in zip(got, want))
    kept = kept_rows(a.fit, a.local_best_fit)
    keys = a.key
    kinds = [torch.float32]
    got = philox.philox_draws_batched(keys, 0, n * d, kinds)
    want = philox.philox_draws_batched_plain(keys, 0, n * d, kinds)
    draw_err = max(exact(g, w, "philox_draws_batched vs plain") for g, w in zip(got, want))
    del got, want
    # hpo_ladder's shape: 64 streams of 16,384 (OpenES's normals).
    hb, hn = HPO_LADDER["candidates"], HPO_LADDER["inner_pop"] // 2 * HPO_LADDER["dim"]
    hkeys = torch.stack([rng.key(s_, device) for s_ in range(hb)])
    hpo_err = max(exact(g, w, "philox_draws_batched (64, 16384) vs plain")
                  for g, w in zip(philox.philox_draws_batched(hkeys, 0, hn, kinds),
                                  philox.philox_draws_batched_plain(hkeys, 0, hn, kinds)))
    # Launch-bound at this size: the event time of back-to-back calls is
    # the wrappers' host time; the profiler gives the kernel's own.
    return {
        "fused_pso_move_batched": {
            "max_abs_err": move_err, "shape": [b, n, d],
            "ms": time_ms(lambda: pso_step.fused_pso_move_batched(*args), 50),
            "device_ms": launches_per_call(lambda: pso_step.fused_pso_move_batched(*args), calls=20)["device_ms"],
            "plain_ms": time_ms(lambda: pso_step.fused_pso_move_batched_plain(*args), 5),
            # Eight solo launches of the same work, the route it replaces.
            "solo_launches_ms": time_ms(lambda: [pso_step.fused_pso_move(
                *(x[i] for x in args[:6]), lb, ub, *scal[i], seed=rng.Seed(args[9][i], 0))
                for i in range(b)], 20),
            **{k: move_bound(b, n, d, 4, kept, "hw")[k] for k in ("bound_ms", "bound_by")}, "library_ms": None,
        },
        "philox_draws_batched": {
            "max_abs_err": max(draw_err, hpo_err), "streams": b, "numel": n * d,
            "ms": time_ms(lambda: philox.philox_draws_batched(keys, 0, n * d, kinds), 50),
            "device_ms": launches_per_call(lambda: philox.philox_draws_batched(keys, 0, n * d, kinds),
                                           calls=20)["device_ms"],
            "plain_ms": time_ms(lambda: philox.philox_draws_batched_plain(keys, 0, n * d, kinds), 5),
            **{k: philox_bound(b * n * d, kinds)[k] for k in ("bound_ms", "bound_by")}, "library_ms": None,
            "hpo_ladder_shape": {
                "max_abs_err": hpo_err, "streams": hb, "numel": hn,
                "device_ms": launches_per_call(lambda: philox.philox_draws_batched(hkeys, 0, hn, kinds),
                                               calls=20)["device_ms"],
                **{k: philox_bound(hb * hn, kinds)[k] for k in ("bound_ms", "bound_by")}},
        },
    }


def vmap_counters():
    from evox_tpu_torch.ops import philox, pso_step

    return {"fused_pso_move": pso_step.fused_pso_move, "fused_pso_move_batched": pso_step.fused_pso_move_batched,
            "philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}


def phase_vmapped_instances(device) -> dict:
    """bench.py's vmapped_instances at full width: 8 x PSO(1024, ±32 in dim
    100) on Ackley, ``torch.func.vmap`` over ``init`` (with instance ids),
    ``init_step`` and ``step``.  The batched routes: 2 Philox launches at
    setup for all 8 instances (not 16) and 1 PSO move launch a generation
    (not 8).  Every instance equal to its solo run from the same key, bit
    for bit, after the eager vmapped steps; the vmapped step captured in a
    CUDA graph (the port's ``utils/graph.py`` machinery) and replayed equal to the
    eager vmapped steps; eager and replayed ms/gen, device operations and
    host syncs a generation.  Then an ``EvalMonitor(ordered=False,
    num_instances=8)`` run: its history grouped by instance and equal to
    the solo runs'.  Last, the batched kernels against their plain
    versions."""
    import torch
    from torch.func import vmap
    from evox_tpu_torch.utils import rng
    from evox_tpu_torch.workflows import EvalMonitor

    b = VMAP_INSTANCES
    counters = vmap_counters()
    wf = vmapped_pso_workflow(device)
    keys = torch.stack(rng.split_keys(rng.key(0, device), b))
    ids = torch.arange(b, device=device)
    for c in counters.values():
        c.launches = 0
    states = vmap(wf.init)(keys, ids)
    setup = {k: c.launches for k, c in counters.items()}
    if setup != {"fused_pso_move": 0, "fused_pso_move_batched": 0, "philox_draws": 0, "philox_draws_batched": 2}:
        raise AssertionError(f"vmapped setup launches {setup}")
    states = vmap(wf.init_step)(states)
    step = vmap(wf.step)
    for _ in range(MAIN_WARMUP):
        states = step(states)
    s0 = states
    for c in counters.values():
        c.launches = 0

    def eager(s=s0):
        for _ in range(SEGMENT_GENS):
            s = step(s)
        return s

    eager_ms, eager_host_ms, ref = timed(eager, SEGMENT_GENS)
    launches = {k: c.launches for k, c in counters.items()}
    want = {"fused_pso_move": 0, "fused_pso_move_batched": SEGMENT_GENS, "philox_draws": 0,
            "philox_draws_batched": 0}
    if launches != want:
        raise AssertionError(f"vmapped steps launched {launches}, expected {want}")
    per_gen = launches_per_call(lambda: step(s0), calls=3)
    # Each instance against its solo run (the same key and id, the same
    # generations), every leaf bit for bit.
    leaves = 0
    for i in range(b):
        solo = wf.init_step(wf.init(keys[i], i))
        for _ in range(MAIN_WARMUP + SEGMENT_GENS):
            solo = wf.step(solo)
        leaves += same_state(instance(ref, i), solo, f"vmapped_instances: instance {i} vs its solo run")
    del solo
    # The vmapped step in a CUDA graph: the capture (one warm-up generation
    # on a clone, then 20), then replays.
    for c in counters.values():
        c.launches = 0
    replay = vmapped_graph(step, s0, SEGMENT_GENS)
    t0 = time.perf_counter()
    got = replay()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    capture_launches = {k: c.launches for k, c in counters.items()}
    same_state(got, ref, "vmapped_instances: graph capture vs eager vmapped steps")
    graph_ms, graph_host_ms, got = timed(replay, SEGMENT_GENS)
    same_state(got, ref, "vmapped_instances: graph replay vs eager vmapped steps")
    per_replay = launches_per_call(replay, calls=1)
    if per_replay["host_syncs"] != 0:
        raise AssertionError(f"vmapped_instances: a replay made host syncs: {per_replay}")
    del got

    # The unordered monitor under vmap.
    mon = EvalMonitor(ordered=False, num_instances=b, full_fit_history=True)
    wfm = vmapped_pso_workflow(device, mon)
    sm = vmap(wfm.init_step)(vmap(wfm.init)(keys, ids))
    stepm = vmap(wfm.step)
    for _ in range(VMAP_MONITOR_GENS):
        sm = stepm(sm)
    hist = mon.fitness_history
    if len(hist) != VMAP_MONITOR_GENS + 1 or tuple(hist[0].shape) != (b, VMAP_PSO[0]):
        raise AssertionError(f"vmapped monitor history: {len(hist)} entries of {tuple(hist[0].shape)}")
    entries = 0
    for i in range(b):
        smon = EvalMonitor(full_fit_history=True)
        swf = vmapped_pso_workflow(device, smon)
        s = swf.init_step(swf.init(keys[i], i))
        for _ in range(VMAP_MONITOR_GENS):
            s = swf.step(s)
        for g, h in enumerate(smon.fitness_history):
            exact(hist[g][i], h, f"vmapped monitor history: instance {i} generation {g}")
            entries += 1
        exact(sm.monitor.topk_fitness[i].cpu(), s.monitor.topk_fitness.cpu(), f"vmapped top-k, instance {i}")
    del sm, s, wfm, swf
    kernels = batched_kernels_vs_plain(s0, device)
    n, d = VMAP_PSO
    row = {
        "config": f"{b} x PSO pop={n} dim={d} Ackley f32, torch.func.vmap over StdWorkflow init/init_step/step",
        "setup_launches": setup, "launches": {k: setup[k] + launches[k] for k in counters},
        "eager_ms_per_gen": eager_ms, "eager_host_ms_per_gen": eager_host_ms,
        "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
        "eager_device_ms_per_gen": per_gen["device_ms"], "eager_idle_share": 1 - per_gen["device_ms"] / eager_ms,
        "graph_ms_per_gen": graph_ms, "graph_host_ms_per_gen": graph_host_ms, "capture_s": capture_s,
        "capture_launches": capture_launches,
        "graph_device_ops_per_gen": per_replay["launches"] / SEGMENT_GENS,
        "graph_host_syncs_per_gen": per_replay["host_syncs"] / SEGMENT_GENS,
        "graph_device_ms_per_gen": per_replay["device_ms"] / SEGMENT_GENS,
        "graph_idle_share": 1 - per_replay["device_ms"] / SEGMENT_GENS / graph_ms,
        "instances_equal_solo": b, "leaves_checked": leaves, "monitor_entries_checked": entries,
        "kernels": kernels,
        "max_abs_err": {k: v["max_abs_err"] for k, v in kernels.items()},
    }
    del wf, states, s0, ref
    torch.cuda.empty_cache()
    return row


def leaf_errors(what, got, want, rtol, gram=()) -> dict:
    """One instance's state ``got`` against ``want`` (``what`` names it): bit for bit when
    ``rtol`` is 0 (raises at the first difference), else each floating
    leaf's largest difference over ``want``'s largest finite magnitude (at
    least 1; inf where NaN places differ, and integer leaves exact).  A
    leaf named in ``gram`` is compared as ``X X^T``, which does not depend
    on the basis an eigensolver picks inside a (near-)degenerate
    eigenspace.  Returns the errors by leaf."""
    import torch
    from evox_tpu_torch.utils import graph

    if rtol == 0:
        same_state(got, want, f"{what} vs its solo run")
        return {}
    if graph.structure(got) != graph.structure(want):
        raise AssertionError(f"{what}: structure")
    errs = {}
    for k in want.algorithm:
        x, y = got.algorithm[k], want.algorithm[k]
        if not x.is_floating_point():
            errs[k] = 0.0 if torch.equal(x, y) else float("inf")
            continue
        x64, y64 = x.double(), y.double()
        if k in gram:
            x64, y64 = x64 @ x64.mT, y64 @ y64.mT
        if not torch.equal(torch.isnan(x64), torch.isnan(y64)):
            errs[k] = float("inf")
            continue
        finite = y64[torch.isfinite(y64)]
        scale = max(1.0, float(finite.abs().max())) if finite.numel() else 1.0
        errs[k] = float(((x64 - y64).abs().nan_to_num(0.0)).max()) / scale if x.numel() else 0.0
    return errs


def family_case(name, make, counters, per_gen, rtol, device, seeds=(1,), control=None, gram=()) -> dict:
    """FAMILY_INSTANCES instances of one workflow under ``torch.func.vmap``,
    for each of ``seeds``, FAMILY_CHECK_GENS vmapped generations after
    ``init_step``.  With ``rtol`` 0 each instance equals its solo run from
    its key bit for bit.  Otherwise every vmapped ``init_step`` and step is
    held against each instance's solo step from the same input state,
    within ``rtol`` of each leaf's scale (``leaf_errors``; ``gram`` leaves
    as ``X X^T``): a solo run of many generations may part from the
    vmapped one by a legitimate choice of eigenvectors.  With ``control``
    (a context manager that plants a batching fault) the first seed's
    vmapped generations run again under it, and the same comparison must
    find them beyond ``rtol``.  Then 20 eager vmapped steps of the first
    seed (timed; each kernel's launches a generation as ``per_gen``)
    against their CUDA-graph capture and replay, bit for bit."""
    import torch
    from torch.func import vmap
    from evox_tpu_torch.utils import rng

    b = FAMILY_INSTANCES
    wf = make()
    step = vmap(wf.step)

    def worse(worst, errs):
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)

    def vmapped_run(keys, stepwise):
        """The vmapped state after the check generations, and the worst
        error by leaf of its steps against solo steps (``stepwise``)."""
        worst: dict = {}
        s = vmap(wf.init)(keys)
        for gen in range(FAMILY_CHECK_GENS + 1):
            nxt = vmap(wf.init_step)(s) if gen == 0 else step(s)
            if stepwise:
                for i in range(b):
                    one = instance(s, i)
                    want = wf.init_step(one) if gen == 0 else wf.step(one)
                    what = f"vmapped_family {name}: instance {i}, generation {gen}"
                    worse(worst, leaf_errors(what, instance(nxt, i), want, rtol, gram))
            s = nxt
        return s, worst

    by_seed, s = {}, None
    for seed in seeds:
        keys = torch.stack(rng.split_keys(rng.key(seed, device), b))
        got, by_seed[seed] = vmapped_run(keys, stepwise=rtol > 0)
        if rtol == 0:
            for i in range(b):
                solo = wf.init_step(wf.init(keys[i]))
                for _ in range(FAMILY_CHECK_GENS):
                    solo = wf.step(solo)
                leaf_errors(f"vmapped_family {name}: instance {i}", instance(got, i), solo, 0)
        if s is None:
            s, first_keys = got, keys
        del got
    worst: dict = {}
    for errs in by_seed.values():
        worse(worst, errs)
    if any(v > rtol for v in worst.values()):
        raise AssertionError(f"vmapped_family {name}: instances off their solo steps by {by_seed}")
    planted = None
    if control is not None:
        with control():
            _, planted = vmapped_run(first_keys, stepwise=True)
        if max(planted.values()) <= rtol:
            raise AssertionError(f"vmapped_family {name}: the planted fault stays within {rtol}: {planted}")
    s0 = s
    for c in counters.values():
        c.launches = 0

    def eager(s=s0):
        for _ in range(SEGMENT_GENS):
            s = step(s)
        return s

    eager_ms, eager_host_ms, ref = timed(eager, SEGMENT_GENS)
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: v * SEGMENT_GENS for k, v in per_gen.items()}
    if launches != want:
        raise AssertionError(f"vmapped_family {name}: launches {launches}, expected {want}")
    ops = launches_per_call(lambda: step(s0), calls=2)
    replay = vmapped_graph(step, s0, SEGMENT_GENS)
    same_state(replay(), ref, f"vmapped_family {name}: graph capture vs eager vmapped steps")
    graph_ms, graph_host_ms, got = timed(replay, SEGMENT_GENS)
    same_state(got, ref, f"vmapped_family {name}: graph replay vs eager vmapped steps")
    per_replay = launches_per_call(replay, calls=1)
    if per_replay["host_syncs"] != 0:
        raise AssertionError(f"vmapped_family {name}: a replay made host syncs: {per_replay}")
    row = {
        "instances": b, "solo_check_gens": FAMILY_CHECK_GENS, "seeds": list(seeds),
        "instances_vs_solo": "runs bit for bit" if rtol == 0 else f"steps within {rtol} of each leaf's scale",
        "rel_err_vs_solo_by_leaf": worst, "launches": launches,
        "eager_ms_per_gen": eager_ms, "eager_host_ms_per_gen": eager_host_ms,
        "eager_device_ops_per_gen": ops["launches"], "eager_host_syncs_per_gen": ops["host_syncs"],
        "graph_ms_per_gen": graph_ms, "graph_device_ops_per_gen": per_replay["launches"] / SEGMENT_GENS,
        "graph_device_ms_per_gen": per_replay["device_ms"] / SEGMENT_GENS,
        "graph_idle_share": 1 - per_replay["device_ms"] / SEGMENT_GENS / graph_ms,
    }
    if rtol:
        row["rel_err_vs_solo_by_seed"] = by_seed
    if planted is not None:
        row["planted_fault_rel_err_by_leaf"] = planted
    del wf, s, s0, ref, got
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def rolled_eigh():
    """A planted batching fault for ``family_case``'s control: the batched
    eigh hands instance b the eigenvalues and eigenvectors of instance
    b - 1 (mod B), as a rule that mixed up the instances would.  A solo
    call (a batch of one) is unchanged."""
    from evox_tpu_torch.ops import linalg

    real = linalg._op

    def rolled(C, due, solo):
        w, V = real(C, due, solo)
        return (w, V) if solo else (w.roll(1, 0), V.roll(1, 0))

    linalg._op = rolled
    try:
        yield
    finally:
        linalg._op = real


def phase_vmapped_family(device) -> dict:
    """The other batching rules on the card: 4 x NSGA-II at pop 1000 on
    DTLZ2 (the sequential rule of the dominance, peel, rank and crowding
    kernels: one launch an instance), 4 x cmaes_cec (the batched eigh: one
    cuSOLVER call for the 4 covariances) and 4 x DE at pop 1000, dim 20 on
    CEC2022 f5 (the batched Philox draws), each eager and captured
    (``family_case``)."""
    from evox_tpu_torch.ops import crowding, dominance, linalg, philox, topk

    b = FAMILY_INSTANCES
    seq = {"dominance_packed": dominance.dominance_packed, "peel_fronts": dominance.peel_fronts,
           "lex_rank": topk.lex_rank, "crowding_neighbors": crowding.crowding_neighbors}
    draws = {"philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}
    out = {
        "NSGA2": family_case(
            "NSGA2", lambda: mo_workflow("NSGA2", FAMILY_NSGA2_POP, device)[0], {**seq, **draws},
            {**{k: b for k in seq}, "philox_draws": 0, "philox_draws_batched": 3}, 0, device),
        "CMAES": family_case(
            "CMAES", lambda: es_workflow("CMAES", device),
            {"eigh": linalg.eigh, "eigh_batched": linalg.eigh_batched, **draws},
            {"eigh": 0, "eigh_batched": 1, "philox_draws": 0, "philox_draws_batched": 1},
            FAMILY_BATCHED_RTOL, device, seeds=FAMILY_CMAES_SEEDS, control=rolled_eigh, gram=("A",)),
        "DE": family_case("DE", lambda: family_de_workflow(device), draws,
                          {"philox_draws": 0, "philox_draws_batched": 2}, 0, device),
    }
    out["launches"] = {k: sum(out[n]["launches"].get(k, 0) for n in ("NSGA2", "CMAES", "DE"))
                       for k in ("dominance_packed", "peel_fronts", "lex_rank", "crowding_neighbors",
                                 "philox_draws_batched", "eigh_batched")}
    return out


def family_de_workflow(device):
    import torch
    from evox_tpu_torch.algorithms import DE
    from evox_tpu_torch.problems.numerical import CEC2022
    from evox_tpu_torch.workflows import StdWorkflow

    lb, ub = torch.full((DE_DIM,), -100.0), torch.full((DE_DIM,), 100.0)
    return StdWorkflow(DE(FAMILY_DE_POP, lb, ub, device=device), CEC2022(DE_FN, DE_DIM, device=device))


# -- neuroevolution -------------------------------------------------------------

# bench.py's neuroevolution (bench.py:1041-1058): OpenES(pop 2048, lr 0.02,
# sigma 0.05, adam) evolves MLPPolicy((4, 32, 32, 1)), 1,249 parameters, on
# cartpole() with max_episode_length=200, one episode, maximize_reward=False
# with opt_direction="max".
NE_POP, NE_STEPS, NE_LAYERS = 2048, 200, (4, 32, 32, 1)
# Philox launches a generation: OpenES's normals (solo) and the episodes'
# resets (one batched launch under the rollout's vmap).
NE_PHILOX = {"philox_draws": 1, "philox_draws_batched": 1}
# Card vs CPU from the same initial states and parameters: the states of
# every episode along the first NE_CHECK_STEPS steps within NE_STEP_RTOL of
# each leaf's largest magnitude (the CPU tests measured the port against
# JAX at 2.5e-7 over 50 cart-pole steps: sin, cos and the products differ
# in the last bits), and the 200-step returns equal on at least
# NE_EQUAL_SHARE of the individuals (an episode that passes within an ulp
# of |x| = 2.4 or |theta| = 12 degrees may end a step apart).
NE_CHECK_STEPS = 50
# A generation is ~10k device operations, which take torch.profiler
# seconds to collect: one eager step is profiled by kernel, and the
# profiled segment is one generation (a capture of its own).
NE_PROFILE_STEPS = 1
NE_PROFILE_GENS = 1
NE_STEP_RTOL = 1e-4
NE_EQUAL_SHARE = 0.99
# neuroevolution_family: the family's other problems, 1024 individuals,
# eager and as run(NE_FAMILY_GENS); the supervised problem's synthetic
# regression (no file): 16384 examples of 64 features, batches of 256,
# 4 a generation.
NE_FAMILY_POP = 1024
NE_FAMILY_GENS = 5
NE_SL_DATA = (16_384, 64)


def ne_openes(center, device, lr=0.02, sigma=0.05, pop=NE_POP):
    from evox_tpu_torch.algorithms import OpenES

    return OpenES(pop, center, lr, sigma, optimizer="adam", device=device)


def neuroevolution_workflow(device):
    """bench.py's neuroevolution config through the port at full width, with
    an EvalMonitor; returns the workflow and its ParamsAndVector."""
    from evox_tpu_torch.problems.neuroevolution import MLPPolicy, RolloutProblem, cartpole
    from evox_tpu_torch.utils import ParamsAndVector, rng
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    policy = MLPPolicy(NE_LAYERS)
    params0 = policy.init(rng.key(1))
    adapter = ParamsAndVector(params0)
    problem = RolloutProblem(policy, cartpole(), max_episode_length=NE_STEPS, maximize_reward=False)
    wf = StdWorkflow(ne_openes(adapter.to_vector(params0), device), problem, monitor=EvalMonitor(),
                     opt_direction="max", solution_transform=adapter.batched_to_params)
    return wf, adapter


def fixed_rollout(problem, resets, device):
    """A copy of the rollout ``problem`` whose episodes start from
    ``resets`` (moved to ``device``) instead of its keys' draws."""
    import torch.utils._pytree as pytree
    from evox_tpu_torch.problems.neuroevolution import RolloutProblem

    class Fixed(RolloutProblem):
        def _resets(self, episode_keys):
            return pytree.tree_map(lambda x: x.to(device), resets)

    return Fixed(problem.policy, problem.env, problem.max_episode_length, problem.num_episodes,
                 maximize_reward=problem.maximize_reward)


def rollout_card_vs_cpu(wf, adapter, pop_vec) -> dict:
    """The population ``pop_vec`` (vectors on the card) rolled out on the
    card (the captured loop) and on the CPU (eager) from the same initial
    states: every episode's state along the first NE_CHECK_STEPS steps
    within NE_STEP_RTOL, and the returns equal on NE_EQUAL_SHARE of
    them."""
    import torch
    import torch.utils._pytree as pytree
    from evox_tpu_torch.utils import rng

    prob = wf.problem
    device = pop_vec.device
    keys = torch.stack(rng.split_keys(rng.key(11, device), prob.num_episodes))
    resets = prob._resets(keys)
    card_fit, _ = fixed_rollout(prob, resets, device).evaluate(prob.setup(keys[0]), adapter.batched_to_params(pop_vec))
    cpu = torch.device("cpu")
    cpu_fit, _ = fixed_rollout(prob, resets, cpu).evaluate(
        prob.setup(keys[0].cpu()), adapter.batched_to_params(pop_vec.cpu()))
    card_fit = card_fit.cpu()
    equal = float((card_fit == cpu_fit).float().mean())
    # The first steps, episode by episode, eagerly on both devices.
    n = pop_vec.shape[0]

    def carry(dev):
        params = {k: v.contiguous() for k, v in adapter.batched_to_params(pop_vec.to(dev)).items()}
        s0, obs0 = pytree.tree_map(lambda x: x.to(dev).expand(n, *x.shape[1:]).contiguous(), resets)
        return params, s0, obs0, torch.zeros(n, device=dev), torch.zeros(n, dtype=torch.bool, device=dev)

    step = torch.func.vmap(prob._episode_step)
    (pc, sc, oc, tc, dc), (pp, sp, op, tp, dp) = carry(device), carry(cpu)
    worst = 0.0
    for _ in range(NE_CHECK_STEPS):
        sc, oc, tc, dc = step(pc, sc, oc, tc, dc)
        sp, op, tp, dp = step(pp, sp, op, tp, dp)
        for a, b in zip(pytree.tree_leaves((sc, oc, tc)), pytree.tree_leaves((sp, op, tp))):
            worst = max(worst, float((a.cpu() - b).abs().max() / b.abs().max().clamp(min=1e-30)))
    row = {"step_rel_err_first_50": worst, "step_rtol": NE_STEP_RTOL, "returns_equal_share": equal,
           "returns_equal_limit": NE_EQUAL_SHARE,
           "returns_max_abs_diff": float((card_fit - cpu_fit).abs().max()),
           "cpu_returns_min_max": [float(cpu_fit.abs().min()), float(cpu_fit.abs().max())],
           "done_equal_after_50": bool(torch.equal(dc.cpu(), dp))}
    if not (worst <= NE_STEP_RTOL and equal >= NE_EQUAL_SHARE and row["done_equal_after_50"]):
        raise AssertionError(f"neuroevolution: the rollout on the card against the CPU: {row}")
    return row


def ne_counters():
    from evox_tpu_torch.ops.philox import philox_draws, philox_draws_batched

    return {"philox_draws": philox_draws, "philox_draws_batched": philox_draws_batched}


def ne_check_launches(counters, per_gen, gens, what):
    for k, c in counters.items():
        want = per_gen[k] * gens
        if c.launches != want:
            raise AssertionError(f"{what}: {k} launched {c.launches} times in {gens} generations, expected {want}")


def uncaptured_rollout_ms(wf, state) -> float:
    """Host ms of one evaluation whose loop is NOT captured (the eager
    PyTorch launches, functorch's host cost included), at the problem's
    width: the cost the rollout's graph removes."""
    import torch
    from evox_tpu_torch.utils import graph

    pop = wf.solution_transform(state.monitor.latest_solution)
    real = graph.replays
    graph.replays = lambda device: False
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit, _ = wf.problem.evaluate(state.problem, pop)
        torch.cuda.synchronize()
    finally:
        graph.replays = real
    return (time.perf_counter() - t0) * 1e3


def phase_neuroevolution_main_path(device) -> dict:
    """bench.py's neuroevolution at full width (``neuroevolution_workflow``):
    init_step (its evaluation captures the rollout's graph), warm-up,
    timed and profiled eager steps (each replays the rollout's graph), the
    uncaptured rollout's host time, Philox launches a generation, the
    draws of one eager step (OpenES's normals and the episodes' batched
    resets) replayed through the plain version bit for bit
    (``recording_draws``), then 20 eager steps against run(20) and
    run_segment(20) bit for bit
    (``fused_vs_eager``: no host sync in a segment), the population's mean
    return rising and the best return not falling (at pop 2048 some
    individual reaches the 200-step ceiling in the first generation), and
    the first generation's rollout card against CPU
    (``rollout_card_vs_cpu``)."""
    import torch

    counters = ne_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wf, adapter = neuroevolution_workflow(device)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    state = wf.init(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = wf.init_step(state)
    torch.cuda.synchronize()
    first_gen_s = time.perf_counter() - t0
    mean0 = float(-state.algorithm.fit.mean())
    best0 = float(wf.monitor.get_best_fitness(state.monitor))
    # The first generation's population, whose returns spread over the
    # whole range (later ones reach the 200-step ceiling): the card vs CPU
    # comparison rolls it out again.
    first_pop = state.monitor.latest_solution
    for _ in range(MAIN_WARMUP):
        state = wf.step(state)

    def eager(s=state):
        for _ in range(MAIN_STEPS):
            s = wf.step(s)
        return s

    ms, host_ms, state = timed(eager, MAIN_STEPS)
    state, prof = profile_steps(wf.step, state, NE_PROFILE_STEPS)
    steps = 1 + MAIN_WARMUP + MAIN_STEPS + NE_PROFILE_STEPS
    ne_check_launches(counters, NE_PHILOX, steps, "neuroevolution")
    launches = {k: c.launches for k, c in counters.items()}
    # One captured rollout, replayed by every eager evaluation (none on the
    # CPU of a rehearsal).
    graphs = len(wf.problem._graphs)
    if graphs != (device.type == "cuda"):
        raise AssertionError(f"neuroevolution: {graphs} rollout graphs captured, expected 1")
    seen = []
    with recording_draws(seen):
        wf.step(state)
    on_path = draws_on_path("neuroevolution", seen)
    if on_path["launches"] != NE_PHILOX:
        raise AssertionError(f"neuroevolution: one eager step launched {on_path['launches']}, expected {NE_PHILOX}")
    del seen
    eager_prof = launches_per_call(lambda: wf.step(state), calls=1)
    uncaptured_ms = uncaptured_rollout_ms(wf, state)
    fused, ref = fused_vs_eager(wf, state, SEGMENT_GENS, counters, "neuroevolution", profile_gens=NE_PROFILE_GENS)
    eager_launches = fused.pop("launches_in_eager_steps")
    for k in counters:
        if eager_launches[k] != NE_PHILOX[k] * SEGMENT_GENS:
            raise AssertionError(f"neuroevolution: {eager_launches[k]} {k} launches in {SEGMENT_GENS} eager steps")
    mean1 = float(-ref.algorithm.fit.mean())
    best1 = float(wf.monitor.get_best_fitness(ref.monitor))
    if not (mean1 > mean0 and best1 >= best0):
        raise AssertionError(f"neuroevolution: mean return {mean0} -> {mean1}, best {best0} -> {best1}")
    if not bool(torch.isfinite(ref.algorithm.center).all()):
        raise AssertionError("neuroevolution: the center is not finite")
    card_vs_cpu = rollout_card_vs_cpu(wf, adapter, first_pop)
    env_steps = NE_POP * NE_STEPS * wf.problem.num_episodes
    row = {
        "config": f"OpenES pop={NE_POP} lr=0.02 sigma=0.05 adam, MLPPolicy{NE_LAYERS} "
                  f"({adapter.vector_size} parameters), cartpole T={NE_STEPS}, 1 episode, "
                  "maximize_reward=False + opt_direction=max, EvalMonitor",
        "setup_s": setup_s, "first_generation_s": first_gen_s,
        "ms_per_gen": ms, "host_ms_per_gen": host_ms, "gen_per_s": 1e3 / ms,
        "env_steps_per_s_eager": env_steps * 1e3 / ms,
        "env_steps_per_s_fused": env_steps * 1e3 / fused["run_ms_per_gen"],
        "eager_device_ops_per_gen": eager_prof["launches"], "eager_host_syncs_per_gen": eager_prof["host_syncs"],
        "eager_device_ms_per_gen": eager_prof["device_ms"],
        "eager_idle_share": 1 - eager_prof["device_ms"] / ms,
        "uncaptured_rollout_host_ms": uncaptured_ms,
        "philox_per_gen": NE_PHILOX, "launches": {k: launches[k] + eager_launches[k] for k in counters},
        "philox_on_path_vs_plain": on_path, "profile": prof, "fused": fused,
        "mean_return_after_init": mean0, "mean_return_final": mean1,
        "best_return_after_init": best0, "best_return_final": best1,
        "card_vs_cpu": card_vs_cpu,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    del wf, state, ref
    torch.cuda.empty_cache()
    return row


def ne_family_workflows(device):
    """The family's other problems: for each, a function that makes its
    workflow, and its Philox launches a generation."""
    import torch
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import ParamsAndVector, rng
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    def rollout_case(policy, make_problem, opt_direction, lr=0.02, sigma=0.05):
        def build():
            params0 = policy.init(rng.key(1))
            adapter = ParamsAndVector(params0)
            algo = ne_openes(adapter.to_vector(params0), device, lr, sigma, NE_FAMILY_POP)
            return StdWorkflow(algo, make_problem(), monitor=EvalMonitor(), opt_direction=opt_direction,
                               solution_transform=adapter.batched_to_params)
        return build

    def supervised():
        g = torch.Generator().manual_seed(0)
        n, d = NE_SL_DATA
        x = torch.randn(n, d, generator=g)
        y = torch.tanh(x @ torch.randn(d, 1, generator=g) / d**0.5)
        policy = ne.MLPPolicy((d, 32, 1))
        params0 = policy.init(rng.key(1))
        adapter = ParamsAndVector(params0)
        prob = ne.SupervisedLearningProblem(policy.apply, x, y, criterion=lambda p, t: ((p - t) ** 2).mean(),
                                            batch_size=256, n_batch_per_eval=4, device=device)
        algo = ne_openes(adapter.to_vector(params0), device, 0.01, 0.02, NE_FAMILY_POP)
        return StdWorkflow(algo, prob, monitor=EvalMonitor(), solution_transform=adapter.batched_to_params)

    ne.minibrax.activate()
    ne.miniplayground.activate()
    rollout_gen = {"philox_draws": 1, "philox_draws_batched": 1}
    return {
        # The problem-side direction convention (maximize_reward=True).
        "pendulum": (rollout_case(ne.MLPPolicy((3, 16, 1)), lambda: ne.RolloutProblem(
            ne.MLPPolicy((3, 16, 1)), ne.pendulum(), 200), "min", 0.05, 0.1), rollout_gen),
        "brax_hopper": (rollout_case(ne.MLPPolicy((5, 16, 1)), lambda: ne.BraxProblem(
            ne.MLPPolicy((5, 16, 1)), "hopper", 100, maximize_reward=False, device=device), "max"),
            rollout_gen),
        "mujoco_pointmass": (rollout_case(ne.MLPPolicy((4, 16, 2)), lambda: ne.MujocoProblem(
            ne.MLPPolicy((4, 16, 2)), "PointMass", 100, maximize_reward=False, device=device), "max"),
            rollout_gen),
        "supervised": (supervised, {"philox_draws": 1, "philox_draws_batched": 0}),
    }


def phase_neuroevolution_family(device) -> dict:
    """Pendulum through RolloutProblem, the hopper through BraxProblem on the
    port's minibrax, PointMass through MujocoProblem on miniplayground
    (1024 individuals; T = 200, 100, 100) and SupervisedLearningProblem on
    its device-resident path (a synthetic regression made from the seed),
    each with OpenES and an EvalMonitor: init_step, the draws of one eager
    step replayed through the plain version bit for bit
    (``recording_draws``), then NE_FAMILY_GENS eager steps against
    run(NE_FAMILY_GENS) and run_segment bit for bit (the device operations
    of a generation and no host sync in a profiled one-generation
    segment), Philox launches a generation, finite fitness; then
    BraxProblem.visualize (HTML) once."""
    import torch

    counters = ne_counters()
    out = {}
    hopper = None
    for name, (build, per_gen) in ne_family_workflows(device).items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wf = build()
        for c in counters.values():
            c.launches = 0
        state = wf.init_step(wf.init(0))
        s0 = wf.step(state)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        ne_check_launches(counters, per_gen, 2, name)
        setup_launches = {k: c.launches for k, c in counters.items()}
        seen = []
        with recording_draws(seen):
            wf.step(s0)
        on_path = draws_on_path(name, seen)
        if on_path["launches"] != per_gen:
            raise AssertionError(f"{name}: one eager step launched {on_path['launches']}, expected {per_gen}")
        del seen
        fused, ref = fused_vs_eager(wf, s0, NE_FAMILY_GENS, counters, name, profile_gens=NE_PROFILE_GENS)
        eager_launches = fused.pop("launches_in_eager_steps")
        for k in counters:
            if eager_launches[k] != per_gen[k] * NE_FAMILY_GENS:
                raise AssertionError(f"{name}: {eager_launches[k]} {k} launches in {NE_FAMILY_GENS} eager steps")
        fit = ref.algorithm.fit
        if not bool(torch.isfinite(fit).all()):
            raise AssertionError(f"{name}: fitness that is not finite")
        out[name] = {
            "setup_and_2_gens_s": setup_s, "fused": fused, "philox_per_gen": per_gen, "philox_on_path_vs_plain": on_path,
            "launches": {k: setup_launches[k] + eager_launches[k] for k in counters},
            "best_fitness": float(wf.monitor.get_best_fitness(ref.monitor)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        if name == "brax_hopper":
            hopper = (wf, ref)
        del state, s0
    wf, ref = hopper
    t0 = time.perf_counter()
    adapter = wf.solution_transform.__self__
    html = wf.problem.visualize(ref.problem, adapter.to_params(ref.algorithm.center))
    if "<html" not in html:
        raise AssertionError("brax_hopper: visualize did not render an HTML document")
    data = json.loads(html.split("const data = ", 1)[1].split(";\n", 1)[0])
    frames = len(data["frames"])
    if not 2 <= frames <= wf.problem.max_episode_length + 1:
        raise AssertionError(f"brax_hopper: visualize rendered {frames} frames")
    out["brax_hopper"]["visualize_html"] = {"seconds": time.perf_counter() - t0, "bytes": len(html),
                                            "frames": frames}
    del wf, ref, hopper
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(out[n]["launches"][k] for n in out if n != "launches") for k in counters}
    return out


# ---------------------------------------------------------------------------
# Slice 11: the precision plane.  bench.py's pso_northstar_policy and
# nsga2_dtlz2_policy (PrecisionPolicy() and key_impl="rbg"), with their
# accuracy gates; pso_northstar_bf16 (the first path on the bf16 route of
# the PSO kernel); pso_northstar_rbg and pso_northstar_bf16_rbg, a named
# key stream on the same kernels.
# ---------------------------------------------------------------------------

# bench.py's _policy_quality_so (bench.py:463-475, 497-507): PSO pop 2048,
# dim 128, 100 fused generations, final best fitness within 1.25x (+1e-6);
# _policy_quality_igd (bench.py:478-492, 561-572): NSGA-II pop 256, 50
# generations, final IGD within 1.15x (+1e-9), both against float32.
POLICY_SO = dict(pop=2048, dim=128, gens=100, tol_factor=1.25, eps=1e-6)
POLICY_MO = dict(pop=256, gens=50, tol_factor=1.15, eps=1e-9)
TWIN_GENS = 3
TWINS = {"pso_northstar_rbg": "float32", "pso_northstar_bf16_rbg": "bfloat16"}
# PSO's mapped (N, D) leaves, carried in bfloat16 under the policy.
PSO_STORAGE_ARRAYS = ("pop", "velocity", "local_best_location")


def accuracy_bound(ref, tol_factor, eps) -> float:
    """bench.py's accuracy_bound: ``ref + (tol_factor - 1)·|ref| + eps``."""
    return ref + (tol_factor - 1.0) * abs(ref) + eps


def policy_quality(make_ref, make_policy, final_metric, label, gens, tol_factor, eps) -> dict:
    """bench.py's _policy_quality: the float32 reference and the policy's
    workflow, each from seed 0 through init_step and ``run(gens,
    init=False)``; fails when the policy's final metric (lower is better)
    exceeds ``accuracy_bound`` of the reference's."""
    def run_final(wf):
        st = wf.init_step(wf.init(0))
        return float(final_metric(wf.run(st, gens, init=False)))

    ref, pol = run_final(make_ref()), run_final(make_policy())
    quality = {"metric": label, "gens": gens, "ref": ref, "policy": pol, "tol_factor": tol_factor,
               "bound": accuracy_bound(ref, tol_factor, eps)}
    if not pol <= quality["bound"]:
        raise AssertionError(f"precision accuracy gate failed: {quality}")
    return quality


def pso_workflow(device, n, d, dtype=None, **kw):
    """``StdWorkflow(PSO(n, ±10 in dim d, dtype), Sphere(), **kw)``."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    dtype = dtype or torch.float32
    lb = torch.full((d,), -10.0, dtype=dtype)
    return StdWorkflow(PSO(n, lb, -lb, dtype=dtype, device=device), Sphere(), **kw)


def nsga2_workflow(device, pop, **kw):
    import torch
    from evox_tpu_torch.algorithms import NSGA2
    from evox_tpu_torch.problems.numerical import DTLZ2
    from evox_tpu_torch.workflows import StdWorkflow

    algo = NSGA2(pop, NSGA2_OBJ, torch.zeros(NSGA2_DIM), torch.ones(NSGA2_DIM), device=device)
    return StdWorkflow(algo, DTLZ2(d=NSGA2_DIM, m=NSGA2_OBJ, device=device), **kw)


def reset_move_counters():
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    fused_pso_move.launches = philox_draws.launches = 0
    fused_pso_move.routes = {k: 0 for k in fused_pso_move.routes}


@contextlib.contextmanager
def counting_routes(out: dict):
    """The launches of the PSO kernel by dtype route inside the block."""
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    before = dict(fused_pso_move.routes)
    yield
    out.update({k: v - before[k] for k, v in fused_pso_move.routes.items()})


def storage_dtypes(state, names) -> dict:
    return {k: str(state.algorithm[k].dtype).split(".")[-1] for k in names}


def state_gb(state) -> float:
    from evox_tpu_torch.utils import graph

    return sum(t.numel() * t.element_size() for t in graph.flatten(state)[0]) / 1e9


def expect(got, want, what):
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def policy_path(wf, counters, what, philox_per_gen, eager_context=None) -> tuple[dict, object]:
    """Setup (its Philox launches counted), init_step and one step, the
    eager steady state's peak memory over 3 more steps, then
    ``fused_vs_eager`` over SEGMENT_GENS generations (run(20) and
    run_segment(20) bit for bit against eager steps, no host sync in a
    segment) and eager steps profiled (device operations, host syncs, idle
    share, device time by kernel); last, the draws of a setup and of one
    eager step recorded (``recording_draws``), as many as the path's
    setup and ``philox_per_gen`` launch, and replayed through the plain
    version bit for bit."""
    import torch
    from evox_tpu_torch.ops.philox import philox_draws

    torch.cuda.empty_cache()
    reset_move_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    s0 = wf.init(0)
    torch.cuda.synchronize()
    setup = {"seconds": time.perf_counter() - t0, "philox_draws": philox_draws.launches}
    s1 = wf.step(wf.init_step(s0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = s1
    for _ in range(MAIN_WARMUP):
        s = wf.step(s)
    torch.cuda.synchronize()
    eager_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del s
    row, ref = fused_vs_eager(wf, s1, SEGMENT_GENS, counters, what,
                              eager_context=eager_context or contextlib.nullcontext)
    per_gen = launches_per_call(lambda: wf.step(s1), calls=3)
    if per_gen["host_syncs"] != 0:
        raise AssertionError(f"{what}: an eager step made host syncs: {per_gen}")
    _, prof = profile_steps(wf.step, s1, PROFILE_STEPS)
    seen = []
    with recording_draws(seen):
        wf.init(0)
    expect(len(seen), setup["philox_draws"], f"{what}: draws recorded in a setup")
    with recording_draws(seen):
        wf.step(s1)
    expect(len(seen) - setup["philox_draws"], philox_per_gen, f"{what}: draws recorded in one step")
    on_path = draws_on_path(what, seen)
    del seen
    row.update({
        "philox_per_gen": philox_per_gen, "philox_on_path_vs_plain": on_path,
        "eager_kernels_ms_per_gen": prof["kernels_ms_per_gen"],
        "setup": setup, "state_gb": state_gb(s1), "eager_peak_mem_gb": eager_peak_gb,
        "eager_device_ops_per_gen": per_gen["launches"], "eager_host_syncs_per_gen": per_gen["host_syncs"],
        "eager_device_ms_per_gen": per_gen["device_ms"],
        "eager_idle_share": 1 - per_gen["device_ms"] / row["eager_ms_per_gen"],
    })
    return row, (s0, s1, ref)


def phase_pso_policy_main_path(device) -> dict:
    """bench.py's pso_northstar_policy: StdWorkflow(PSO(100000, ±10 in dim
    1000), Sphere(), precision=PrecisionPolicy(), key_impl="rbg").  The
    carried pop, velocity and local best are bfloat16 (the state between
    generations and a segment's carried state), the keys are rbg's; eager
    steps, run(20) and run_segment(20) bit for bit against them, every
    step's move on the kernel's float32 route (the compute form); the
    rbg-keyed draws of a setup replayed through the plain version and the
    move of one step held against its plain version (``move_vs_plain``),
    bit for bit; then bench.py's accuracy gate."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.precision import PrecisionPolicy, key_impl_name

    n, d = HEADLINE
    wf = pso_workflow(device, n, d, precision=PrecisionPolicy(), key_impl="rbg")
    routes = {}
    row, (s0, s1, ref) = policy_path(wf, {"fused_pso_move": fused_pso_move}, "pso_northstar_policy", 0,
                                     lambda: counting_routes(routes))
    expect(key_impl_name(s0.algorithm.key), "rbg", "pso_northstar_policy: key impl")
    for st, when in ((s0, "setup"), (s1, "after a step"), (ref, "after 20 eager steps")):
        expect(storage_dtypes(st, PSO_STORAGE_ARRAYS), {k: "bfloat16" for k in PSO_STORAGE_ARRAYS},
               f"pso_northstar_policy: carried dtypes {when}")
    expect(row["launches_in_eager_steps"], {"fused_pso_move": SEGMENT_GENS}, "pso_northstar_policy: launches")
    expect(routes, {"float32": SEGMENT_GENS, "bfloat16": 0}, "pso_northstar_policy: kernel routes")
    expect(row["setup"]["philox_draws"], 2, "pso_northstar_policy: setup draws")
    best0 = float(s1.algorithm.global_best_fit)
    best1 = float(torch.minimum(ref.algorithm.global_best_fit, ref.algorithm.fit.float().min()))
    if not best1 < best0 or not bool(torch.isfinite(ref.algorithm.pop).all()):
        raise AssertionError(f"pso_northstar_policy: best fitness {best0} -> {best1}")
    move = move_vs_plain(wf, ref, "pso_northstar_policy")
    expect(move["dtype"], "float32", "pso_northstar_policy: the compared move's route")
    storage_gb = sum(ref.algorithm[k].numel() * ref.algorithm[k].element_size() for k in PSO_STORAGE_ARRAYS) / 1e9
    q = POLICY_SO
    quality = policy_quality(
        lambda: pso_workflow(device, q["pop"], q["dim"]),
        lambda: pso_workflow(device, q["pop"], q["dim"], precision=PrecisionPolicy(), key_impl="rbg"),
        lambda st: st.algorithm.fit.float().min(), "final best fitness", q["gens"], q["tol_factor"], q["eps"])
    return {"config": "PSO pop=100000 dim=1000 Sphere, PrecisionPolicy() (bfloat16 storage, float32 compute), "
                      "key_impl=rbg", **row, "routes_in_eager_steps": routes, "move_vs_plain": move,
            "carried_storage_arrays_gb": storage_gb, "best_after_first_step": best0, "best_final": best1,
            "quality": quality}


def phase_nsga2_policy_main_path(device) -> dict:
    """bench.py's nsga2_dtlz2_policy: NSGA2(10000, m=3, d=12) on DTLZ2 under
    PrecisionPolicy() and key_impl="rbg".  pop, fit and dis carried in
    bfloat16; eager steps, run(20) and run_segment(20) bit for bit; each
    ranking kernel once a generation as on the float32 headline, on its
    float32 route (the survivor selection's merged objectives recorded in
    the eager steps); the rbg-keyed draws of a setup and of one step
    replayed through the plain version bit for bit; IGD falling; then
    bench.py's IGD gate."""
    import torch
    from evox_tpu_torch.algorithms.mo import nsga2
    from evox_tpu_torch.metrics import igd
    from evox_tpu_torch.precision import PrecisionPolicy, key_impl_name
    from evox_tpu_torch.problems.numerical import DTLZ2

    counters = {k: v for k, v in mo_counters().items() if k != "dominance_matrix"}
    wf = nsga2_workflow(device, NSGA2_POP, precision=PrecisionPolicy(), key_impl="rbg")
    select, merged = nsga2.nd_environmental_selection, set()

    @contextlib.contextmanager
    def recording_merged():
        def recording(x, f, topk):
            merged.add((str(x.dtype), str(f.dtype)))
            return select(x, f, topk)

        nsga2.nd_environmental_selection = recording
        try:
            yield
        finally:
            nsga2.nd_environmental_selection = select

    row, (s0, s1, ref) = policy_path(wf, counters, "nsga2_dtlz2_policy", 3, recording_merged)
    expect(key_impl_name(s0.algorithm.key), "rbg", "nsga2_dtlz2_policy: key impl")
    for st, when in ((s0, "setup"), (ref, "after 20 eager steps")):
        expect(storage_dtypes(st, ("pop", "fit", "dis", "rank")),
               {"pop": "bfloat16", "fit": "bfloat16", "dis": "bfloat16", "rank": "int32"},
               f"nsga2_dtlz2_policy: carried dtypes {when}")
    per_gen = {"dominance_packed": 1, "peel_fronts": 1, "lex_rank": 1, "crowding_neighbors": 1, "philox_draws": 3}
    expect(row["launches_in_eager_steps"], {k: v * SEGMENT_GENS for k, v in per_gen.items()},
           "nsga2_dtlz2_policy: launches in the eager steps")
    expect(merged, {("torch.float32", "torch.float32")}, "nsga2_dtlz2_policy: the ranking kernels' input dtypes")
    pf = DTLZ2(d=NSGA2_DIM, m=NSGA2_OBJ, device=device).pf()
    igd0, igd1 = float(igd(s1.algorithm.fit.float(), pf)), float(igd(ref.algorithm.fit.float(), pf))
    if not igd1 < igd0:
        raise AssertionError(f"nsga2_dtlz2_policy: IGD did not fall: {igd0} -> {igd1}")
    q = POLICY_MO
    quality = policy_quality(
        lambda: nsga2_workflow(device, q["pop"]),
        lambda: nsga2_workflow(device, q["pop"], precision=PrecisionPolicy(), key_impl="rbg"),
        lambda st: igd(st.algorithm.fit.float(), pf), "igd", q["gens"], q["tol_factor"], q["eps"])
    return {"config": "NSGA2 pop=10000 d=12 m=3 DTLZ2, PrecisionPolicy(), key_impl=rbg", **row,
            "launches": row["launches_in_eager_steps"], "merged_dtypes": sorted(merged),
            "igd_after_first_step": igd0, "igd_final": igd1, "quality": quality}


def move_operands(algo, st) -> dict:
    """The operands of the move ``PSO.step`` launches from state ``st``."""
    from evox_tpu_torch.algorithms.so.pso_variants.utils import min_by
    from evox_tpu_torch.utils import rng

    gbl, _ = min_by([st.global_best_location[None, :], st.pop], [st.global_best_fit[None], st.fit])
    _, (seed,) = rng.split(st.key)
    return dict(pop=st.pop, velocity=st.velocity, local_best_location=st.local_best_location, fit=st.fit,
                local_best_fit=st.local_best_fit, global_best_location=gbl, lb=algo.lb, ub=algo.ub,
                w=st.w, phi_p=st.phi_p, phi_g=st.phi_g, seed=seed)


def move_vs_plain(wf, state, what) -> dict:
    """The move of the step after ``state``, formed as PSO.step forms it
    (from the compute form under a policy, with the state's own key), on
    the card against fused_pso_move_plain, 0 ulp, and equal in the
    carried dtype to what the step makes.  The PSO kernel's counts are
    restored: launches made to compare are not the path's."""
    from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain

    counts = fused_pso_move.launches, dict(fused_pso_move.routes)
    algo = state.algorithm
    if wf.precision is not None:
        algo = wf.precision.promote(algo, wf._precision_leaf_map)
    ops = move_operands(wf.algorithm, algo)
    got = fused_pso_move(**ops)
    want = fused_pso_move_plain(**ops)
    names = ("pop", "velocity", "local_best_location", "local_best_fit")
    errs = {name: compare(g, w) for name, g, w in zip(names, got, want)}
    if any(e["max_ulp"] for e in errs.values()):
        raise AssertionError(f"{what}: the move against its plain version: {errs}")
    stepped = wf.step(state).algorithm
    for name, g in zip(names, got):
        exact(g.to(stepped[name].dtype), stepped[name], f"{what}: the compared move against the step's {name}")
    fused_pso_move.launches, fused_pso_move.routes = counts
    return {"dtype": str(ops["pop"].dtype).split(".")[-1], "errors": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values())}


def phase_pso_bf16_main_path(device) -> dict:
    """bench.py's pso_northstar_bf16: StdWorkflow(PSO(100000, ±10 in dim
    1000, dtype=bfloat16), Sphere()): every step's move on the kernel's
    bfloat16 route; eager steps, run(20) and run_segment(20) bit for bit;
    then the move of the step after them, formed as PSO.step forms it,
    against fused_pso_move_plain on the card, 0 ulp, and equal to what the
    step makes (``move_vs_plain``)."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    n, d = HEADLINE
    wf = pso_workflow(device, n, d, dtype=torch.bfloat16)
    routes = {}
    row, (_, s1, ref) = policy_path(wf, {"fused_pso_move": fused_pso_move}, "pso_northstar_bf16", 0,
                                    lambda: counting_routes(routes))
    expect(storage_dtypes(ref, PSO_STORAGE_ARRAYS + ("fit", "global_best_fit")),
           {k: "bfloat16" for k in PSO_STORAGE_ARRAYS + ("fit", "global_best_fit")}, "pso_northstar_bf16: dtypes")
    expect(row["launches_in_eager_steps"], {"fused_pso_move": SEGMENT_GENS}, "pso_northstar_bf16: launches")
    expect(routes, {"float32": 0, "bfloat16": SEGMENT_GENS}, "pso_northstar_bf16: kernel routes")
    best0 = float(s1.algorithm.global_best_fit)
    best1 = float(torch.minimum(ref.algorithm.global_best_fit, ref.algorithm.fit.min()))
    if not best1 < best0:
        raise AssertionError(f"pso_northstar_bf16: best fitness {best0} -> {best1}")
    move = move_vs_plain(wf, ref, "pso_northstar_bf16")
    expect(move["dtype"], "bfloat16", "pso_northstar_bf16: the compared move's route")
    return {"config": "PSO pop=100000 dim=1000 Sphere bfloat16, StdWorkflow, no monitor", **row,
            "routes_in_eager_steps": routes, "move_vs_plain": move,
            "best_after_first_step": best0, "best_final": best1}


def phase_key_impl_twins(device) -> dict:
    """bench.py's pso_northstar_rbg and pso_northstar_bf16_rbg against their
    default twins, TWIN_GENS generations each: the rbg stream differs from
    the default's (setup's swarm and the last state), the kernels and their
    launches (by route) are the twin's, the rbg run's draws (recorded in a
    second run) and the move of the step after it equal their plain
    versions bit for bit, and EVOX_TPU_KEY_IMPL=rbg gives the state
    key_impl="rbg" gives, bit for bit.  Not timed apart: every name draws
    with the same Philox kernels."""
    import torch
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.precision import key_impl_name

    n, d = HEADLINE
    out = {}

    def drive(wf):
        reset_move_counters()
        s0 = wf.init(0)
        s = wf.init_step(s0)
        for _ in range(TWIN_GENS):
            s = wf.step(s)
        torch.cuda.synchronize()
        counts = {"fused_pso_move": fused_pso_move.launches, "routes": dict(fused_pso_move.routes),
                  "philox_draws": philox_draws.launches}
        return s0.algorithm.pop, s, counts

    for name, dtype_name in TWINS.items():
        dtype = getattr(torch, dtype_name)
        pop0, base, base_counts = drive(pso_workflow(device, n, d, dtype))
        twin_wf = pso_workflow(device, n, d, dtype, key_impl="rbg")
        rpop0, twin, counts = drive(twin_wf)
        expect(key_impl_name(twin.algorithm.key), "rbg", f"{name}: key impl")
        if torch.equal(pop0, rpop0) or torch.equal(base.algorithm.pop, twin.algorithm.pop):
            raise AssertionError(f"{name}: the rbg stream equals the default's")
        expect(counts, base_counts, f"{name}: launches against the default twin")
        expect(counts["fused_pso_move"], TWIN_GENS, f"{name}: launches")
        del pop0, rpop0, base
        # The rbg run again with its draws recorded (not counted): the same
        # state, as many draws as the run launched, each equal to the plain
        # version's; then the rbg-keyed move of the step after it.
        seen = []
        with recording_draws(seen):
            _, again, _ = drive(twin_wf)
        same_state(again, twin, f"{name}: the recorded run against the counted one")
        expect(len(seen), counts["philox_draws"], f"{name}: draws recorded")
        on_path = draws_on_path(name, seen)
        del seen, again
        move = move_vs_plain(twin_wf, twin, name)
        expect(move["dtype"], dtype_name, f"{name}: the compared move's route")
        saved = os.environ.get("EVOX_TPU_KEY_IMPL")
        os.environ["EVOX_TPU_KEY_IMPL"] = "rbg"
        try:
            env_wf = pso_workflow(device, n, d, dtype)
        finally:
            if saved is None:
                del os.environ["EVOX_TPU_KEY_IMPL"]
            else:
                os.environ["EVOX_TPU_KEY_IMPL"] = saved
        expect(env_wf.key_impl, "rbg", f"{name}: EVOX_TPU_KEY_IMPL resolved")
        _, from_env, env_counts = drive(env_wf)
        leaves = same_state(from_env, twin, f"{name}: EVOX_TPU_KEY_IMPL=rbg against key_impl='rbg'")
        out[name] = {"gens": TWIN_GENS, "launches": counts, "default_twin_launches": base_counts,
                     "env_equal_leaves": leaves, "env_launches": env_counts,
                     "philox_on_path_vs_plain": on_path, "move_vs_plain": move}
        del twin, from_env
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Slice 12: the HPO nest (bench.py's hpo_ladder, the README's HPO quick
# start).
# ---------------------------------------------------------------------------

# bench.py's hpo_ladder (bench.py:1295-1313): PSO(64) over OpenES(1024,
# zeros(32), lr 0.05, sigma 0.1) on Sphere, 32 inner generations.
HPO_LADDER = dict(candidates=64, inner_pop=1024, dim=32, iterations=32)
# The README's HPO quick start (README.md:150-166): DE(16) over PSO(30, ±10
# in dim 8) on Sphere, HPOProblemWrapper(iterations=25, num_instances=16).
HPO_QUICKSTART = dict(candidates=16, inner_pop=30, dim=8, iterations=25)
HPO_GENS = 20
HPO_REPEATS, HPO_REPEAT_GENS = 3, 5


def ladder_transform(x):
    return {"algorithm.lr": x[:, 0].clamp(1e-3, 0.5), "algorithm.noise_stdev": x[:, 1].clamp(1e-3, 0.5)}


def quickstart_transform(x):
    return {"algorithm.w": x[:, 0], "algorithm.phi_p": x[:, 1], "algorithm.phi_g": x[:, 2]}


def hpo_ladder_workflow(device, **kw):
    """hpo_ladder; ``kw`` goes to the outer workflow (``enable_distributed``
    and ``mesh`` split the candidates over a mesh)."""
    import torch
    from evox_tpu_torch.algorithms import PSO, OpenES
    from evox_tpu_torch.hpo import HPOFitnessMonitor, NestedProblem
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    c = HPO_LADDER
    inner = StdWorkflow(OpenES(c["inner_pop"], torch.zeros(c["dim"]), learning_rate=0.05, noise_stdev=0.1,
                               device=device), Sphere(), monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=c["iterations"], num_candidates=c["candidates"])
    return StdWorkflow(PSO(c["candidates"], lb=1e-3 * torch.ones(2), ub=0.5 * torch.ones(2), device=device), nested,
                       solution_transform=ladder_transform, **kw)


def hpo_quickstart_workflow(device, **kw):
    import torch
    from evox_tpu_torch.algorithms import DE, PSO
    from evox_tpu_torch.problems.hpo_wrapper import HPOFitnessMonitor, HPOProblemWrapper
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    c = HPO_QUICKSTART
    d = c["dim"]
    inner = StdWorkflow(PSO(c["inner_pop"], -10 * torch.ones(d), 10 * torch.ones(d), device=device), Sphere(),
                        monitor=HPOFitnessMonitor())
    hpo = HPOProblemWrapper(iterations=c["iterations"], num_instances=c["candidates"], workflow=inner, **kw)
    return StdWorkflow(DE(c["candidates"], lb=torch.zeros(3), ub=torch.tensor([1.0, 4.0, 4.0]), device=device), hpo,
                       solution_transform=quickstart_transform)


def uncaptured_nests():
    """While active, a nest's evaluation runs its batch eagerly instead of
    replaying its captured graph (the functorch host cost the graph
    removes, and every wrapper called, so launches are counted and
    recorded): the graph module's context of a capture's warm-up."""
    from evox_tpu_torch.utils import graph

    return graph._inline()


@contextlib.contextmanager
def recording_batched_moves(seen):
    """While active, every launch of the batched PSO move (``ops.pso_step``'s
    ``_launch`` called with more than one instance) appends its operands
    and outputs, copied, to ``seen``."""
    from evox_tpu_torch.ops import pso_step

    launch = pso_step._launch

    def recording(*args):
        out = launch(*args)
        if args[0].shape[0] > 1:
            seen.append(([a.clone() if hasattr(a, "clone") else a for a in args], [o.clone() for o in out]))
        return out

    pso_step._launch = recording
    try:
        yield
    finally:
        pso_step._launch = launch


def batched_moves_vs_plain(seen, what) -> dict:
    """Each recorded batched move against fused_pso_move_batched_plain on the
    card on the same operands, bit for bit; the rows of its scalars."""
    from evox_tpu_torch.ops import pso_step

    if not seen:
        raise AssertionError(f"{what}: no batched move recorded")
    worst, distinct = 0.0, []
    for args, out in seen:
        want = pso_step.fused_pso_move_batched_plain(*args[:12])
        names = ("pop", "velocity", "local_best_location", "local_best_fit")
        worst = max([worst] + [exact(g, w, f"{what}: the batched move's {n}") for n, g, w in zip(names, out, want)])
        scal = args[8]
        distinct.append(len({tuple(r) for r in scal.tolist()}))
    return {"moves": len(seen), "instances": int(seen[0][0][0].shape[0]), "distinct_scalar_rows": min(distinct),
            "max_abs_err": worst}


def hpo_counters():
    from evox_tpu_torch.ops import philox, pso_step

    return {"fused_pso_move": pso_step.fused_pso_move, "fused_pso_move_batched": pso_step.fused_pso_move_batched,
            "philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}


def counts(counters) -> dict:
    return {k: c.launches for k, c in counters.items()}


def candidates_vs_solo(wf, state, keys, what) -> dict:
    """The evaluation of the outer population of ``state`` (a replayed
    nest): each candidate equal to its solo inner run (the inner workflow
    stepped eagerly from ``keys[i]`` with candidate i's hyper-parameters),
    fitness and best-fitness series, bit for bit."""
    import torch
    from evox_tpu_torch.core import set_params

    nested, inner = wf.problem, wf.problem.workflow
    hp = wf.solution_transform(state.algorithm.pop)
    fit, st = nested.evaluate(state.problem, hp)
    tel = st.telemetry if "telemetry" in st else None
    for i in range(nested.num_candidates):
        ws = inner.init_step(set_params(inner.setup(keys[i]), {k: v[i] for k, v in hp.items()}))
        series = []
        for _ in range(nested.iterations - 2):
            ws = inner.step(ws)
            series.append(torch.amin(ws.algorithm.fit))
        ws = inner.final_step(ws)
        exact(fit[i], inner.monitor.tell_fitness(ws.monitor), f"{what}: candidate {i} against its solo run")
        if tel is not None:
            exact(tel.best_fitness[i], torch.stack(series), f"{what}: candidate {i}'s series against its solo run")
    return {"candidates": nested.num_candidates, "telemetry_checked": tel is not None}


def hpo_path(wf, what, predicted, recorded_setup, recorded_step) -> tuple[dict, object]:
    """One HPO path, timed as bench.py times hpo_ladder: setup, init_step
    (its evaluation captures the nest's graph: capture time and pool), one
    warm step, then ``fused_vs_eager`` over HPO_GENS outer generations
    (eager steps, each nest a replayed graph, against run(HPO_GENS) and
    run_segment(HPO_GENS), bit for bit; no host sync in a segment), an
    eager step profiled (device operations, host syncs, idle share), one
    evaluation uncaptured (its host ms and its launches, against
    ``predicted``), the draws of a setup and of one uncaptured outer step
    recorded and replayed through the plain version bit for bit (as many
    as ``recorded_setup`` and ``recorded_step`` by route), and the outer
    best fitness falling."""
    import torch

    counters = hpo_counters()
    nested = wf.problem
    c = {"candidates": nested.num_candidates, "iterations": nested.iterations}
    torch.cuda.empty_cache()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    s0 = wf.init(0)
    torch.cuda.synchronize()
    setup = {"seconds": time.perf_counter() - t0, "launches": counts(counters)}
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    s = wf.init_step(s0)
    torch.cuda.synchronize()
    capture = {"seconds": time.perf_counter() - t0,
               "allocated_gb": (torch.cuda.memory_allocated() - allocated) / 1e9,
               "pool_reserved_gb": (torch.cuda.memory_reserved() - reserved) / 1e9,
               "graphs": len(nested._graphs)}
    if capture["graphs"] != (wf.algorithm.device.type == "cuda"):
        raise AssertionError(f"{what}: {capture['graphs']} nest graphs captured")
    # The best of the first evaluation (the outer population as drawn).
    best0 = float(s.algorithm.fit.min())
    s1 = wf.step(s)
    torch.cuda.synchronize()
    path = counts(counters)
    fused, ref = fused_vs_eager(wf, s1, HPO_GENS, counters, what, profile_gens=1)
    eager_launches = fused.pop("launches_in_eager_steps")
    launches = {k: path[k] + eager_launches[k] for k in counters}
    eager_prof = launches_per_call(lambda: wf.step(s1), calls=1)
    if eager_prof["host_syncs"] != 0:
        raise AssertionError(f"{what}: an eager outer step made host syncs: {eager_prof}")
    # One evaluation uncaptured: its host time and its launches.
    hp = wf.solution_transform(s1.algorithm.pop)
    with uncaptured_nests():
        before = counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nested.evaluate(s1.problem, hp)
        torch.cuda.synchronize()
        uncaptured_ms = (time.perf_counter() - t0) * 1e3
        per_eval = {k: v - before[k] for k, v in counts(counters).items()}
    expect(per_eval, predicted, f"{what}: launches of one uncaptured evaluation")
    seen = []
    with recording_draws(seen):
        wf.init(0)
    setup_routes = {"philox_draws": sum(1 for e in seen if e[5]), "philox_draws_batched": sum(1 for e in seen if not e[5])}
    expect(setup_routes, recorded_setup, f"{what}: draws recorded in a setup")
    n_setup = len(seen)
    with uncaptured_nests(), recording_draws(seen):
        wf.step(s1)
    step_routes = {"philox_draws": sum(1 for e in seen[n_setup:] if e[5]),
                   "philox_draws_batched": sum(1 for e in seen[n_setup:] if not e[5])}
    expect(step_routes, recorded_step, f"{what}: draws recorded in one uncaptured outer step")
    on_path = draws_on_path(what, seen)
    del seen
    best1 = float(torch.minimum(ref.algorithm.fit.min(),
                                getattr(ref.algorithm, "global_best_fit", ref.algorithm.fit.min())))
    if not best1 < best0 or not bool(torch.isfinite(ref.algorithm.fit).all()):
        raise AssertionError(f"{what}: the outer best fitness {best0} -> {best1}")
    inner_gens = c["candidates"] * c["iterations"]
    row = {
        "setup": setup, "nest_capture": capture,
        "eager_ms_per_outer_gen": fused["eager_ms_per_gen"], "run_ms_per_outer_gen": fused["run_ms_per_gen"],
        "inner_gens_per_s_eager": inner_gens * 1e3 / fused["eager_ms_per_gen"],
        "inner_gens_per_s_run": inner_gens * 1e3 / fused["run_ms_per_gen"],
        "eager_device_ops_per_outer_gen": eager_prof["launches"],
        "eager_host_syncs_per_outer_gen": eager_prof["host_syncs"],
        "eager_device_ms_per_outer_gen": eager_prof["device_ms"],
        "eager_idle_share": 1 - eager_prof["device_ms"] / fused["eager_ms_per_gen"],
        "fused": fused, "uncaptured_nest_host_ms": uncaptured_ms, "launches_per_evaluation": per_eval,
        "launches": launches, "philox_on_path_vs_plain": on_path,
        "best_after_init_step": best0, "best_final": best1,
    }
    return row, (s0, s1, ref)


def phase_hpo_main_path(device) -> dict:
    """bench.py's hpo_ladder at full width (``hpo_ladder_workflow``,
    ``hpo_path``): 64 candidates x OpenES(1024, d = 32) x 32 inner
    generations an outer evaluation, the outer PSO(64).  An evaluation
    launches 32 batched Philox draws (OpenES's normals, all 64 candidates in
    one launch a generation) and no move; an outer step 1 solo move.  Then
    the outer move of the step after the timed ones against
    fused_pso_move_plain, 0 ulp (``move_vs_plain``), and every candidate of
    an evaluation against its solo inner run from ``rng.fold_in(key,
    uid)``, bit for bit."""
    import torch
    from evox_tpu_torch.utils import rng

    c = HPO_LADDER
    wf = hpo_ladder_workflow(device)
    predicted = {"fused_pso_move": 0, "fused_pso_move_batched": 0, "philox_draws": 0,
                 "philox_draws_batched": c["iterations"]}
    row, (s0, _, ref) = hpo_path(wf, "hpo_ladder", predicted,
                                 {"philox_draws": 2, "philox_draws_batched": 0},
                                 {"philox_draws": 0, "philox_draws_batched": c["iterations"]})
    move = move_vs_plain(wf, ref, "hpo_ladder")
    prob_key = rng.split_keys(wf._setup_key(0), 3)[1]
    keys = [rng.fold_in(prob_key, uid) for uid in ref.problem.uids]
    solo = candidates_vs_solo(wf, ref, keys, "hpo_ladder")
    del s0, ref
    torch.cuda.empty_cache()
    return {"config": f"PSO({c['candidates']}) over NestedProblem(OpenES({c['inner_pop']}, zeros({c['dim']}), "
                      f"lr 0.05, sigma 0.1), Sphere, HPOFitnessMonitor, iterations={c['iterations']}), prng=uid, "
                      "telemetry on", **row, "move_vs_plain": move, "candidates_vs_solo": solo}


def phase_hpo_quickstart(device) -> dict:
    """The README's HPO quick start at its own width
    (``hpo_quickstart_workflow``, ``hpo_path``): DE(16) tuning w, phi_p and
    phi_g of 16 PSO(30, dim 8) candidates, 25 inner generations.  An
    evaluation launches 24 batched moves (one a generation after the
    first), each with a different (w, phi_p, phi_g) row a candidate, held
    against fused_pso_move_batched_plain bit for bit; an outer step 2 solo
    Philox draws (DE).  Every candidate against its solo run from
    ``split_keys(key, 16)[i]``, bit for bit.  Then num_repeats=3 under
    each aggregation (the repeat operator on the card): eager steps
    against run(HPO_REPEAT_GENS), bit for bit, and the replayed nest
    against the uncaptured one."""
    import torch
    from evox_tpu_torch.utils import rng

    c = HPO_QUICKSTART
    wf = hpo_quickstart_workflow(device)
    predicted = {"fused_pso_move": 0, "fused_pso_move_batched": c["iterations"] - 1, "philox_draws": 0,
                 "philox_draws_batched": 0}
    row, (s0, s1, ref) = hpo_path(wf, "hpo_quickstart", predicted,
                                  {"philox_draws": 1, "philox_draws_batched": 2},
                                  {"philox_draws": 2, "philox_draws_batched": 0})
    seen = []
    hp = wf.solution_transform(ref.algorithm.pop)
    with uncaptured_nests(), recording_batched_moves(seen):
        wf.problem.evaluate(ref.problem, hp)
    moves = batched_moves_vs_plain(seen, "hpo_quickstart")
    expect(moves["moves"], c["iterations"] - 1, "hpo_quickstart: batched moves recorded in one evaluation")
    # Each launch's scalars are the candidates' (w, phi_p, phi_g) rows, and
    # the rows differ.
    rows = torch.stack([hp["algorithm.w"], hp["algorithm.phi_p"], hp["algorithm.phi_g"]], 1).float()
    for args, _ in seen:
        exact(args[8], rows, "hpo_quickstart: the batched move's scalars against the candidates' rows")
    expect(moves["distinct_scalar_rows"], len({tuple(r) for r in rows.tolist()}), "hpo_quickstart: distinct rows")
    if moves["distinct_scalar_rows"] < 2:
        raise AssertionError("hpo_quickstart: every candidate moved with the same scalars")
    del seen
    prob_key = rng.split_keys(wf._setup_key(0), 3)[1]
    solo = candidates_vs_solo(wf, ref, rng.split_keys(prob_key, c["candidates"]), "hpo_quickstart")
    repeats = {}
    for aggregation in ("per_generation", "final"):
        what = f"hpo_quickstart repeats={HPO_REPEATS} {aggregation}"
        rwf = hpo_quickstart_workflow(device, num_repeats=HPO_REPEATS, aggregation=aggregation)
        rs = rwf.step(rwf.init_step(rwf.init(0)))
        eager_ms, _, rref = timed(lambda: _steps(rwf, rs, HPO_REPEAT_GENS), HPO_REPEAT_GENS)
        leaves = same_state(rwf.run(rs, HPO_REPEAT_GENS, init=False), rref,
                            f"{what}: run({HPO_REPEAT_GENS}) (the capture) vs eager steps")
        run_ms, _, fused = timed(lambda: rwf.run(rs, HPO_REPEAT_GENS, init=False), HPO_REPEAT_GENS)
        same_state(fused, rref, f"{what}: replayed run({HPO_REPEAT_GENS}) vs eager steps")
        rhp = rwf.solution_transform(rref.algorithm.pop)
        fit, st = rwf.problem.evaluate(rref.problem, rhp)
        with uncaptured_nests():
            efit, _ = rwf.problem.evaluate(rref.problem, rhp)
        exact(fit, efit, f"{what}: the replayed nest against the uncaptured one")
        if not bool(torch.isfinite(fit).all()):
            raise AssertionError(f"{what}: non-finite fitness")
        repeats[aggregation] = {"eager_ms_per_outer_gen": eager_ms, "run_ms_per_outer_gen": run_ms,
                                "leaves_equal": leaves, "best": float(fit.min())}
        del rwf, rs, rref, fused
    del s0, s1, ref
    torch.cuda.empty_cache()
    return {"config": f"DE({c['candidates']}) over HPOProblemWrapper(iterations={c['iterations']}, "
                      f"num_instances={c['candidates']}) of PSO({c['inner_pop']}, ±10 in dim {c['dim']}), Sphere, "
                      "HPOFitnessMonitor", **row, "batched_moves_vs_plain": moves, "candidates_vs_solo": solo,
            "repeats": repeats}


# -- population-sharded evaluation and the checkpoint plane ----------------------

DIST_8DEV = (8192, 256)  # bench.py's distributed_8dev on one device: PSO(8192 x 1, ±10 in dim 256), Sphere
CKPT_GENS = 20  # the resumed run: CKPT_GENS // 2 generations, a checkpoint, the rest
ASYNC_GENS = 20
DIST_PROFILE_GENS = 3


def device_ops(step, state, steps) -> tuple[object, dict]:
    """Every device operation of ``steps`` calls of ``step`` by name: calls
    and device ms per call (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = step(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = step(state)
        torch.cuda.synchronize()
    ops: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and "CUDA" in str(getattr(ev, "device_type", "")):
            calls, ms = ops.get(ev.key, (0.0, 0.0))
            ops[ev.key] = (calls + ev.count / steps, ms + dev_us / 1e3 / steps)
    return state, ops


def collective_ops(sharded: dict, unsharded: dict) -> dict:
    """The device operations a sharded generation adds to its unsharded
    twin's, by name and whole calls a generation (the profiler can lose
    the first operation of a window: a fraction of a call is not counted),
    with their device ms a generation.  A name ``nccl:...`` is the
    collective's annotation, whose device time is that of the operations
    it spans."""
    out = {}
    for name, (calls, ms) in sharded.items():
        twin_calls, twin_ms = unsharded.get(name, (0.0, 0.0))
        if calls - twin_calls > 0.99:
            out[name[:80]] = {"calls_per_gen": calls - twin_calls,
                              "device_ms_per_gen": ms * (calls - twin_calls) / calls}
    return out


def dist_counters(kind):
    """The launch counters of a sharded run's kernels."""
    from evox_tpu_torch.ops.pso_step import fused_pso_move

    if kind == "pso":  # a PSO generation draws in the move kernel
        return {"fused_pso_move": fused_pso_move}
    return {k: v for k, v in mo_counters().items() if k != "dominance_matrix"}


def sharded_twins(name, device, mesh):
    """(sharded workflow, unsharded twin, kind) of one run of the phase."""
    from evox_tpu_torch.parallel import ShardedProblem
    from evox_tpu_torch.problems.numerical import Sphere

    if name == "distributed_8dev":
        n, d = DIST_8DEV
        return (pso_workflow(device, n, d, enable_distributed=True, mesh=mesh), pso_workflow(device, n, d), "pso")
    if name == "pso_headline_sharded":
        import torch
        from evox_tpu_torch.algorithms import PSO
        from evox_tpu_torch.workflows import StdWorkflow

        n, d = HEADLINE
        lb = torch.full((d,), -10.0)
        wf = StdWorkflow(PSO(n, lb, -lb, device=device), ShardedProblem(Sphere(), mesh))
        return wf, pso_workflow(device, n, d), "pso"
    return (nsga2_workflow(device, NSGA2_POP, enable_distributed=True, mesh=mesh),
            nsga2_workflow(device, NSGA2_POP), "nsga2")


def sharded_run(name, device, mesh) -> dict:
    """One run of ``phase_distributed_main_path``: the sharded workflow's
    eager steps, run(20) and run_segment(20) (``fused_vs_eager``, which
    sets the launch counters to 0 just before the eager steps and reads
    them after), the same for its unsharded twin, the two held bit for bit;
    one eager generation of each profiled (the collective's device
    operations: what the sharded one adds), their host syncs a
    generation."""
    import torch

    wf, twin, kind = sharded_twins(name, device, mesh)
    counters = dist_counters(kind)
    s0 = wf.step(wf.init_step(wf.init(0)))
    t0 = twin.step(twin.init_step(twin.init(0)))
    same_state(s0, t0, f"{name}: sharded vs unsharded after init_step + 1 step")
    row, ref = fused_vs_eager(wf, s0, SEGMENT_GENS, counters, f"{name} (sharded)")
    twin_row, twin_ref = fused_vs_eager(twin, t0, SEGMENT_GENS, counters, f"{name} (unsharded)")
    leaves = same_state(ref, twin_ref, f"{name}: {SEGMENT_GENS} sharded eager steps vs unsharded")
    if row["launches_in_eager_steps"] != twin_row["launches_in_eager_steps"]:
        raise AssertionError(f"{name}: kernel launches {row['launches_in_eager_steps']} sharded, "
                             f"{twin_row['launches_in_eager_steps']} unsharded")
    if min(row["launches_in_eager_steps"].values()) < 1:
        raise AssertionError(f"{name}: a kernel of the path was not launched: {row['launches_in_eager_steps']}")
    _, ops = device_ops(wf.step, ref, DIST_PROFILE_GENS)
    _, twin_ops = device_ops(twin.step, twin_ref, DIST_PROFILE_GENS)
    # The collective's annotation spans its device operations.
    annotation = {k[:80]: {"calls_per_gen": c, "device_ms_per_gen": ms}
                  for k, (c, ms) in ops.items() if k.startswith("nccl:")}
    if not annotation:
        raise AssertionError(f"{name}: the profiler shows no device time of the all-gather")
    syncs = launches_per_call(lambda: wf.step(s0), calls=3)["host_syncs"]
    twin_syncs = launches_per_call(lambda: twin.step(t0), calls=3)["host_syncs"]
    best = ref.algorithm.fit.min() if kind == "pso" else None
    out = {
        "sharded": row, "unsharded": twin_row, "leaves_equal": leaves,
        "launches": row["launches_in_eager_steps"],
        "eager_ms_per_gen": row["eager_ms_per_gen"], "unsharded_eager_ms_per_gen": twin_row["eager_ms_per_gen"],
        "run_ms_per_gen": row["run_ms_per_gen"], "unsharded_run_ms_per_gen": twin_row["run_ms_per_gen"],
        "all_gather_annotation": annotation,
        "all_gather_device_ms_per_gen": sum(v["device_ms_per_gen"] for v in annotation.values()),
        "device_ops_added_per_gen": collective_ops(ops, twin_ops),
        "host_syncs_per_gen": syncs, "unsharded_host_syncs_per_gen": twin_syncs,
        "state_gb": state_gb(ref),
    }
    if best is not None:
        out["best_final"] = float(best)
    del wf, twin, s0, t0, ref, twin_ref
    torch.cuda.empty_cache()
    return out


def quarantine_on_one_rank(device, mesh) -> dict:
    """Shard quarantine with one condemned shard on the one-rank mesh: one
    NaN row at one evaluation condemns the shard, every row of it takes the
    penalty, the monitor counts one event."""
    import torch
    from evox_tpu_torch.core import Problem, State
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import EvalMonitor

    class OneNaN(Problem):
        """Sphere with row 17 NaN at the third evaluation (counted on the
        host: the steps run eagerly, and a sharded evaluation keeps no
        state of the problem it wraps but its key)."""

        calls = 0

        def evaluate(self, state, pop):
            fit, _ = Sphere().evaluate(State(), pop)
            self.calls += 1
            if self.calls == 3:
                fit = torch.where(torch.arange(fit.shape[0], device=fit.device) == 17,
                                  torch.full_like(fit, float("nan")), fit)
            return fit, state

    n, d = DIST_8DEV
    mon = EvalMonitor()
    wf = pso_workflow(device, n, d, monitor=mon, enable_distributed=True, mesh=mesh, quarantine_granularity="shard")
    wf.problem.problem = OneNaN()
    s = wf.step(wf.init_step(wf.init(0)))
    before = int(mon.get_num_shard_quarantines(s.monitor))
    s = wf.step(s)  # the third evaluation
    events = int(mon.get_num_shard_quarantines(s.monitor))
    penalized = int(mon.get_num_nonfinite(s.monitor))
    if (before, events, penalized) != (0, 1, n) or not bool((s.algorithm.fit == 1e30).all()):
        raise AssertionError(f"shard quarantine: events {before} -> {events}, penalized {penalized} of {n}")
    return {"shard_events": events, "rows_penalized": penalized}


def phase_distributed_main_path(device) -> dict:
    """Population-sharded evaluation over a one-rank NCCL group
    (``make_pop_mesh()`` sets it up): bench.py's distributed_8dev
    (``StdWorkflow(PSO(8192, ±10 in dim 256), Sphere(),
    enable_distributed=True)``, the whole configuration on one device; its
    ``scaling`` ladder's first rung is the same run), the PSO headline
    through ``ShardedProblem`` and the NSGA-II headline with
    ``enable_distributed=True``, each eager and as run(20) (a captured
    graph that holds the NCCL all-gather) against its unsharded twin bit
    for bit; the sharded Sphere fitness at the headline against the
    unsharded; shard quarantine; and the all-gather alone at the headline's
    fitness shape.  Destroys the group at the end."""
    import torch
    import torch.distributed as dist
    from evox_tpu_torch.core import State
    from evox_tpu_torch.parallel import ALL_GATHER, ShardedProblem, all_gather_rows, make_pop_mesh
    from evox_tpu_torch.problems.numerical import Sphere

    mesh = make_pop_mesh()
    out = {"card": card_line(), "collective": f"torch.distributed.{ALL_GATHER.__name__}", "mesh": repr(mesh),
           "nccl": ".".join(map(str, torch.cuda.nccl.version()))}
    n, d = HEADLINE
    g = torch.Generator(device=device).manual_seed(5)
    pop = torch.rand((n, d), generator=g, device=device) * 20 - 10
    sharded_fit, _ = ShardedProblem(Sphere(), mesh).evaluate(State(), pop)
    plain_fit, _ = Sphere().evaluate(State(), pop)
    out["sphere_fitness_max_abs_err"] = exact(sharded_fit, plain_fit, "sharded Sphere vs unsharded")
    del pop
    out["all_gather_ms_headline_fitness"] = time_ms(lambda: all_gather_rows(plain_fit, mesh), 50)
    out["quarantine"] = quarantine_on_one_rank(device, mesh)
    for name in ("distributed_8dev", "pso_headline_sharded", "nsga2_headline_distributed"):
        out[name] = sharded_run(name, device, mesh)
    launches: dict = {}
    for name in ("distributed_8dev", "pso_headline_sharded", "nsga2_headline_distributed"):
        for k, v in out[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    dist.destroy_process_group()
    return out


def file_system_of(path) -> str:
    """The type of the file system ``path`` lives on (the mount of the
    longest matching prefix in /proc/self/mounts)."""
    best, kind = "", "unknown"
    try:
        lines = Path("/proc/self/mounts").read_text().splitlines()
    except OSError:
        return kind
    for line in lines:
        parts = line.split()
        if len(parts) > 2 and str(path).startswith(parts[1]) and len(parts[1]) > len(best):
            best, kind = parts[1], parts[2]
    return kind


def timed_io(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    res = fn()
    return time.perf_counter() - t0, res


def checkpoint_case(wf, state, path, metadata, template_seed=1, **load_kw) -> tuple[dict, object]:
    """save_state (durable), verify_checkpoint, load_state of ``state``,
    timed; the loaded state equal to ``state`` bit for bit."""
    import torch
    from evox_tpu_torch.utils import load_state, save_state, verify_checkpoint

    gb = state_gb(state)
    torch.cuda.synchronize()
    save_s, written = timed_io(lambda: save_state(path, state, generation=CKPT_GENS // 2, metadata=metadata,
                                                  durable=True))
    verify_s, manifest = timed_io(lambda: verify_checkpoint(written))
    template = wf.init(template_seed)
    load_s, loaded = timed_io(lambda: load_state(written, template, verify=False, **load_kw))
    torch.cuda.synchronize()
    same_state(loaded, state, f"{path.name}: loaded vs saved")
    return {
        "state_gb": gb, "archive_gb": written.stat().st_size / 1e9, "leaves": manifest["n_leaves"],
        "save_s": save_s, "save_gb_per_s": gb / save_s, "verify_s": verify_s, "verify_gb_per_s": gb / verify_s,
        "load_s": load_s, "load_gb_per_s": gb / load_s,
    }, loaded


def async_writer_cost(wf, state, path) -> dict:
    """ms a generation of ASYNC_GENS eager steps with no write, then with an
    AsyncCheckpointWriter write of the state submitted just before them,
    twice: the first write allocates the writer's pinned host buffers, the
    second reuses them (whether each was still in flight when the
    generations ended is reported); and each write's seconds."""
    import torch
    from evox_tpu_torch.utils import AsyncCheckpointWriter

    def gens(s):
        for _ in range(ASYNC_GENS):
            s = wf.step(s)
        return s

    idle_ms, idle_host_ms, _ = timed(lambda: gens(state), ASYNC_GENS)
    row = {"gens": ASYNC_GENS, "ms_per_gen_no_write": idle_ms, "host_ms_per_gen_no_write": idle_host_ms}
    writer = AsyncCheckpointWriter(durable=True)
    for write in ("first_write", "second_write"):
        t0 = time.perf_counter()
        writer.submit(path, state, generation=CKPT_GENS // 2)
        busy_ms, busy_host_ms, _ = timed(lambda: gens(state), ASYNC_GENS)
        in_flight = not writer.barrier(timeout=0)
        if not writer.barrier(timeout=600) or writer.pop_errors():
            raise AssertionError(f"the async checkpoint write ({write}) failed")
        row[write] = {"ms_per_gen_write_in_flight": busy_ms, "host_ms_per_gen_write_in_flight": busy_host_ms,
                      "write_s": time.perf_counter() - t0, "write_in_flight_after_the_gens": in_flight}
    writer.close()
    torch.cuda.synchronize()
    return row


def phase_checkpoint_main_path(device) -> dict:
    """The checkpoint plane on the card, in a temporary directory removed
    afterwards: save_state (durable), verify_checkpoint and load_state of
    the PSO headline's state after 10 generations (seconds and GB/s each),
    a resume from the loaded state to 20 generations equal to the
    uninterrupted 20-generation run bit for bit; the same for
    pso_northstar_bf16's state (PSO in bfloat16: ``__bf16__/`` entries),
    whose float32 template is refused; the PSO headline under
    PrecisionPolicy() (bfloat16 storage) saved with its policy's tag, whose
    load under no policy (float32) ``check_precision`` refuses; and the
    async writer's cost to the generations it overlaps."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.precision import PrecisionPolicy, precision_tag
    from evox_tpu_torch.utils import CheckpointError, load_state

    n, d = HEADLINE
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    out = {"card": card_line(), "directory_fs": file_system_of(root)}
    try:
        wf = pso_workflow(device, n, d)
        s = wf.init_step(wf.init(0))
        for _ in range(CKPT_GENS // 2 - 1):
            s = wf.step(s)
        ref = s
        for _ in range(CKPT_GENS - CKPT_GENS // 2):
            ref = wf.step(ref)
        row, loaded = checkpoint_case(wf, s, root / "pso_headline.npz", {"precision": precision_tag(None)},
                                      precision=None, key_impl=None)
        for _ in range(CKPT_GENS - CKPT_GENS // 2):
            loaded = wf.step(loaded)
        row["resume_leaves_equal"] = same_state(loaded, ref, f"resume after {CKPT_GENS // 2} vs {CKPT_GENS} "
                                                             "uninterrupted generations")
        row["async_writer"] = async_writer_cost(wf, s, root / "pso_headline_async.npz")
        out["pso_headline"] = row
        del wf, s, ref, loaded
        (root / "pso_headline.npz").unlink()
        (root / "pso_headline_async.npz").unlink()
        torch.cuda.empty_cache()

        wf = pso_workflow(device, n, d, dtype=torch.bfloat16)
        s = wf.step(wf.init_step(wf.init(0)))
        row, _ = checkpoint_case(wf, s, root / "pso_bf16.npz", None)
        try:
            load_state(root / "pso_bf16.npz", pso_workflow(device, n, d).init(1))
        except CheckpointError as e:
            row["float32_template_refused"] = str(e)[:200]
        else:
            raise AssertionError("a bfloat16 archive loaded into a float32 template")
        out["pso_northstar_bf16"] = row
        del wf, s
        (root / "pso_bf16.npz").unlink()
        torch.cuda.empty_cache()

        policy = PrecisionPolicy()
        wf = pso_workflow(device, n, d, precision=policy)
        s = wf.step(wf.init_step(wf.init(0)))
        row, _ = checkpoint_case(wf, s, root / "pso_policy.npz", {"precision": precision_tag(policy)},
                                 precision=policy)
        try:
            load_state(root / "pso_policy.npz", wf.init(1), precision=None)
        except CheckpointError as e:
            row["float32_policy_refused"] = str(e)[:200]
        else:
            raise AssertionError("check_precision let a bfloat16-storage archive load under float32")
        out["pso_policy_bf16_storage"] = row
        del wf, s
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- the resilient runner (ResilientRunner over fused segments) -------------------

RESILIENT_SMALL = (1024, 100)  # bench.py's pso_small_resilient: PSO(1024, ±32 in dim 100), Ackley
RESILIENT_GENS, RESILIENT_EVERY = 100, 25
HEADLINE_RUNNER_GENS, HEADLINE_RUNNER_EVERY = 50, 25
RECOVERY_GENS = 60
NE_RESILIENT_GENS, NE_RESILIENT_EVERY = 30, 10
QUICKSTART_RUNNER = (64, 16, 100, 25)  # README: PSO(64, ±32 in dim 16), Ackley, 100 generations, every 25
FAST_RETRY = dict(backoff_base=0.001, backoff_factor=1.0)


def small_resilient_workflow(device, problem=None, monitor=None):
    """bench.py's pso_small_resilient workflow (no monitor, as there)."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import StdWorkflow

    n, d = RESILIENT_SMALL
    algo = PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device)
    return StdWorkflow(algo, problem if problem is not None else Ackley(), monitor=monitor)


def runner_stats(runner) -> dict:
    s = runner.stats
    return {
        "segments": s.segments_run, "chunks": s.chunk_sizes, "retries": s.retries,
        "watchdog_timeouts": s.watchdog_timeouts, "cpu_fallbacks": s.cpu_fallbacks,
        "checkpoints_written": s.checkpoints_written, "checkpoint_block_s": s.checkpoint_block_seconds,
        "resumed_from": s.resumed_from_generation, "restarts": [e.to_manifest() for e in s.restarts],
        "skips": [(Path(k.path).name, k.quarantined) for k in s.checkpoint_skips],
        "segment_timings": [t._asdict() for t in s.segment_timings],
    }


def no_cpu_fallback(runner, what):
    if runner.stats.cpu_fallbacks != 0:
        raise AssertionError(f"{what}: {runner.stats.cpu_fallbacks} CPU fallbacks")


def thread_syncs(fn) -> tuple[object, dict]:
    """``fn()`` and the host syncs it made, by thread: under
    ``torch.cuda.set_sync_debug_mode("warn")`` every synchronizing CUDA
    call (a copy to the host, a stream or device synchronize) warns in the
    thread that made it, so the calling thread's count leaves out the
    checkpoint writer's thread."""
    import threading
    import warnings

    import torch

    me = threading.get_ident()
    seen: list[int] = []

    def show(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            seen.append(threading.get_ident())

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, {"calling_thread": seen.count(me), "other_threads": len(seen) - seen.count(me)}


def quiet_run(runner, state, n, **kw):
    """``runner.run`` with its warnings (the supervisor's retry and restart
    lines) kept out of the log."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return runner.run(state, n, **kw)


def phase_resilient_main_path(device) -> dict:
    """pso_small_resilient (bench.py:247) through ResilientRunner(fused=True)
    on the card, in a temporary directory: the counted (cold) run captures
    the segments of 25 and 24 generations; a warm fresh run is timed and
    one more profiled (host syncs of the calling thread: one a segment,
    plus one read of the key's stream family); the final state equals
    run(100) and 100 eager steps bit for bit.  Then the PSO headline (100k
    x 1000, Sphere) under the runner with a HealthProbe and
    RollbackToCheckpoint, 50 generations, checkpoint_every=25,
    keep_checkpoints=2 (1.2 GB archives), equal to run(50) bit for bit,
    with the share of the wall time the checkpoint writer blocked the
    loop."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.resilience import HealthProbe, ResilientRunner, RollbackToCheckpoint

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_runner_"))
    out = {"card": card_line(), "directory_fs": file_system_of(root)}
    try:
        wf = small_resilient_workflow(device)
        reset_move_counters()
        runner = ResilientRunner(wf, root / "small", checkpoint_every=RESILIENT_EVERY)
        cold = runner.run(wf.init(0), RESILIENT_GENS, fresh=True)
        torch.cuda.synchronize()
        launches = {"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches}
        # A warm-up generation and the captured ones of the segments of 25
        # and 24 (init_step moves nothing; the two replays of 25 launch
        # nothing).
        expect(launches["fused_pso_move"], 26 + 25, "pso_small_resilient: PSO moves of the cold run")
        no_cpu_fallback(runner, "pso_small_resilient")
        cold_stats = runner_stats(runner)

        s0 = wf.init(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = ResilientRunner(wf, root / "small", checkpoint_every=RESILIENT_EVERY)
        final = warm.run(s0, RESILIENT_GENS, fresh=True)
        torch.cuda.synchronize()
        runner_ms = (time.perf_counter() - t0) * 1e3 / RESILIENT_GENS
        if any(t.compile_seconds for t in warm.stats.segment_timings):
            raise AssertionError("the warm runner captured a segment again")
        same_state(final, cold, "pso_small_resilient: warm vs cold runner")
        timed(lambda: wf.run(wf.init(0), RESILIENT_GENS), RESILIENT_GENS)  # its capture of 99
        run_ms, run_host_ms, ref = timed(lambda: wf.run(wf.init(0), RESILIENT_GENS), RESILIENT_GENS)
        same_state(final, ref, "pso_small_resilient: runner vs run(100)")
        eager_ms, eager_host_ms, eager = timed(lambda: _steps(wf, wf.init_step(wf.init(0)), RESILIENT_GENS - 1),
                                               RESILIENT_GENS)
        same_state(final, eager, "pso_small_resilient: runner vs 100 eager steps")

        prof_runner = ResilientRunner(wf, root / "small", checkpoint_every=RESILIENT_EVERY)
        s0 = wf.init(0)
        _, syncs = thread_syncs(lambda: prof_runner.run(s0, RESILIENT_GENS, fresh=True))
        want = prof_runner.stats.segments_run + 1
        if syncs["calling_thread"] != want:
            raise AssertionError(f"pso_small_resilient: host syncs {syncs} of the calling thread, expected {want} "
                                 f"(one a segment and one read of the key's stream family)")
        out["pso_small_resilient"] = {
            "config": "PSO(1024, ±32 in dim 100), Ackley, ResilientRunner(checkpoint_every=25, fused=True), "
                      "100 generations",
            "launches": launches, "cold_run": cold_stats, "warm_run": runner_stats(warm),
            "ms_per_gen": {"runner_wall": runner_ms, "run_event": run_ms, "run_host": run_host_ms,
                           "eager_event": eager_ms, "eager_host": eager_host_ms},
            "host_syncs": syncs, "host_syncs_per_segment": syncs["calling_thread"] / prof_runner.stats.segments_run,
        }
        del wf, cold, final, ref, eager
        torch.cuda.empty_cache()

        n, d = HEADLINE
        wf = pso_workflow(device, n, d)
        reset_move_counters()
        s0 = wf.init(0)
        runner = ResilientRunner(wf, root / "headline", checkpoint_every=HEADLINE_RUNNER_EVERY, keep_checkpoints=2,
                                 health=HealthProbe(), restart=RollbackToCheckpoint())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run(s0, HEADLINE_RUNNER_GENS, fresh=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        head_launches = {"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches}
        no_cpu_fallback(runner, "headline runner")
        if runner.stats.restarts or runner.stats.unhealthy_probes:
            raise AssertionError(f"headline runner: {runner.stats.unhealthy_probes} unhealthy verdicts")
        files = sorted(p.name for p in (root / "headline").iterdir())
        expect(files, ["ckpt_00000026.npz", "ckpt_00000050.npz"], "headline runner: kept checkpoints")
        archive_gb = (root / "headline" / "ckpt_00000050.npz").stat().st_size / 1e9
        del s0
        ref = wf.run(wf.init(0), HEADLINE_RUNNER_GENS)
        same_state(final, ref, "headline runner vs run(50)")
        out["pso_headline_runner"] = {
            "config": "PSO(100k, ±10 in dim 1000), Sphere, ResilientRunner(checkpoint_every=25, keep_checkpoints=2, "
                      "health=HealthProbe(), restart=RollbackToCheckpoint()), 50 generations",
            "launches": head_launches, "stats": runner_stats(runner), "wall_s": wall,
            "checkpoint_block_share": runner.stats.checkpoint_block_seconds / wall,
            "archive_gb": archive_gb, "health_checks": runner.stats.health_checks,
        }
        del wf, final, ref, runner
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: out["pso_small_resilient"]["launches"][k] + out["pso_headline_runner"]["launches"][k]
                       for k in ("fused_pso_move", "philox_draws")}
    return out


def phase_resilient_recovery(device) -> dict:
    """The runner's recovery paths at pso_small_resilient's width, each
    bit-equal to its uninterrupted twin, none falling back to the CPU, in
    a temporary directory: kill after generation 50 and resume with a new
    runner; a torn newest checkpoint quarantined to ``*.corrupt``; NaN/Inf
    rows inside the captured segments counted as eager steps count them;
    an InjectedBackendError retried, and a watchdog trip from an injected
    delay (host faults: eager generations on the card); a real SIGTERM
    under preemption=True, whose emergency checkpoint the next run
    resumes.  RECOVERY_GENS generations each, segments of 25; a run
    through a FaultyProblem is held against the clean run's algorithm
    state (the wrapper adds its own problem state)."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import FaultyProblem, FaultyStore, Preempted, ResilientRunner, RetryPolicy
    from evox_tpu_torch.utils import read_manifest
    from evox_tpu_torch.workflows import EvalMonitor

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_recovery_"))
    out = {"card": card_line()}
    n = RECOVERY_GENS
    every = RESILIENT_EVERY
    try:
        wf = small_resilient_workflow(device)
        ref = ResilientRunner(wf, root / "ref", checkpoint_every=every).run(wf.init(0), n, fresh=True)

        # Kill and resume: the first runner stops after generation 50 (its
        # run's end), a new runner resumes on the same directory.
        first = ResilientRunner(wf, root / "kill", checkpoint_every=every)
        first.run(wf.init(0), 50, fresh=True)
        second = ResilientRunner(small_resilient_workflow(device), root / "kill", checkpoint_every=every)
        resumed = second.run(wf.init(0), n)
        expect(second.stats.resumed_from_generation, 50, "kill and resume: resumed from")
        out["kill_and_resume"] = {"leaves_equal": same_state(resumed, ref, "kill and resume vs uninterrupted"),
                                  "stats": runner_stats(second)}

        # A torn newest checkpoint (saves: 1, 26, 51(torn)).
        torn = ResilientRunner(wf, root / "torn", checkpoint_every=every, store=FaultyStore(torn_saves=[2]))
        torn.run(wf.init(0), 51, fresh=True)
        again = ResilientRunner(wf, root / "torn", checkpoint_every=every)
        healed = quiet_run(again, wf.init(0), n)
        expect(runner_stats(again)["skips"], [("ckpt_00000051.npz", True)], "torn checkpoint: quarantined")
        expect(again.stats.resumed_from_generation, 26, "torn checkpoint: resumed from")
        if not (root / "torn" / "ckpt_00000051.npz.corrupt").exists():
            raise AssertionError("torn checkpoint: no *.corrupt evidence")
        out["torn_newest"] = {"leaves_equal": same_state(healed, ref, "resume past a torn checkpoint"),
                              "stats": runner_stats(again)}

        # Device faults inside the captured segments.
        plan = dict(nan_generations=(5, 30, 31), nan_rows=7, inf_generations=(40,), inf_rows=3)
        fwf = small_resilient_workflow(device, FaultyProblem(Ackley(), **plan), monitor=EvalMonitor())
        if not fwf.problem.capturable:
            raise AssertionError("device faults must be capturable")
        faulted = ResilientRunner(fwf, root / "nan", checkpoint_every=every).run(fwf.init(0), n, fresh=True)
        if torch.device(device).type == "cuda" and len(fwf._graphs) == 0:
            raise AssertionError("the faulted run captured no graph")
        ewf = small_resilient_workflow(device, FaultyProblem(Ackley(), **plan), monitor=EvalMonitor())
        stepped = _steps(ewf, ewf.init_step(ewf.init(0)), n - 1)
        same_state(faulted, stepped, "NaN/Inf rows: runner vs eager steps")
        counted = int(faulted.monitor.num_nonfinite)
        expect(counted, 3 * 7 + 3, "NaN/Inf rows: num_nonfinite")
        out["nonfinite_rows"] = {"num_nonfinite": counted, "eager_num_nonfinite": int(stepped.monitor.num_nonfinite)}

        # An injected backend error, retried (a host fault: eager on the card).
        ewf = small_resilient_workflow(device, FaultyProblem(Ackley(), error_generations=(33,), error_times=2))
        retried_runner = ResilientRunner(ewf, root / "err", checkpoint_every=every, retry=RetryPolicy(**FAST_RETRY))
        retried = quiet_run(retried_runner, ewf.init(0), n, fresh=True)
        if retried.algorithm.pop.device.type != torch.device(device).type or len(ewf._graphs) != 0:
            raise AssertionError("the host-fault run left the card or captured a graph")
        expect(retried_runner.stats.retries, 2, "injected error: retries")
        out["backend_error_retried"] = {"leaves_equal": same_state(retried.algorithm, ref.algorithm, "retried error vs clean run"),
                                        "stats": runner_stats(retried_runner)}

        # A watchdog trip from an injected delay.
        dwf = small_resilient_workflow(device, FaultyProblem(Ackley(), delay_generations=(28,), delay_seconds=1.5))
        dog = ResilientRunner(dwf, root / "dog", checkpoint_every=every, watchdog_timeout=1.0,
                              retry=RetryPolicy(**FAST_RETRY))
        tripped = quiet_run(dog, dwf.init(0), n, fresh=True)
        if dog.stats.watchdog_timeouts < 1:
            raise AssertionError("the injected delay tripped no watchdog")
        out["watchdog_trip"] = {"leaves_equal": same_state(tripped.algorithm, ref.algorithm, "watchdog retry vs clean run"),
                                "stats": runner_stats(dog)}

        # A real SIGTERM under preemption=True.
        swf = small_resilient_workflow(device, FaultyProblem(Ackley(), sigterm_generations=(37,)))
        pre = ResilientRunner(swf, root / "term", checkpoint_every=every, preemption=True)
        try:
            quiet_run(pre, swf.init(0), n, fresh=True)
        except Preempted as e:
            caught = e
        else:
            raise AssertionError("the SIGTERM preempted nothing")
        manifest = read_manifest(caught.checkpoint)
        if not manifest.get("preempted"):
            raise AssertionError("the emergency checkpoint is not marked preempted")
        post = ResilientRunner(swf, root / "term", checkpoint_every=every, preemption=True)
        finished = quiet_run(post, swf.init(0), n)
        if not post.stats.resumed_after_preemption:
            raise AssertionError("the resumed run did not start from the emergency checkpoint")
        out["sigterm"] = {"preempted_at": caught.generation, "reason": caught.reason,
                          "leaves_equal": same_state(finished.algorithm, ref.algorithm, "SIGTERM resume vs uninterrupted"),
                          "stats": runner_stats(post)}
        for r in (second, again, retried_runner, dog, pre, post):
            no_cpu_fallback(r, "recovery")
        out["cpu_fallbacks"] = 0
        del wf, fwf, ewf, dwf, swf
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_neuroevolution_resilient(device) -> dict:
    """bench.py's neuroevolution_resilient (:1093): OpenES 2048 on cart-pole
    T = 200, MLP 4-32-32-1, under ResilientRunner(checkpoint_every=10) for
    30 generations, bit-equal to 30 eager steps; the rollouts' graphs are
    taken inline into the segments' captures.  The counted run captures
    the segments of 10 and 9 generations; a warm fresh run and the eager
    steps are timed."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.resilience import ResilientRunner

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ne_runner_"))
    counters = ne_counters()
    try:
        wf, _ = neuroevolution_workflow(device)
        for c in counters.values():
            c.launches = 0
        runner = ResilientRunner(wf, root, checkpoint_every=NE_RESILIENT_EVERY)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run(wf.init(0), NE_RESILIENT_GENS, fresh=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        no_cpu_fallback(runner, "neuroevolution_resilient")
        # A warm run: the segments' graphs (with the rollouts inline) are
        # captured.
        s0 = wf.init(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = ResilientRunner(wf, root, checkpoint_every=NE_RESILIENT_EVERY)
        again = warm.run(s0, NE_RESILIENT_GENS, fresh=True)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        same_state(again, final, "neuroevolution_resilient: warm vs cold runner")
        ewf, _ = neuroevolution_workflow(device)
        eager_ms, eager_host_ms, eager = timed(lambda: _steps(ewf, ewf.init_step(ewf.init(0)), NE_RESILIENT_GENS - 1),
                                               NE_RESILIENT_GENS)
        leaves = same_state(final, eager, "neuroevolution_resilient: runner vs 30 eager steps")
        out = {"config": "OpenES(2048), cartpole T=200, MLP 4-32-32-1, ResilientRunner(checkpoint_every=10), "
                         "30 generations",
               "card": card_line(), "launches": launches, "leaves_equal": leaves, "cold_wall_s": wall,
               "ms_per_gen": {"runner_cold_wall": wall * 1e3 / NE_RESILIENT_GENS,
                              "runner_warm_wall": warm_wall * 1e3 / NE_RESILIENT_GENS,
                              "eager_event": eager_ms, "eager_host": eager_host_ms},
               "cold_run": runner_stats(runner), "warm_run": runner_stats(warm)}
        for k, v in launches.items():
            if v == 0:
                raise AssertionError(f"neuroevolution_resilient: {k} never launched")
        del wf, ewf, final, eager, again
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_resilient_quickstart(device) -> dict:
    """README's runner quick start on the card: PSO(64, ±32 in dim 16),
    Ackley, ResilientRunner(checkpoint_every=25), 100 generations, run
    twice on the same directory: the second call resumes at generation 100
    and runs no segment."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import ResilientRunner
    from evox_tpu_torch.workflows import StdWorkflow

    pop, dim, gens, every = QUICKSTART_RUNNER
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_quickstart_runner_"))
    try:
        def two_lines():
            workflow = StdWorkflow(PSO(pop, -32.0 * torch.ones(dim), 32.0 * torch.ones(dim), device=device), Ackley())
            runner = ResilientRunner(workflow, root / "run1", checkpoint_every=every)
            return runner, runner.run(workflow.init(0), n_steps=gens)

        first, state = two_lines()
        second, again = two_lines()
        expect(second.stats.resumed_from_generation, gens, "quick start rerun: resumed from")
        expect(second.stats.segments_run, 0, "quick start rerun: segments run")
        leaves = same_state(again, state, "quick start rerun vs first run")
        no_cpu_fallback(first, "quick start")
        return {"card": card_line(), "first": runner_stats(first), "second": runner_stats(second),
                "leaves_equal": leaves, "best_fitness": float(state.algorithm.global_best_fit)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- the control plane and the HPO runner (Controller, HPORunner, GrowthLadder) ---

HPO_RUNNER_GENS, HPO_RUNNER_EVERY = 16, 4
HPO_SIGTERM_AFTER = 5  # the SIGTERM follows the publish of this generation's checkpoint
HPO_GROW_MAX = 2048
# A tolerance at which the first consult grows: any finite slope projects
# less improvement than this (the deciders' thresholds are held on the CPU).
HPO_GROW_TOL = 1e30
HPO_GROW_CUT = 9  # the cut run of the resume across a growth stops at this boundary
CONTROL_GENS, CONTROL_EVERY = 100, 25
CONTROL_TARGET_GENS = 6  # target_seconds: the measured execute time of this many generations
TREND_GENS, TREND_EVERY = 41, 4
SCRAPE_PATHS = ("/metrics", "/healthz", "/flightz/hpo_ladder")
SCRAPE_PAUSE_S = 0.01  # between two rounds of the scraper (it shares the interpreter with the runner)


def pool_bytes(pools) -> dict | None:
    """Bytes of the card's memory segments in the private pools ``pools``
    (a set of pool ids): in all, and in blocks still allocated
    (``torch.cuda.memory_snapshot``, host-side allocator state); ``None``
    when the snapshot names no pools."""
    import torch

    total = active = 0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        if tuple(seg["segment_pool_id"]) in pools:
            total += int(seg["total_size"])
            active += sum(int(b["size"]) for b in seg.get("blocks", ()) if b.get("state") != "inactive")
    return {"total": total, "active": active}


def graph_pool_bytes(cache) -> int | None:
    """Bytes of the card's memory segments in a graph cache's private pool
    (0 when it captured nothing); ``None`` when the snapshot names no
    pools."""
    if cache.pool is None:
        return 0
    got = pool_bytes({tuple(cache.pool)})
    return None if got is None else got["total"]


def gb(nbytes) -> float | None:
    return None if nbytes is None else nbytes / 1e9


def memory_now() -> dict:
    import torch

    torch.cuda.synchronize()
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9, "reserved_gb": torch.cuda.memory_reserved() / 1e9}


@contextlib.contextmanager
def scraping(url, paths):
    """A thread that GETs ``paths`` of an introspection endpoint in turn
    while the block runs; yields its tally (requests, failures by path,
    the first errors)."""
    import threading
    import urllib.request

    tally = {"requests": 0, "failed": 0, "by_path": {p: 0 for p in paths}, "errors": []}
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for p in paths:
                try:
                    with urllib.request.urlopen(url + p, timeout=10) as resp:
                        resp.read()
                        ok = resp.status == 200
                except Exception as e:  # noqa: BLE001 - tallied as a failed scrape
                    ok = False
                    if len(tally["errors"]) < 5:
                        tally["errors"].append(f"{p}: {type(e).__name__}: {e}")
                tally["requests"] += 1
                tally["by_path"][p] += 1
                tally["failed"] += 0 if ok else 1
            stop.wait(SCRAPE_PAUSE_S)

    thread = threading.Thread(target=loop, name="chip-smoke-scraper", daemon=True)
    thread.start()
    try:
        yield tally
    finally:
        stop.set()
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("the scraper thread did not stop")


def runner_endpoint(plane, holder, run_id):
    """An IntrospectionEndpoint over a runner's obs plane: its registry
    (the allocator gauges are values the runner thread sets at
    boundaries), the runner's last HealthReport and the flight ring —
    host-side values only, never the card."""
    from evox_tpu_torch.obs import IntrospectionEndpoint

    def healthz():
        runner = holder.get("runner")
        report = None if runner is None else runner.stats.last_report
        if report is None:
            return True, {"generation": None}
        return report.healthy, {"generation": report.generation, "reasons": list(report.reasons)}

    return IntrospectionEndpoint(
        registry=plane.registry, instrument=plane.registry, healthz=healthz,
        flight=lambda rid: plane.flight.rows() if rid == run_id else None,
        statusz=lambda: {"completed_generations": holder["runner"].stats.completed_generations
                         if holder.get("runner") else 0},
    ).start()


def boundary_series(wf, boundaries) -> dict:
    """The twin's per-candidate series at each boundary: eager steps of
    ``wf`` from ``init(0)``, ``candidate_series`` of the nest's telemetry
    read at the generations the runner probes."""
    from evox_tpu_torch.hpo import candidate_series

    s = wf.init_step(wf.init(0))
    out: dict = {}
    gen = 1
    for b in boundaries:
        while gen < b:
            s = wf.step(s)
            gen += 1
        for uid, series in candidate_series(s.problem).items():
            out.setdefault(uid, []).append((b, [float(v) for v in series]))
    return out, s


def phase_hpo_runner_main_path(device) -> dict:
    """bench.py's hpo_ladder (``hpo_ladder_workflow``) under
    HPORunner(checkpoint_every=4, fused=True) for 16 outer generations, in a
    temporary directory, with an IntrospectionEndpoint on the runner's
    registry, health and flight ring for the whole phase and a scraper
    thread GETting /metrics, /healthz and /flightz across the first
    captures (every scrape answered, no capture error).  The counted
    (cold) run captures the nest's evaluation (init_step) and the outer
    segments of 4 and 3 generations (the nest inline); its final state
    equals run(16) and 16 eager steps bit for bit, its candidate_history
    the twin's telemetry at the boundaries, and
    evox_hpo_inner_generations_total 16 x 64 x 32.  A warm fresh run is
    timed against run(16) and one more counts the calling thread's host
    syncs (a segment: the runner's one read, the nest's series and uids
    folded in, and the health probe's; a run: one read of the key's stream
    family).  Then a SIGTERM under preemption=True after the checkpoint of
    generation 5 is published (the run stops at the next boundary, 9) and
    a fresh runner resumes: bit-equal, candidate_history equal."""
    import os
    import shutil
    import signal
    import tempfile

    import torch
    from evox_tpu_torch.hpo import HPORunner
    from evox_tpu_torch.obs import FlightRecorder, MetricsRegistry, Observability, Tracer
    from evox_tpu_torch.resilience import Preempted

    c, n, every = HPO_LADDER, HPO_RUNNER_GENS, HPO_RUNNER_EVERY
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_hpo_runner_"))
    out = {"card": card_line(), "directory_fs": file_system_of(root),
           "config": f"PSO({c['candidates']}) over NestedProblem(OpenES({c['inner_pop']}, zeros({c['dim']}), lr 0.05, "
                     f"sigma 0.1), Sphere, iterations={c['iterations']}), prng=uid, under "
                     f"HPORunner(checkpoint_every={every}, fused=True), {n} outer generations"}
    counters = hpo_counters()
    holder: dict = {}
    try:
        wf = hpo_ladder_workflow(device)
        plane = Observability(registry=MetricsRegistry(), flight=FlightRecorder(root / "flight", window=64),
                              run_id="hpo_ladder")
        endpoint = runner_endpoint(plane, holder, "hpo_ladder")
        try:
            with scraping(endpoint.url, SCRAPE_PATHS) as tally:
                for k in counters.values():
                    k.launches = 0
                s0 = wf.init(0)
                runner = holder["runner"] = HPORunner(wf, root / "cold", checkpoint_every=every, obs=plane)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cold = runner.run(s0, n, fresh=True)
                torch.cuda.synchronize()
                cold_wall = time.perf_counter() - t0
                launches = counts(counters)
                for k, v in launches.items():
                    if k != "fused_pso_move_batched":
                        expect(v > 0, True, f"hpo_runner_main_path: {k} launched")
                no_cpu_fallback(runner, "hpo_runner_main_path")
                cold_stats = runner_stats(runner)
                expect([t["compile_seconds"] > 0 for t in cold_stats["segment_timings"]],
                       [False, True, False, False, True], "hpo_runner_main_path: captured segments (4 and 3)")

                ref = wf.run(wf.init(0), n)
                leaves = same_state(cold, ref, "hpo_runner_main_path: runner vs run(16)")
                boundaries = [1] + list(range(1 + every, n, every)) + [n]
                twin, eager = boundary_series(wf, boundaries)
                same_state(cold, eager, "hpo_runner_main_path: runner vs 16 eager steps")
                expect(runner.candidate_history, twin, "hpo_runner_main_path: candidate_history vs the twin's telemetry")
                inner = plane.registry.snapshot()["evox_hpo_inner_generations_total"]
                expect(inner, float(n * c["candidates"] * c["iterations"]), "evox_hpo_inner_generations_total")
                del ref, eager

                # Warm runs: every graph is captured.
                s0 = wf.init(0)
                warm = holder["runner"] = HPORunner(wf, root / "warm", checkpoint_every=every, obs=plane)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                final = warm.run(s0, n, fresh=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if any(t.compile_seconds for t in warm.stats.segment_timings):
                    raise AssertionError("hpo_runner_main_path: the warm runner captured a segment again")
                same_state(final, cold, "hpo_runner_main_path: warm vs cold runner")
                run_ms, run_host_ms, _ = timed(lambda: wf.run(wf.init(0), n), n)
                archive = sorted((root / "warm").glob("ckpt_*.npz"))[-1]
                snap = plane.registry.snapshot()
                s0 = wf.init(0)
                prof = holder["runner"] = HPORunner(wf, root / "prof", checkpoint_every=every, obs=plane)
                _, syncs = thread_syncs(lambda: prof.run(s0, n, fresh=True))
                segments = prof.stats.segments_run
                per_segment = (syncs["calling_thread"] - 1) / segments
                if per_segment > 2:
                    raise AssertionError(f"hpo_runner_main_path: host syncs {syncs} of the calling thread over "
                                         f"{segments} segments, more than 2 a segment and the key's one read")

                # SIGTERM after the checkpoint of generation 5 is published.
                def on_event(msg):
                    if msg == f"checkpoint written at generation {HPO_SIGTERM_AFTER}":
                        os.kill(os.getpid(), signal.SIGTERM)

                term = holder["runner"] = HPORunner(wf, root / "term", checkpoint_every=every, obs=plane,
                                                    preemption=True, on_event=on_event)
                try:
                    quiet_run(term, wf.init(0), n, fresh=True)
                except Preempted as e:
                    caught = e
                else:
                    raise AssertionError("hpo_runner_main_path: the SIGTERM preempted nothing")
                post = holder["runner"] = HPORunner(wf, root / "term", checkpoint_every=every, obs=plane,
                                                    preemption=True)
                resumed = quiet_run(post, wf.init(0), n)
                if not post.stats.resumed_after_preemption:
                    raise AssertionError("hpo_runner_main_path: the resume did not start from the emergency checkpoint")
                term_leaves = same_state(resumed, cold, "hpo_runner_main_path: SIGTERM resume vs uninterrupted")
                expect(post.candidate_history, runner.candidate_history,
                       "hpo_runner_main_path: candidate_history after the re-ingest")
        finally:
            endpoint.stop()
        if tally["failed"] or tally["requests"] < len(SCRAPE_PATHS):
            raise AssertionError(f"hpo_runner_main_path: scrapes {tally}")
        # A warm run with no scraper and a tracer: the boundary's spans.
        traced = Observability(registry=MetricsRegistry(), flight=FlightRecorder(root / "flight2", window=64),
                               tracer=Tracer(), run_id="hpo_ladder")
        s0 = wf.init(0)
        quiet = HPORunner(wf, root / "quiet", checkpoint_every=every, obs=traced)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        same_state(quiet.run(s0, n, fresh=True), cold, "hpo_runner_main_path: traced run vs cold runner")
        torch.cuda.synchronize()
        quiet_wall = time.perf_counter() - t0
        spans: dict = {}
        for sp in traced.tracer.spans():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.dur_us / 1e3
        for r in (runner, warm, prof, term, post):
            no_cpu_fallback(r, "hpo_runner_main_path")
        out.update({
            "launches": launches, "leaves_equal": leaves, "cold_wall_s": cold_wall, "cold_run": cold_stats,
            "warm_run": runner_stats(warm),
            "ms_per_outer_gen": {"runner_wall": wall * 1e3 / n, "runner_wall_no_scrapes": quiet_wall * 1e3 / n,
                                 "run_event": run_ms, "run_host": run_host_ms},
            "span_ms_no_scrapes": spans,
            "writer_block_share": warm.stats.checkpoint_block_seconds / wall,
            "checkpoint_mb": archive.stat().st_size / 1e6,
            "checkpoint_write_s_mean": snap["evox_checkpoint_write_seconds_sum"]
            / max(snap["evox_checkpoint_write_seconds_count"], 1.0),
            "checkpoint_writes": snap["evox_checkpoint_write_seconds_count"],
            "host_syncs": syncs, "segments": segments, "host_syncs_per_segment": per_segment,
            "inner_generations_total": inner, "candidate_history_uids": len(runner.candidate_history),
            "sigterm": {"preempted_at": caught.generation, "reason": caught.reason, "leaves_equal": term_leaves,
                        "resumed_from": post.stats.resumed_from_generation},
            "scrapes": tally, "nest_graph_pool_gb": gb(graph_pool_bytes(wf.problem._graphs)),
            "segment_graph_pool_gb": gb(graph_pool_bytes(wf._graphs)),
            "captures": wf._graphs.captures + wf.problem._graphs.captures,
        })
        del wf, cold, final, resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def hpo_grow_runner(device, directory, plane, journal=None):
    """hpo_ladder under HPORunner with the growth ladder (OpenES regrown to
    2048 at most, window 8, ``HPO_GROW_TOL``) and a Controller(grace=4)."""
    import torch
    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.hpo import GrowthLadder, HPORunner

    def inner_factory(pop):
        return OpenES(pop, torch.zeros(HPO_LADDER["dim"]), learning_rate=0.05, noise_stdev=0.1, device=device)

    wf = hpo_ladder_workflow(device)
    ladder = GrowthLadder(inner_factory=inner_factory, stagnation_window=8, stagnation_tol=HPO_GROW_TOL,
                          max_inner_pop=HPO_GROW_MAX)
    runner = HPORunner(wf, directory, checkpoint_every=HPO_RUNNER_EVERY, grow=ladder,
                       controller=Controller(journal=journal, grace=4), obs=plane)
    return wf, runner


def phase_hpo_grow(device) -> dict:
    """hpo_ladder with grow=GrowthLadder(OpenES(pop, zeros(32), lr 0.05,
    sigma 0.1), stagnation_window=8, max_inner_pop=2048) and
    Controller(journal=RequestJournal(...), grace=4), 16 outer
    generations.  The tolerance is one at which the first consult grows
    (``HPO_GROW_TOL``; the decider's thresholds are held on the CPU by
    tests/test_torch_control.py): the inner population goes 1024 -> 2048
    at the first boundary, the outer algorithm's leaves untouched by the
    growth, the journal replaying to the same decisions; the memory before
    the growth (the 1024 ladder's graphs alive) and after the run (the
    2048 ladder's), the graph caches the growth replaced gone (no block
    of their pools allocated, no segment left after empty_cache), the
    recapture's seconds, and ms per outer generation at 2048.  Then a run cut at boundary 9 and a fresh runner on a fresh
    workflow resume across the growth, bit-equal to the uninterrupted
    run."""
    import gc
    import shutil
    import tempfile
    import weakref

    import torch
    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.hpo import find_nested
    from evox_tpu_torch.obs import MetricsRegistry, Observability
    from evox_tpu_torch.service import RequestJournal

    n = HPO_RUNNER_GENS
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_hpo_grow_"))
    counters = hpo_counters()
    out = {"card": card_line(), "directory_fs": file_system_of(root), "stagnation_tol": HPO_GROW_TOL}
    try:
        plane = Observability(registry=MetricsRegistry(), run_id="hpo_grow")
        journal = RequestJournal(root / "decisions.jsonl", registry=plane.registry)
        for k in counters.values():
            k.launches = 0
        wf, runner = hpo_grow_runner(device, root / "grow", plane, journal)
        nest_1024 = wf.problem
        policy = runner.restart
        apply = policy.apply
        growth: dict = {}

        replaced: dict = {}  # the caches the growth replaces: weak references and pool ids only

        def measured_apply(ctx):
            growth["memory_before"] = {**memory_now(), "segment_pool_gb": gb(graph_pool_bytes(wf._graphs)),
                                       "nest_pool_gb": gb(graph_pool_bytes(nest_1024._graphs))}
            for name, cache in (("outer_segments", wf._graphs), ("nest", nest_1024._graphs)):
                replaced[name] = (weakref.ref(cache), None if cache.pool is None else tuple(cache.pool))
            result = apply(ctx)
            growth["outer_leaves_untouched"] = same_state(result[0].algorithm, ctx.state.algorithm,
                                                          "hpo_grow: the outer algorithm across the growth")
            growth["generation"] = ctx.generation
            return result

        policy.apply = measured_apply
        s0 = wf.init(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = quiet_run(runner, s0, n, fresh=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(counters)
        for k, v in launches.items():
            if k != "fused_pso_move_batched":
                expect(v > 0, True, f"hpo_grow: {k} launched")
        no_cpu_fallback(runner, "hpo_grow")
        events = [e.to_manifest() for e in runner.stats.restarts]
        expect([(e["policy"], e["detail"]["inner_pop"], e["detail"]["grown"]) for e in events],
               [("hpo-grow", HPO_GROW_MAX, True)], "hpo_grow: the growths")
        expect(find_nested(wf.problem).inner_pop, HPO_GROW_MAX, "hpo_grow: the inner population")
        expect(tuple(final.problem.instances.algorithm.fit.shape), (HPO_LADDER["candidates"], HPO_GROW_MAX),
               "hpo_grow: the grown instances' fitness")
        decisions = [d.to_manifest() for d in runner.controller.decisions]
        records, damage = journal.replay()
        expect(damage, None, "hpo_grow: journal damage")
        expect([d.to_manifest() for d in Controller.replay_decisions(records)], decisions, "hpo_grow: replayed decisions")
        # The recapture: the first segment after the growth.
        after = [t for t in runner.stats.segment_timings if t.generation > growth["generation"]]
        recapture_s = after[0].compile_seconds
        # The replaced caches (their graphs, output leaves and static input
        # buffers) are gone once the cycle collector has run; their pools
        # hold no allocated block then and no segment after empty_cache.
        gc.collect()
        alive = [name for name, (ref, _) in replaced.items() if ref() is not None]
        expect(alive, [], "hpo_grow: graph caches that outlive the growth")
        pools = {pool for _, pool in replaced.values() if pool is not None}
        held = pool_bytes(pools)
        growth["memory_after"] = {**memory_now(), "segment_pool_gb": gb(graph_pool_bytes(wf._graphs)),
                                  "nest_pool_gb": gb(graph_pool_bytes(wf.problem._graphs)),
                                  "replaced_pools": sorted(name for name, (_, p) in replaced.items() if p),
                                  "replaced_pools_gb": None if held is None else gb(held["total"]),
                                  "replaced_pools_allocated_gb": None if held is None else gb(held["active"])}
        torch.cuda.empty_cache()
        released = pool_bytes(pools)
        growth["memory_after_empty_cache"] = {**memory_now(),
                                              "replaced_pools_gb": None if released is None else gb(released["total"])}
        if held is not None and (held["active"] or released["total"]):
            raise AssertionError(f"hpo_grow: the replaced pools hold {held['active']} bytes allocated, "
                                 f"{released['total']} bytes after empty_cache")
        timed(lambda: wf.run(final, 8, init=False), 8)  # its capture
        grown_ms, grown_host_ms, _ = timed(lambda: wf.run(final, 8, init=False), 8)
        snap = plane.registry.snapshot()
        append_s = snap.get("evox_journal_append_seconds_sum", 0.0) / max(snap.get("evox_journal_append_seconds_count", 0.0), 1.0)

        # Resume across the growth: a cut run, then a fresh runner on a
        # fresh workflow (the grown template rebuilt from the lineage).
        _, cut = hpo_grow_runner(device, root / "cut", Observability(registry=MetricsRegistry(), run_id="cut"))
        quiet_run(cut, cut.workflow.init(0), HPO_GROW_CUT, fresh=True)
        wf2, fresh = hpo_grow_runner(device, root / "cut", Observability(registry=MetricsRegistry(), run_id="cut2"))
        resumed = quiet_run(fresh, wf2.init(0), n)
        expect(fresh.stats.resumed_from_generation, HPO_GROW_CUT, "hpo_grow: resumed from")
        expect(find_nested(wf2.problem).inner_pop, HPO_GROW_MAX, "hpo_grow: the resumed inner population")
        leaves = same_state(resumed, final, "hpo_grow: resume across the growth vs uninterrupted")
        for r in (cut, fresh):
            no_cpu_fallback(r, "hpo_grow")
        out.update({
            "launches": launches, "growth": growth, "restarts": events, "decisions": decisions,
            "recapture_s": recapture_s, "wall_s": wall, "stats": runner_stats(runner),
            "ms_per_outer_gen_at_2048": {"run_event": grown_ms, "run_host": grown_host_ms},
            "journal_append_s_mean": append_s, "journal_appends": snap.get("evox_journal_append_seconds_count", 0.0),
            "resume_across_growth": {"leaves_equal": leaves, "resumed_from": HPO_GROW_CUT},
        })
        del wf, wf2, final, resumed, nest_1024
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_controller_cadence(device) -> dict:
    """pso_small_resilient (PSO 1024 x 100, Ackley, checkpoint_every=25, 100
    generations) controller-off, then under Controller(target_seconds=the
    measured execute time of CONTROL_TARGET_GENS generations,
    overhead_cap=0.5, journal=...) on a fresh workflow: the chunk sequence,
    the cadence decisions (journaled, replayed), the captures of the run
    (at most its distinct segment lengths; the graph cache keeps them all),
    the pool's bytes, and the final state bit-equal to the controller-off
    run.  Then a trend restart at the same width: a plateau (fitness
    clamped to 1e6, a NaN burst at generation 3) under
    Controller(stagnation_window=16, journal=...), a probe whose own
    stagnation window is longer, RollbackToCheckpoint and segments of 4:
    a journaled trend restart fires and the run completes."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.obs import FlightRecorder, MetricsRegistry, Observability
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import FaultyProblem, HealthProbe, ResilientRunner, RollbackToCheckpoint
    from evox_tpu_torch.service import RequestJournal
    from evox_tpu_torch.workflows import EvalMonitor

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_cadence_"))
    out = {"card": card_line(), "directory_fs": file_system_of(root)}
    try:
        off_wf = small_resilient_workflow(device)
        off = ResilientRunner(off_wf, root / "off", checkpoint_every=CONTROL_EVERY)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = off.run(off_wf.init(0), CONTROL_GENS, fresh=True)
        torch.cuda.synchronize()
        off_wall = time.perf_counter() - t0
        per_gen = min(t.execute_seconds / max(c, 1) for t, c in zip(off.stats.segment_timings[1:],
                                                                      off.stats.chunk_sizes))
        target = CONTROL_TARGET_GENS * per_gen
        reg = MetricsRegistry()
        journal = RequestJournal(root / "cadence.jsonl", registry=reg)
        ctl = Controller(target_seconds=target, overhead_cap=0.5, journal=journal)
        wf = small_resilient_workflow(device)
        runner = ResilientRunner(wf, root / "on", checkpoint_every=CONTROL_EVERY, controller=ctl,
                                 obs=Observability(registry=reg, run_id="cadence"))
        reset_move_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = runner.run(wf.init(0), CONTROL_GENS, fresh=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cadence_launches = {"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches}
        leaves = same_state(final, ref, "controller_cadence: cadence run vs controller-off run")
        chunks = runner.stats.chunk_sizes
        lengths = sorted({c for c in chunks if c > 1})
        captures = wf._graphs.captures
        if captures > len(lengths):
            raise AssertionError(f"controller_cadence: {captures} captures for the segment lengths {lengths}")
        # A segment of one generation is the plain step (one move); a longer
        # one moves at its capture only, a warm-up generation and the
        # captured ones (init_step moves nothing; replays launch nothing).
        expect(cadence_launches["fused_pso_move"], chunks.count(1) + sum(n + 1 for n in lengths),
               f"controller_cadence: PSO moves of the cadence run (chunks {chunks})")
        expect(cadence_launches["philox_draws"] > 0, True, "controller_cadence: the cadence run's setup draws")
        expect(wf._graphs.max_graphs >= len(lengths), True, "controller_cadence: the graph cache holds every length")
        cadence = [d.to_manifest() for d in ctl.decisions]
        records, damage = journal.replay()
        expect(damage, None, "controller_cadence: journal damage")
        expect([d.to_manifest() for d in Controller.replay_decisions(records)], cadence,
               "controller_cadence: replayed decisions")
        snap = reg.snapshot()
        append_s = snap.get("evox_journal_append_seconds_sum", 0.0) / max(snap.get("evox_journal_append_seconds_count", 0.0), 1.0)
        segment_s = [t.execute_seconds for t in runner.stats.segment_timings[1:]]
        no_cpu_fallback(runner, "controller_cadence")
        out["cadence"] = {
            "config": f"PSO(1024, ±32 in dim 100), Ackley, ResilientRunner(checkpoint_every={CONTROL_EVERY}, "
                      f"controller=Controller(target_seconds={target:.6g}, overhead_cap=0.5)), {CONTROL_GENS} "
                      "generations",
            "per_gen_s_measured": per_gen, "target_seconds": target, "chunks": chunks, "decisions": cadence,
            "captures": captures, "distinct_lengths": lengths, "graph_cache_max": wf._graphs.max_graphs,
            "pool_gb": gb(graph_pool_bytes(wf._graphs)), "leaves_equal": leaves, "wall_s": wall,
            "launches": cadence_launches,
            "ms_per_gen_wall": wall * 1e3 / CONTROL_GENS, "off_ms_per_gen_wall": off_wall * 1e3 / CONTROL_GENS,
            "off_stats": runner_stats(off), "stats": runner_stats(runner),
            "journal_append_s_mean": append_s, "segment_execute_s_median": sorted(segment_s)[len(segment_s) // 2],
        }
        del off_wf, wf, ref, final

        # A trend restart at the same width.
        problem = FaultyProblem(Ackley(), plateau_from=0, plateau_floor=1e6, nan_generations=[3])
        twf = small_resilient_workflow(device, problem, monitor=EvalMonitor())
        plane = Observability(registry=MetricsRegistry(), flight=FlightRecorder(root / "pm", window=64), run_id="trend")
        tjournal = RequestJournal(root / "trend.jsonl")
        tctl = Controller(stagnation_window=16, journal=tjournal)
        trunner = ResilientRunner(twf, root / "trend", checkpoint_every=TREND_EVERY, obs=plane, controller=tctl,
                                  health=HealthProbe(stagnation_window=8, stagnation_tol=0.0),
                                  restart=RollbackToCheckpoint(), max_restarts=1)
        reset_move_counters()
        quiet_run(trunner, twf.init(0), TREND_GENS, fresh=True)
        torch.cuda.synchronize()
        trend_launches = {"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches}
        for k, v in trend_launches.items():
            expect(v > 0, True, f"controller_cadence: {k} launched in the trend run")
        expect(trunner.stats.completed_generations, TREND_GENS, "controller_cadence: the trend run's generations")
        restarts = [e.to_manifest() for e in trunner.stats.restarts]
        if len(restarts) != 1 or restarts[0]["detail"].get("trend") != "stagnation":
            raise AssertionError(f"controller_cadence: no trend restart fired: {restarts}")
        trecords, damage = tjournal.replay()
        expect(damage, None, "controller_cadence: trend journal damage")
        tdecisions = [d.to_manifest() for d in tctl.decisions]
        expect([d.to_manifest() for d in Controller.replay_decisions(trecords)], tdecisions,
               "controller_cadence: replayed trend decisions")
        no_cpu_fallback(trunner, "controller_cadence trend")
        out["trend_restart"] = {
            "config": f"PSO(1024, ±32 in dim 100), FaultyProblem(Ackley, plateau 1e6 from 0, NaN at 3), "
                      f"ResilientRunner(checkpoint_every={TREND_EVERY}, HealthProbe(stagnation_window=8), "
                      f"RollbackToCheckpoint, controller=Controller(stagnation_window=16)), {TREND_GENS} generations",
            "restarts": restarts, "decisions": [(d["kind"], d["action"], d["generation"]) for d in tdecisions],
            "stats": runner_stats(trunner), "launches": trend_launches,
        }
        # The kernels line's: the cadence run's and the trend run's, each
        # counted from 0 just before it (the controller-off reference run
        # is not counted).
        out["launches"] = {k: cadence_launches[k] + trend_launches[k] for k in cadence_launches}
        del twf
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# -- the service core (TenantPack, OptimizationService) ---------------------------

SERVICE_LANES, SERVICE_SEGMENT, SERVICE_GENS = 8, 25, 200  # bench.py's service_pack: 8 lanes, segments of 25
SERVICE_ES = dict(pop=1024, dim=100, center=8.0, lr=0.1, sigma=0.1)  # OpenES(1024, 8.0 in dim 100, adam) on Sphere
SERVICE_PSO_TENANTS, SERVICE_ES_TENANTS = 12, 4
SERVICE_BUDGET = 101  # init + 4 segments of 25
# The tenant-keyed chaos of the main path: uid 1 a NaN burst, uid 2 a plateau.
SERVICE_FAULTS = {1: {"nan_generations": tuple(range(3, 200)), "nan_rows": 1024},
                  2: {"plateau_from": 2, "plateau_floor": 50.0}}
SERVICE_QUICKSTART = (64, 8, 24, 8)  # README: PSO(64, ±32 in dim 8), Ackley, 24 generations, segments of 8


def service_tenant(wf, uid, device):
    """The service's fresh state of tenant ``uid`` (seed 0): ``setup`` from
    ``fold_in(key(0), uid)``, the uid as instance id and fault lane."""
    from evox_tpu_torch.service import assign_fault_lane
    from evox_tpu_torch.utils import rng

    return assign_fault_lane(wf.setup(rng.fold_in(rng.key(0, device), uid), instance_id=uid), uid)


def eager_tenant(wf, uid, device, gens):
    state = wf.init_step(service_tenant(wf, uid, device))
    for _ in range(gens):
        state = wf.step(state)
    return state


def filled_pack(wf, lanes, uids, device, early_stop=False):
    from evox_tpu_torch.service import TenantPack

    pack = TenantPack(wf, lanes, early_stop=early_stop)
    for uid in uids:
        state, _, _ = pack.init_tenant(service_tenant(wf, uid, device))
        pack.admit(state, uid)
    return pack


def batched_exact_vs_plain(states) -> dict:
    """The batched PSO move and the batched Philox draws on the pack's
    states (PSO(n, ±32 in dim d) over the lanes: 8 x (1024, 100), 8 streams
    of 102,400, on service_pack's packs) against their plain versions,
    exact (``vmapped_instances`` times them at that shape)."""
    import torch
    from evox_tpu_torch.ops import philox, pso_step

    a = states.algorithm
    n, d = a.pop.shape[-2:]
    scal = torch.stack([a.w, a.phi_p, a.phi_g], 1).float()
    lb, ub = (torch.full((d,), v, device=a.pop.device) for v in (-32.0, 32.0))
    args = (a.pop, a.velocity, a.local_best_location, a.fit, a.local_best_fit, a.global_best_location,
            lb, ub, scal, a.key)
    move = max(exact(g, w, "fused_pso_move_batched vs plain on the pack's states")
               for g, w in zip(pso_step.fused_pso_move_batched(*args, index=0),
                               pso_step.fused_pso_move_batched_plain(*args, 0)))
    draws = max(exact(g, w, "philox_draws_batched vs plain on the pack's keys")
                for g, w in zip(philox.philox_draws_batched(a.key, 0, n * d, [a.pop.dtype]),
                                philox.philox_draws_batched_plain(a.key, 0, n * d, [a.pop.dtype])))
    return {"fused_pso_move_batched": {"max_abs_err": move, "shape": list(a.pop.shape)},
            "philox_draws_batched": {"max_abs_err": draws, "streams": int(a.key.shape[0]), "numel": n * d}}


def phase_service_pack(device) -> dict:
    """bench.py's service_pack (:1236-1278) at full width: 8 x PSO(1024, ±32
    in dim 100) on Ackley, ``TenantPack(early_stop=False)``, segments of
    25: the admissions (8 setups and the single-lane init program, captured
    once), one warm segment (the capture) and 200 generations (8 replays).
    Launches counted exactly over that run: the init program's warm-up and
    capture, the segment's warm-up generation and its 25 captured ones (a
    replay calls no wrapper).  Every lane equal to the same tenant in a
    width-1 pack and to its 225 eager steps, bit for bit; per-tenant gen/s,
    ms a segment, host syncs a segment, captures, device operations a
    generation and the pool's bytes; a freeze, a thaw, a release and an
    admission recapture nothing.  Then the batched kernels against their
    plain versions at the pack's shape, and one setup's draws on the path."""
    import torch

    wf = vmapped_pso_workflow(device)
    counters = vmap_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    pack = filled_pack(wf, SERVICE_LANES, range(SERVICE_LANES), device)
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    admitted = counts(counters)
    t0 = time.perf_counter()
    pack.run_segment(SERVICE_SEGMENT)  # the warm segment: its capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    segments = SERVICE_GENS // SERVICE_SEGMENT
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(segments + 1)]
    t0 = time.perf_counter()
    starts[0].record()
    for i in range(segments):
        pack.run_segment(SERVICE_SEGMENT)
        starts[i + 1].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts(counters)
    seg_ms = [starts[i].elapsed_time(starts[i + 1]) for i in range(segments)]
    # The init program: PSO's init_step makes no move and no draw, so the
    # 8 setups' draws (solo) and the segment's warm-up + captured moves.
    per_setup = admitted["philox_draws"] // SERVICE_LANES
    expect(admitted, {"fused_pso_move": 0, "fused_pso_move_batched": 0, "philox_draws": SERVICE_LANES * per_setup,
                      "philox_draws_batched": 0}, "service_pack admissions' launches")
    expect(launches["fused_pso_move_batched"], SERVICE_SEGMENT + 1, "service_pack batched moves")
    expect({k: launches[k] - admitted[k] for k in ("fused_pso_move", "philox_draws", "philox_draws_batched")},
           {"fused_pso_move": 0, "philox_draws": 0, "philox_draws_batched": 0}, "service_pack segments' other launches")
    expect(pack.captures, {"init": 1, "segment": 1}, "service_pack captures")
    total = SERVICE_SEGMENT + SERVICE_GENS
    # Each lane against the same tenant in a width-1 pack and its eager steps.
    leaves = 0
    for uid in range(SERVICE_LANES):
        solo = filled_pack(wf, 1, [uid], device)
        for _ in range(total // SERVICE_SEGMENT):
            solo.run_segment(SERVICE_SEGMENT)
        got = pack.lane_state(uid)
        leaves += same_state(got, solo.lane_state(0), f"service_pack: lane {uid} vs a width-1 pack")
        leaves += same_state(got, eager_tenant(wf, uid, device, total), f"service_pack: lane {uid} vs eager steps")
        del solo
    _, syncs = thread_syncs(lambda: pack.run_segment(SERVICE_SEGMENT))
    expect(syncs["calling_thread"], 1, "service_pack host syncs a segment")
    per_segment = launches_per_call(lambda: pack.run_segment(SERVICE_SEGMENT), calls=1)
    # Freeze, thaw, release and admit: still one capture.
    frozen_lane, released = SERVICE_LANES // 2 - 1, SERVICE_LANES - 3
    pack.set_frozen(frozen_lane, True)
    tel = pack.run_segment(SERVICE_SEGMENT)
    expect(tel.executed.tolist()[frozen_lane], 0, "service_pack frozen lane executed")
    pack.set_frozen(frozen_lane, False)
    pack.release(released)
    state, _, _ = pack.init_tenant(service_tenant(wf, 99, device))
    expect(pack.admit(state, 99), released, "service_pack readmitted lane")
    tel = pack.run_segment(SERVICE_SEGMENT)
    expect(tel.executed.tolist(), [SERVICE_SEGMENT] * SERVICE_LANES, "service_pack executed after admission")
    expect(pack.captures, {"init": 1, "segment": 1}, "service_pack captures after freeze/thaw/release/admit")
    pool = graph_pool_bytes(pack._graphs)
    kernels = batched_exact_vs_plain(pack._states)
    seen: list = []
    with recording_draws(seen):
        service_tenant(wf, 0, device)
    draws = draws_on_path("service_pack setup", seen)
    n, d = VMAP_PSO
    row = {
        "config": f"{SERVICE_LANES} x PSO pop={n} dim={d} Ackley f32, TenantPack(early_stop=False), "
                  f"segments of {SERVICE_SEGMENT}, {SERVICE_GENS} generations after a warm segment",
        "launches": launches, "setup_philox_per_tenant": per_setup,
        "admission_s": admit_s, "capture_s": capture_s,
        "gen_per_s_per_tenant": SERVICE_GENS / wall_s, "wall_ms_per_segment": wall_s * 1e3 / segments,
        "event_ms_per_segment": seg_ms, "ms_per_gen": sum(seg_ms) / SERVICE_GENS,
        "host_syncs_per_segment": syncs["calling_thread"], "captures": dict(pack.captures),
        "device_ops_per_gen": per_segment["launches"] / SERVICE_SEGMENT,
        "device_ms_per_gen": per_segment["device_ms"] / SERVICE_SEGMENT,
        "idle_share": 1 - per_segment["device_ms"] / (sum(seg_ms) / segments),
        "pool_bytes": pool, "lanes_equal_width1_and_eager": SERVICE_LANES, "leaves_checked": leaves,
        "kernels": kernels, "philox_on_path_vs_plain": draws,
        "max_abs_err": {k: v["max_abs_err"] for k, v in kernels.items()},
    }
    del pack, wf
    torch.cuda.empty_cache()
    return row


def phase_vmapped_instances_resilient(device) -> dict:
    """bench.py's vmapped_instances_resilient (:1184-1233): the same 8
    tenants through ``torch.func.vmap(lambda s: wf.run_segment(s, 25))``
    (generations eager under the transform), the batched telemetry read in
    one copy and flushed, a warm segment and 200 generations: every
    instance equal to the pack's captured program, bit for bit; eager
    ms/gen against the pack's; 1 batched move a generation, counted from 0
    over the run; the path's batched moves (one segment's 25, recorded)
    against their plain version."""
    import torch
    from evox_tpu_torch.service import TenantPack
    from evox_tpu_torch.service.pack import to_host

    wf = vmapped_pso_workflow(device)
    states = [wf.init_step(service_tenant(wf, uid, device)) for uid in range(SERVICE_LANES)]
    stacked = stack_states(states)
    segment = torch.func.vmap(lambda s: wf.run_segment(s, SERVICE_SEGMENT))
    counters = vmap_counters()
    for c in counters.values():
        c.launches = 0
    total = SERVICE_SEGMENT + SERVICE_GENS
    t0 = time.perf_counter()
    s = stacked
    for _ in range(total // SERVICE_SEGMENT):
        s, tel = segment(s)
        wf.flush_telemetry(to_host(tel))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = counts(counters)
    expect(launches, {"fused_pso_move": 0, "fused_pso_move_batched": total, "philox_draws": 0,
                      "philox_draws_batched": 0}, "vmapped_instances_resilient launches")
    expect(tel.executed.tolist(), [SERVICE_SEGMENT] * SERVICE_LANES, "vmapped segment executed")
    pack = TenantPack(wf, SERVICE_LANES, early_stop=False)
    for uid, st in enumerate(states):
        pack.admit(st, uid)
    for _ in range(total // SERVICE_SEGMENT):
        pack.run_segment(SERVICE_SEGMENT)
    leaves = 0
    for uid in range(SERVICE_LANES):
        leaves += same_state(instance(s, uid), pack.lane_state(uid),
                             f"vmapped_instances_resilient: instance {uid} vs the pack's captured program")
    eager_ms, eager_host_ms, _ = timed(lambda: segment(s), SERVICE_SEGMENT)
    pack_ms, pack_host_ms, _ = timed(lambda: pack.run_segment(SERVICE_SEGMENT), SERVICE_SEGMENT)
    seen: list = []
    with recording_batched_moves(seen):
        segment(s)
    moves = batched_moves_vs_plain(seen, "vmapped_instances_resilient")
    row = {
        "config": f"{SERVICE_LANES} x PSO pop={VMAP_PSO[0]} dim={VMAP_PSO[1]} Ackley f32, torch.func.vmap over "
                  f"StdWorkflow.run_segment({SERVICE_SEGMENT}), telemetry flushed",
        "launches": launches, "wall_ms_per_gen": wall_s * 1e3 / total,
        "eager_ms_per_gen": eager_ms, "eager_host_ms_per_gen": eager_host_ms,
        "pack_ms_per_gen": pack_ms, "pack_host_ms_per_gen": pack_host_ms,
        "instances_equal_pack": SERVICE_LANES, "leaves_checked": leaves, "batched_moves_vs_plain": moves,
        "max_abs_err": moves["max_abs_err"],
    }
    del pack, wf, s, stacked, states
    torch.cuda.empty_cache()
    return row


def service_specs(device, names):
    """``TenantSpec``s of the main path: ``pso-<uid>`` on
    ``FaultyProblem(Ackley(), lane_faults=SERVICE_FAULTS)``, ``es-<uid>``
    OpenES on Sphere, budgets of ``SERVICE_BUDGET``."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.algorithms.so.es_variants import OpenES
    from evox_tpu_torch.problems.numerical import Ackley, Sphere
    from evox_tpu_torch.resilience import FaultyProblem
    from evox_tpu_torch.service import TenantSpec

    n, d = VMAP_PSO
    out = []
    for name in names:
        kind, uid = name.split("-")
        if kind == "pso":
            algo = PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device)
            prob = FaultyProblem(Ackley(), lane_faults=SERVICE_FAULTS)
        else:
            e = SERVICE_ES
            algo = OpenES(e["pop"], torch.full((e["dim"],), e["center"]), e["lr"], e["sigma"], optimizer="adam",
                          device=device)
            prob = Sphere()
        out.append(TenantSpec(name, algo, prob, n_steps=SERVICE_BUDGET, uid=int(uid)))
    return out


def make_service(root, **kw):
    from evox_tpu_torch.resilience import HealthProbe
    from evox_tpu_torch.service import OptimizationService

    return OptimizationService(root, lanes_per_pack=SERVICE_LANES, segment_steps=SERVICE_SEGMENT,
                               health=HealthProbe(stagnation_window=2), max_restarts=1, on_event=lambda msg: None,
                               obs=False, **kw)


@contextlib.contextmanager
def boundary_timer(parts):
    """While active, each call of the service's boundary parts appends its
    seconds to ``parts[key]``: the pack segments (``segment <algorithm>``:
    the replay, or the capture, and its one read), the lane scans
    (``scan``) and the checkpoint writes (``checkpoint``)."""
    from evox_tpu_torch.service import OptimizationService, TenantPack

    real = {"segment": (TenantPack, "run_segment"), "scan": (TenantPack, "check_lanes"),
            "checkpoint": (OptimizationService, "_checkpoint_tenant")}
    saved = {k: getattr(cls, name) for k, (cls, name) in real.items()}

    def timing(key, fn):
        def wrapped(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                name = f"{key} {type(self.workflow.algorithm).__name__}" if key == "segment" else key
                parts.setdefault(name, []).append(time.perf_counter() - t0)
        return wrapped

    for k, (cls, name) in real.items():
        setattr(cls, name, timing(k, saved[k]))
    try:
        yield
    finally:
        for k, (cls, name) in real.items():
            setattr(cls, name, saved[k])


def tenant_digests(root, tenant_id):
    from evox_tpu_torch.utils import read_manifest

    ns = Path(root) / "tenants" / tenant_id
    newest = sorted(p.name for p in ns.glob("ckpt_*.npz"))[-1]
    return newest, read_manifest(ns / newest)["leaf_digests"]


def phase_service_main_path(device) -> dict:
    """``OptimizationService(lanes_per_pack=8, segment_steps=25,
    HealthProbe(stagnation_window=2), max_restarts=1)`` with two buckets:
    12 PSO tenants of the service_pack shape on Ackley with tenant-keyed
    chaos (uid 1 a NaN burst, uid 2 a plateau: each restarted once, then
    quarantined), 4 of them queued for lanes; 4 OpenES(1024, 8.0 in dim
    100, lr 0.1, σ 0.1, adam) tenants on Sphere; one eviction and
    readmission (uid 3).  Counted from 0 over the run: the batched move
    (the PSO bucket's segment capture), the batched draws (OpenES's
    normals in its bucket's capture) and the solo draws (every tenant
    setup, and OpenES's init program's warm-up and capture), exactly.  One
    segment capture a bucket across freezes, quarantines, admissions and
    evictions.  Healthy tenant uid 0 and OpenES uid 12 equal the same
    tenants alone (state, counters, history, checkpoint leaf digests), uid
    3 after its eviction equals it alone, and a preempted service's
    tenants resumed in a new service equal them too (the preemption
    counter apart), bit for bit.  Wall ms a boundary split into segment,
    scan and checkpoint.  Then the README quick start on the card."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.resilience import Preempted, PreemptionGuard
    from evox_tpu_torch.service import OptimizationService, TenantStatus
    from evox_tpu_torch.workflows import StdWorkflow

    es0 = f"es-{SERVICE_PSO_TENANTS}"  # the first OpenES tenant
    pso_names = [f"pso-{u}" for u in range(SERVICE_PSO_TENANTS)]
    es_names = [f"es-{u}" for u in range(SERVICE_PSO_TENANTS, SERVICE_PSO_TENANTS + SERVICE_ES_TENANTS)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_service_"))
    try:
        counters = hpo_counters()
        # What one setup and one OpenES init_step draw (solo route).
        per_setup = {}
        for spec in service_specs(device, ["pso-0", es0]):
            kind = spec.tenant_id.split("-")[0]
            w = StdWorkflow(spec.algorithm, spec.problem)
            for c in counters.values():
                c.launches = 0
            s0 = w.setup(0)
            per_setup[kind] = counters["philox_draws"].launches
            counters["philox_draws"].launches = 0
            w.init_step(s0)
            per_setup[kind + "_init"] = counters["philox_draws"].launches
        setups = {"pso": 0, "es": 0}
        real_fresh = OptimizationService._fresh_state

        def counting_fresh(self, bucket, record):
            setups[record.spec.tenant_id.split("-")[0]] += 1
            return real_fresh(self, bucket, record)

        svc = make_service(root / "main")
        parts: dict = {}
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            with boundary_timer(parts):
                for spec in service_specs(device, pso_names + es_names):
                    svc.submit(spec)
                rounds = 0
                steps = []
                for _ in range(2):
                    t1 = time.perf_counter()
                    svc.step()
                    steps.append(time.perf_counter() - t1)
                    rounds += 1
                svc.evict("pso-3")
                svc.step()
                rounds += 1
                svc.submit(service_specs(device, ["pso-3"])[0])
                while True:
                    t1 = time.perf_counter()
                    progressed = svc.step()
                    steps.append(time.perf_counter() - t1)
                    rounds += 1
                    if not progressed:
                        break
            torch.cuda.synchronize()
        finally:
            OptimizationService._fresh_state = real_fresh
        wall_s = time.perf_counter() - t0
        launches = counts(counters)
        statuses = {name: svc.tenant(name).status.value for name in pso_names + es_names}
        for name in ("pso-1", "pso-2"):
            rec = svc.tenant(name)
            expect((rec.status, rec.restarts), (TenantStatus.QUARANTINED, 1), f"service {name}: status, restarts")
        for name in pso_names[3:] + es_names + ["pso-0"]:
            expect(svc.tenant(name).status, TenantStatus.COMPLETED, f"service {name}")
        expect((svc.stats.evictions, svc.stats.readmissions), (1, 1), "service evictions, readmissions")
        buckets = list(svc._buckets.values())
        expect(len(buckets), 2, "service buckets")
        for b in buckets:
            expect(b.pack.captures["segment"], 1, f"service bucket {b.key[0]}: segment captures")
        expect(launches["fused_pso_move_batched"], SERVICE_SEGMENT + 1, "service batched moves")
        expect(launches["philox_draws_batched"], SERVICE_SEGMENT + 1, "service batched draws (OpenES)")
        expect(launches["fused_pso_move"], 0, "service solo moves")
        # Each bucket's init program: a warm-up and a capture.
        want_draws = (setups["pso"] * per_setup["pso"] + setups["es"] * per_setup["es"]
                      + 2 * (per_setup["pso_init"] + per_setup["es_init"]))
        expect(launches["philox_draws"], want_draws, f"service solo draws ({setups} setups, {per_setup})")

        # The same tenants alone: uid 0 and OpenES uid 12 (each alone in its
        # bucket), uid 3 alone.
        ref = make_service(root / "alone")
        for spec in service_specs(device, ["pso-0", es0]):
            ref.submit(spec)
        ref.run()
        ref3 = make_service(root / "alone3")
        ref3.submit(service_specs(device, ["pso-3"])[0])
        ref3.run()
        checked = {}
        for name, other, other_root in (("pso-0", ref, root / "alone"), (es0, ref, root / "alone"),
                                        ("pso-3", ref3, root / "alone3")):
            leaves = same_state(svc.result(name), other.result(name), f"service {name} vs alone")
            h_got, h_want = svc.tenant(name).monitor.fitness_history, other.tenant(name).monitor.fitness_history
            expect(len(h_got), len(h_want), f"service {name}: history entries")
            for g, w in zip(h_got, h_want):
                exact(g, w, f"service {name}: history")
            expect(tenant_digests(root / "main", name), tenant_digests(other_root, name),
                   f"service {name}: newest checkpoint's leaf digests")
            checked[name] = {"leaves": leaves, "history": len(h_got)}

        # A preemption, and the resume in a new service over the same root.
        guard = PreemptionGuard()
        pre = make_service(root / "pre", preemption=guard)
        for spec in service_specs(device, ["pso-0", es0]):
            pre.submit(spec)
        pre.step()
        pre.step()
        guard.trip("chip_smoke drill")
        try:
            pre.step()
            raise AssertionError("the tripped guard did not preempt the service")
        except Preempted:
            pass
        fresh = make_service(root / "pre")
        for spec in service_specs(device, ["pso-0", es0]):
            fresh.submit(spec)
        fresh.run()
        for name in ("pso-0", es0):
            got, want = fresh.result(name), ref.result(name)
            expect(int(got.monitor.num_preemptions), 1, f"preempted {name}: num_preemptions")
            got = got.replace(monitor=got.monitor.replace(num_preemptions=want.monitor.num_preemptions))
            checked[f"preempted {name}"] = {"leaves": same_state(got, want, f"preempted {name} vs uninterrupted")}

        quick = service_quickstart(root / "quickstart", device)
        segments = svc.stats.segments_run
        row = {
            "config": f"OptimizationService(lanes_per_pack={SERVICE_LANES}, segment_steps={SERVICE_SEGMENT}, "
                      f"HealthProbe(stagnation_window=2), max_restarts=1): {SERVICE_PSO_TENANTS} x PSO "
                      f"{VMAP_PSO[0]} x {VMAP_PSO[1]} Ackley (lane faults: uid 1 NaN, uid 2 plateau), "
                      f"{SERVICE_ES_TENANTS} x OpenES {SERVICE_ES['pop']} x {SERVICE_ES['dim']} Sphere, "
                      f"budgets {SERVICE_BUDGET}",
            "launches": launches, "setups": setups, "philox_per_setup": per_setup,
            "statuses": statuses, "stats": {k: v for k, v in vars(svc.stats).items() if k != "rejections"},
            "rounds": rounds, "segments": segments, "wall_s": wall_s,
            "wall_ms_per_round": [round(t * 1e3, 3) for t in steps],
            # Each part's calls in ms: the segments' first call of a bucket
            # is its capture; a boundary writes one checkpoint a tenant.
            "boundary_ms": {k: {"calls": len(v), "total": sum(v) * 1e3, "median": sorted(v)[len(v) // 2] * 1e3,
                                "first": v[0] * 1e3, "max": max(v) * 1e3} for k, v in parts.items()},
            "checkpoint_ms_per_segment": sum(parts.get("checkpoint", [])) * 1e3 / segments,
            "captures": {b.key[0]: dict(b.pack.captures) for b in buckets},
            "pool_bytes": {b.key[0]: graph_pool_bytes(b.pack._graphs) for b in buckets},
            "checked": checked, "quickstart": quick,
        }
        del svc, ref, ref3, pre, fresh, buckets
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def service_quickstart(root, device) -> dict:
    """README's service quick start in the port's terms on the card:
    ``OptimizationService(lanes_per_pack=8, segment_steps=8)`` with two
    PSO(64, ±32 in dim 8) Ackley tenants of 24 generations."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.service import OptimizationService, TenantSpec, TenantStatus

    pop, dim, gens, seg = SERVICE_QUICKSTART
    lb, ub = -32.0 * torch.ones(dim), 32.0 * torch.ones(dim)
    svc = OptimizationService(root, lanes_per_pack=8, segment_steps=seg)
    # As the README writes it on the card (PSO's default device); a CPU
    # rehearsal names its device.
    kw = {} if device.type == "cuda" else {"device": device}
    svc.submit(TenantSpec("alice-1", PSO(pop, lb, ub, **kw), Ackley(), n_steps=gens))
    svc.submit(TenantSpec("bob-7", PSO(pop, lb, ub, **kw), Ackley(), n_steps=gens))
    svc.run()
    out = {}
    for name in ("alice-1", "bob-7"):
        rec = svc.tenant(name)
        expect(rec.status, TenantStatus.COMPLETED, f"service quick start {name}")
        state = svc.result(name)
        if state.algorithm.pop.device.type != device.type:
            raise AssertionError(f"service quick start {name}: the state is on {state.algorithm.pop.device}")
        out[name] = {"generations": rec.generations, "history": len(rec.monitor.fitness_history),
                     "best": float(state.algorithm.global_best_fit)}
    return out


# bench.py's distributed_8dev (PSO(8192 a process, ±10 in dim 256), Sphere)
# as a fleet of 2 worker processes on the card (tests/test_torch_fleet_worker.py).
FLEET_CFG = dict(pop=2 * DIST_8DEV[0], dim=DIST_8DEV[1], bound=10.0, problem="sphere", n_steps=40,
                 checkpoint_every=10, seed=0, metrics=True)
FLEET_KILL = {"0": {"kill": {"1": [25]}}}  # attempt 0: rank 1 SIGKILLed at evaluation 25
# The kill fleet's workers hold their segment 1 (generations 2-11 on a
# fresh start) in a profiler window: its copies between host and card.
FLEET_PROFILE_SEGMENT = 1
FLEET_SLOW = {"0": {"slow": {"1": [2, 3, 4, 5]}}}  # attempt 0: rank 1 slow at evaluations 2-5
FLEET_SLOW_SECONDS = 2.0  # each abandoned at the worker's eval_deadline
FLEET_EVAL_DEADLINE = 0.5
FLEET_STALE_AFTER = 1.0  # the watcher's FleetHealth(dead_after=): a beat older is stale
# The bit-for-bit comparisons skip the counter of the interruptions
# themselves (the JAX tests' _assert_states_equal).
FLEET_PREEMPT_KEY = "monitor/num_preemptions"


# The fleets' workers share a bytecode cache (PYTHONPYCACHEPREFIX).  Where
# the environment sets PYTHONDONTWRITEBYTECODE and site-packages hold no
# bytecode, as on the card's machine, every worker would compile torch's
# modules anew, ~10 s of its start-up (on an H100 machine: 19.8 s to a
# worker's wf.init without the cache, 8.6-11.2 s with it).  A background
# process fills the cache while the early phases run: it imports what a
# worker imports and runs the worker's path for 2 generations on the CPU.
FLEET_PYCACHE: dict = {}
FLEET_WARM = """
import os, sys, tempfile, time
t0 = time.perf_counter()
root, cache = sys.argv[1], sys.argv[2]
sys.path[:0] = [root, os.path.join(root, "tests")]
import torch.profiler
import test_torch_fleet_worker as worker
from evox_tpu_torch.obs import FleetAggregator, MetricsRegistry, Observability, Tracer
from evox_tpu_torch.parallel import HostHeartbeat, bootstrap_fleet, make_pop_mesh
from evox_tpu_torch.resilience import FleetSupervisor, ResilientRunner, RetryPolicy
wf, _ = worker.build(dict(pop=8, dim=2, problem="sphere"), make_pop_mesh(device="cpu"))
ResilientRunner(wf, tempfile.mkdtemp(dir=cache), checkpoint_every=1, retry=RetryPolicy(max_retries=0)).run(
    wf.init(0), n_steps=2)
print(time.perf_counter() - t0)
"""


def fleet_env() -> dict:
    """The fleet workers' environment: the port on the path, the shared
    bytecode cache, and bytecode writes allowed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    env.update(PYTHONPATH=ROOT, PYTHONPYCACHEPREFIX=FLEET_PYCACHE["dir"])
    return env


def start_fleet_pycache() -> None:
    import atexit
    import tempfile

    FLEET_PYCACHE["dir"] = tempfile.mkdtemp(prefix="evox_fleet_pycache_")
    FLEET_PYCACHE["proc"] = subprocess.Popen(
        [sys.executable, "-c", FLEET_WARM, ROOT, FLEET_PYCACHE["dir"]], env=fleet_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    atexit.register(stop_fleet_pycache)


def wait_fleet_pycache() -> dict:
    """Wait for the cache's warm-up (raises if it failed): the seconds the
    warm-up took in its process and those the first wait blocked."""
    proc = FLEET_PYCACHE["proc"]
    if "warmup_s" not in FLEET_PYCACHE:
        t0 = time.perf_counter()
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"the fleet's bytecode warm-up exited {proc.returncode}:\n{err[-3000:]}")
        FLEET_PYCACHE["warmup_s"] = float(out.split()[-1])
        FLEET_PYCACHE["waited_s"] = time.perf_counter() - t0
    return {k: FLEET_PYCACHE[k] for k in ("warmup_s", "waited_s")}


def stop_fleet_pycache() -> None:
    import shutil

    proc = FLEET_PYCACHE.get("proc")
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(FLEET_PYCACHE.get("dir", ""), ignore_errors=True)


def fleet_worker_module():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_fleet_worker

    return test_torch_fleet_worker


class FleetClock:
    """The supervisor's decisions and its workers' spawns and exits on one
    wall clock: ``on_event`` timestamps each event line, ``spawn`` records
    each worker's spawn and (a thread in ``os.waitid`` with ``WNOWAIT``,
    which does not reap) the moment it exits."""

    def __init__(self):
        import threading

        self.events, self.spawned, self.exited = [], {}, {}
        self._lock = threading.Lock()

    def on_event(self, line: str) -> None:
        self.events.append((time.time(), line))

    def spawn(self, argv, env, spec):
        import threading

        from evox_tpu_torch.resilience import fleet

        handle = fleet._default_spawn(argv, env, spec)
        key = (spec.attempt, spec.process_id)
        self.spawned[key] = time.time()

        def watch(pid=handle.pid):
            try:
                os.waitid(os.P_PID, pid, os.WEXITED | os.WNOWAIT)
            except ChildProcessError:
                pass
            with self._lock:
                self.exited.setdefault(key, time.time())

        threading.Thread(target=watch, daemon=True).start()
        return handle

    def first(self, kind: str, attempt: int) -> float:
        tag = f"[fleet attempt {attempt}] {kind}:"
        return next(t for t, line in self.events if line.startswith(tag))


class FleetWatcher:
    """A FleetAggregator fed from the heartbeat plane every 0.1 s while a
    fleet runs (its own registry; stale hosts from
    FleetHealth(dead_after=FLEET_STALE_AFTER)).  After each update with
    two fresh hosts every counter of the fleet view must equal the sum of
    the two hosts' counters in the beats it folded (``sum_checks`` counts
    them); ``stale`` records the last time a host that was up went stale,
    with its ``evox_fleet_host_up`` and how many of its gauges carry
    ``stale="true"``.  With two fresh hosts it also reads the supervisor's
    ``/metrics`` and ``/healthz`` once (``scrapes``: their status codes)."""

    def __init__(self, directory, world, sup=None):
        import threading

        from evox_tpu_torch.obs import FleetAggregator
        from evox_tpu_torch.parallel import FleetHealth

        self.agg = FleetAggregator()
        self.health = FleetHealth(directory, world, dead_after=FLEET_STALE_AFTER, start_grace=1e9)
        self.directory, self.sup = directory, sup
        self.sum_checks, self.up_seen, self.stale, self.errors, self.scrapes = 0, set(), {}, [], {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._frozen: dict = {}

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def _loop(self):
        import math

        from evox_tpu_torch.parallel import read_heartbeats

        while not self._stop.wait(0.1):
            beats = read_heartbeats(self.directory)
            report = self.health.check()
            stale = set(report.dead_hosts) | (self.up_seen - set(beats))
            self.agg.update(beats, stale_hosts=stale)
            snap = self.agg.snapshot()
            fresh = {h: b for h, b in beats.items() if h not in stale and isinstance(b.get("metrics"), dict)}
            for h in fresh:
                self.up_seen.add(h)
                self._frozen[h] = dict(fresh[h]["metrics"]["counters"])
            for h in self.up_seen:
                if h not in stale:
                    self.stale.pop(h, None)
                elif h not in self.stale:
                    up = snap.get(f'evox_fleet_host_up{{process_index="{h}"}}')
                    marked = [k for k in snap if f'process_index="{h}",stale="true"' in k]
                    self.stale[h] = {"at": time.time(), "host_up": up, "stale_series": len(marked)}
            if len(fresh) == 2 and not self.scrapes and self.sup is not None and self.sup.endpoint.started:
                import urllib.error
                import urllib.request

                for route in ("/metrics", "/healthz"):
                    try:
                        self.scrapes[route] = urllib.request.urlopen(self.sup.endpoint.url + route, timeout=5).status
                    except urllib.error.HTTPError as e:
                        self.scrapes[route] = e.code
            if len(fresh) == 2:
                want: dict = {}
                for counters in self._frozen.values():
                    for k, v in counters.items():
                        want[k] = want.get(k, 0.0) + v
                bad = {k: (snap.get(k), v) for k, v in want.items() if not math.isclose(snap.get(k, -1.0), v,
                                                                                           rel_tol=1e-9)}
                if bad:
                    self.errors.append(bad)
                self.sum_checks += 1


def fleet_run(directory, name, world, cfg, clock=None, watch=False, **kw):
    """One FleetSupervisor run of ``world`` workers of ``cfg`` on the
    card; returns (stats, checkpoint dir, supervisor, watcher or None).
    A FleetError fails the phase with the workers' logs."""
    from evox_tpu_torch.resilience import FleetError, FleetSupervisor

    worker = fleet_worker_module()
    ckpt = Path(directory) / name
    cfg_path = Path(directory) / f"{name}.json"
    cfg_path.write_text(json.dumps(cfg))
    wait_fleet_pycache()
    env = fleet_env()
    clock = clock or FleetClock()
    kw.setdefault("poll_interval", 0.1)
    kw.setdefault("dead_after", 20.0)
    kw.setdefault("grace_seconds", 10.0)
    kw.setdefault("start_grace", 120.0)
    kw.setdefault("attempt_timeout", 150.0)
    sup = FleetSupervisor(
        lambda spec: [sys.executable, worker.__file__, spec.checkpoint_dir, str(cfg_path)], world,
        checkpoint_dir=ckpt, env=env, on_event=clock.on_event, spawn=clock.spawn, **kw)
    watcher = FleetWatcher(sup.heartbeat_dir, world, sup if sup.endpoint is not None else None) if watch else None
    try:
        if watcher is not None:
            with watcher:
                stats = sup.run()
        else:
            stats = sup.run()
    except FleetError as e:
        logs = "\n".join(f"{p.name}:\n{p.read_text()[-3000:]}" for p in sorted(sup.heartbeat_dir.glob("*.log")))
        raise AssertionError(f"fleet {name}: {e}\n{logs}")
    return stats, ckpt, sup, watcher


def fleet_workers(ckpt) -> dict:
    """Every worker's record, keyed ``a<attempt>p<rank>`` (a killed
    worker's is the one of its last boundary); each must have kept its
    rows on the card, launched the move and the draws there, and held its
    first boundary's move against the plain version with no bit off."""
    out = {}
    for path in sorted(Path(ckpt).glob("worker_a*_p*.json")):
        rec = json.loads(path.read_text())
        key = path.stem[len("worker_"):].replace("_", "")
        if not rec.get("rows_device", "").startswith("cuda") or min(rec["launches"].values()) < 1:
            raise AssertionError(f"worker {key}: rows on {rec.get('rows_device')}, launches {rec['launches']}")
        move = rec.get("move_vs_plain")
        if move is None or move["bits_differ"] or move["elements"] < 1:
            raise AssertionError(f"worker {key}: the move against its plain version: {move}")
        out[key] = rec
    return out


def fleet_transfers(workers, pop) -> dict:
    """The profiled segment's copies between host and card of each
    worker that has one, per generation; none may be larger than the
    gathered fitness (``pop`` float32): the row blocks stay on the card.
    A worker of a 2-rank world must show gloo's exchange (copies both
    ways)."""
    out = {}
    for key, rec in workers.items():
        tr = rec.get("transfers")
        if tr is None:
            continue
        copies = tr["copies"]
        for direction in ("DtoH", "HtoD"):
            sizes = [int(b) for b in copies.get(direction, {})]
            if sizes and max(sizes) > 4 * pop:
                raise AssertionError(f"worker {key}: a {direction} copy of {max(sizes)} bytes: {copies}")
            if rec["world"] > 1 and not sizes:
                raise AssertionError(f"worker {key}: no {direction} copy in its profiled segment: {copies}")
        out[key] = {"generations": tr["generations"], "copies": copies,
                    "per_generation": {d: {"copies": sum(c.values()) / tr["generations"],
                                           "bytes": sum(int(b) * n for b, n in c.items()) / tr["generations"]}
                                       for d, c in copies.items()}}
    return out


def fleet_final(ckpt) -> dict:
    import numpy as np

    return dict(np.load(Path(ckpt) / "final_state.npz"))


def fleet_equal(a, b, what) -> int:
    """Leaves of two final payloads equal bit for bit (all but the
    preemption counter); returns how many were compared."""
    import numpy as np

    if a.keys() != b.keys():
        raise AssertionError(f"{what}: leaves {sorted(a)} vs {sorted(b)}")
    for k in a:
        if k != FLEET_PREEMPT_KEY and not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")
    return len(a) - 1


def fleet_timeline(stats, clock, workers, first_beats) -> dict:
    """Each attempt's wall seconds (launch to its last decision), spawn
    to first progress beat of each worker, the supervisor's verdict after
    a worker's death, and relaunch to the resumed worker's first beat."""
    attempts = []
    for a in range(stats.attempts):
        t0 = clock.first("launch", a)
        t1 = max(t for t, line in clock.events if line.startswith(f"[fleet attempt {a}]"))
        attempts.append(t1 - t0)
    out = {"attempt_seconds": attempts,
           "spawn_to_first_beat_s": {f"a{a}p{p}": first_beats[(a, p)] - clock.spawned[(a, p)]
                                     for (a, p) in sorted(first_beats) if (a, p) in clock.spawned}}
    for a in range(stats.attempts - 1):
        verdicts = [t for t, line in clock.events if line.startswith(f"[fleet attempt {a}] ")
                    and any(k in line for k in ("host-death:", "straggler:", "wedged:", "fleet-stall:"))]
        removed = [h for att, h, _ in stats.removed_hosts if att == a]
        for h in removed:
            if (a, h) in clock.exited and clock.exited[(a, h)] <= verdicts[0]:
                out.setdefault("exit_to_verdict_s", {})[f"a{a}p{h}"] = verdicts[0] - clock.exited[(a, h)]
        relaunch = clock.first("relaunch", a)
        out.setdefault("relaunch_to_resume_beat_s", {})[f"a{a + 1}"] = first_beats[(a + 1, 0)] - relaunch
    return out


def first_beats(sup) -> dict:
    out = {}
    for path in Path(sup.heartbeat_dir).glob("first_beat_a*_p*.json"):
        a, p = path.stem[len("first_beat_a"):].split("_p")
        out[(int(a), int(p))] = json.loads(path.read_text())["time"]
    return out


def eager_ms_per_gen(rec) -> float | None:
    """Wall ms a generation of a worker's segments past its first (whose
    execute seconds include the generation-1 init or the resume), but its
    profiled segment."""
    segs = rec["segments"][1:]
    chunks = rec["chunks"][-len(segs):] if segs else []
    profiled = (rec.get("transfers") or {}).get("boundary_generation")
    pairs = [(s, c) for (g, s), c in zip(segs, chunks) if g != profiled]
    if not pairs:
        return None
    return 1e3 * sum(s for s, _ in pairs) / sum(c for _, c in pairs)


def fleet_reference(device, directory) -> tuple[dict, dict]:
    """The uninterrupted 1-process fleet of FLEET_CFG (one rank: a one-rank
    NCCL group, captured segments) and the same run in this process
    through the same runner with no fleet."""
    import torch
    import torch.distributed as dist
    from evox_tpu_torch.parallel import make_pop_mesh
    from evox_tpu_torch.resilience import ResilientRunner, RetryPolicy

    cfg = dict(FLEET_CFG, device=device.type)
    stats, ckpt, _, _ = fleet_run(directory, "ref1", 1, cfg)
    if stats.world_sizes != [1] or not stats.completed:
        raise AssertionError(f"reference fleet: {stats.world_sizes}")
    ref = fleet_final(ckpt)
    workers = fleet_workers(ckpt)
    worker = fleet_worker_module()
    wf, _ = worker.build(cfg, make_pop_mesh(device=device))
    runner = ResilientRunner(wf, Path(directory) / "inproc", checkpoint_every=cfg["checkpoint_every"],
                             retry=RetryPolicy(max_retries=0))
    t0 = time.perf_counter()
    final = runner.run(wf.init(cfg["seed"]), n_steps=cfg["n_steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    inproc = {k: v for k, v in worker.final_payload(final).items()}
    dist.destroy_process_group()
    leaves = fleet_equal(ref, inproc, "1-process fleet vs in-process run")
    rec = {"segments": [[t.generation, t.execute_seconds] for t in runner.stats.segment_timings],
           "chunks": list(runner.stats.chunk_sizes)}
    del wf, runner, final
    torch.cuda.empty_cache()
    return ref, {"reference_workers": workers, "leaves_equal_inprocess": leaves, "inprocess_wall_s": wall,
                 "inprocess_ms_per_gen": eager_ms_per_gen(rec), "reference_ms_per_gen": eager_ms_per_gen(
                     workers["a00p00"])}


def fleet_launches(*worker_sets) -> dict:
    out = {"fused_pso_move": 0, "philox_draws": 0}
    for workers in worker_sets:
        for rec in workers.values():
            for k in out:
                out[k] += rec["launches"][k]
    return out


FLEET_REFERENCE: dict = {}


def phase_fleet_main_path(device) -> dict:
    """FleetSupervisor over 2 worker processes on the card
    (distributed_8dev's width, PSO(16384, ±10 in dim 256) on Sphere through
    ShardedProblem over the fleet's mesh: a gloo group whose ranks compute
    on cuda:0), ResilientRunner(checkpoint_every=10, preemption=True,
    RetryPolicy(max_retries=0), HostHeartbeat(interval=0.25, metrics=)),
    40 generations; attempt 0 SIGKILLs rank 1 at evaluation 25.  Checks
    world_sizes == [2, 1], one host death naming host 1, the resumed run's
    40 generations, its final state bit for bit against the uninterrupted
    1-process fleet and the in-process run, the aggregated counters against
    the beats' sums and host 1 going stale after the kill; times the
    attempts, the spawns, the verdict, the resume, the generations and the
    exchange."""
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="evox_fleet_")
    try:
        return fleet_main_path(device, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def fleet_main_path(device, directory) -> dict:
    import torch

    out = {"card": card_line(), "bytecode_warmup": wait_fleet_pycache()}
    ref, out["reference"] = fleet_reference(device, directory)
    FLEET_REFERENCE["final"] = ref
    clock = FleetClock()
    cfg = dict(FLEET_CFG, device=device.type, faults=FLEET_KILL, profile_segment=FLEET_PROFILE_SEGMENT)
    stats, ckpt, sup, watcher = fleet_run(directory, "kill", 2, cfg, clock=clock, watch=True, endpoint=True)
    if stats.world_sizes != [2, 1] or stats.host_deaths != 1 or [h for _, h, _ in stats.removed_hosts] != [1]:
        raise AssertionError(f"fleet_main_path: world_sizes {stats.world_sizes}, deaths {stats.host_deaths}, "
                             f"removed {stats.removed_hosts}")
    summary = json.loads((ckpt / "final_summary.json").read_text())
    if summary["completed_generations"] != FLEET_CFG["n_steps"]:
        raise AssertionError(f"fleet_main_path: the resumed lineage completed {summary}")
    out["leaves_equal_1_process_fleet"] = fleet_equal(fleet_final(ckpt), ref, "fleet vs 1-process fleet")
    workers = fleet_workers(ckpt)
    if watcher.scrapes != {"/metrics": 200, "/healthz": 200}:
        raise AssertionError(f"the supervisor's endpoint with two live hosts: {watcher.scrapes}")
    if watcher.errors or watcher.sum_checks < 1:
        raise AssertionError(f"aggregated counters vs the beats' sums: {watcher.sum_checks} checks, "
                             f"{watcher.errors[:2]}")
    kill_exit = clock.exited.get((0, 1))
    host1 = watcher.stale.get(1)
    if host1 is None or host1["host_up"] != 0 or kill_exit is None or host1["at"] < kill_exit:
        raise AssertionError(f"host 1 not marked stale after the kill: {host1}, exit at {kill_exit}")
    survivor = workers["a00p00"]
    if survivor["outcome"] != "peer-lost" or workers["a00p01"]["outcome"] != "running":
        raise AssertionError(f"fleet_main_path: the survivor {survivor['outcome']}, "
                             f"the killed rank {workers['a00p01']['outcome']}")
    transfers = fleet_transfers(workers, FLEET_CFG["pop"])
    if not {"a00p00", "a00p01"} <= set(transfers):
        raise AssertionError(f"fleet_main_path: profiled segments of {sorted(transfers)}: "
                             f"{ {k: r.get('transfers') for k, r in workers.items()} }")
    ex = survivor["exchange"]
    out.update({
        "world_sizes": stats.world_sizes, "removed_hosts": stats.removed_hosts, "host_deaths": stats.host_deaths,
        "exit_codes": stats.exit_codes, "resumed_from_generation": summary["resumed_from_generation"],
        "timeline": fleet_timeline(stats, clock, workers, first_beats(sup)),
        "aggregator": {"sum_checks": watcher.sum_checks, "endpoint": watcher.scrapes, "host1_stale_after_exit_s": host1["at"] - kill_exit,
                       "host1_up": host1["host_up"], "host1_stale_series": host1["stale_series"]},
        "group_backend": survivor["group_backend"], "mesh": survivor["mesh"],
        "fleet_eager_ms_per_gen": eager_ms_per_gen(survivor),
        "exchange_us_per_gen": 1e6 * ex["seconds"] / ex["calls"], "exchange_devices": ex["devices"],
        "transfers": transfers, "stages": {k: r["stages"] for k, r in workers.items()},
        "barrier_ms": {k: r.get("barrier_ms") for k, r in workers.items()},
        "checkpoints_written": {k: r["checkpoints_written"] for k, r in workers.items()},
        "launches_by_worker": {k: r["launches"] for k, r in workers.items()},
        "move_vs_plain": {k: r["move_vs_plain"] for k, r in workers.items()},
        "launches": fleet_launches(workers),
    })
    torch.cuda.synchronize()
    return out


def phase_fleet_straggler(device) -> dict:
    """2 workers, rank 1 slow at evaluations 2-5 (FLEET_SLOW_SECONDS a
    sleep, each abandoned at the worker's eval_deadline of
    FLEET_EVAL_DEADLINE and counted in its beat's deadline_trips): the
    supervisor quarantines host 1 as a straggler, relaunches on 1, and
    the final state equals the uninterrupted 1-process fleet's bit for
    bit."""
    import shutil
    import tempfile

    directory = tempfile.mkdtemp(prefix="evox_straggler_")
    try:
        return fleet_straggler(device, directory)
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def fleet_straggler(device, directory) -> dict:
    clock = FleetClock()
    cfg = dict(FLEET_CFG, device=device.type, faults=FLEET_SLOW, slow_seconds=FLEET_SLOW_SECONDS,
               eval_deadline=FLEET_EVAL_DEADLINE)
    stats, ckpt, sup, _ = fleet_run(directory, "straggler", 2, cfg, clock=clock, eval_deadline=30.0)
    kinds = [e.kind for e in stats.events]
    if stats.world_sizes != [2, 1] or "straggler" not in kinds or stats.removed_hosts[0][1] != 1:
        raise AssertionError(f"fleet_straggler: world_sizes {stats.world_sizes}, events {kinds}, "
                             f"removed {stats.removed_hosts}")
    summary = json.loads((ckpt / "final_summary.json").read_text())
    if summary["completed_generations"] != FLEET_CFG["n_steps"]:
        raise AssertionError(f"fleet_straggler: the resumed lineage completed {summary}")
    workers = fleet_workers(ckpt)
    leaves = fleet_equal(fleet_final(ckpt), FLEET_REFERENCE["final"], "straggler fleet vs 1-process fleet")
    return {
        "world_sizes": stats.world_sizes, "removed_hosts": stats.removed_hosts,
        "hosts_quarantined": stats.hosts_quarantined, "exit_codes": stats.exit_codes, "events": kinds,
        "resumed_from_generation": summary["resumed_from_generation"], "leaves_equal_1_process_fleet": leaves,
        "timeline": fleet_timeline(stats, clock, workers, first_beats(sup)),
        "deadline_trips": {k: r["deadline_trips"] for k, r in workers.items()},
        "launches_by_worker": {k: r["launches"] for k, r in workers.items()},
        "move_vs_plain": {k: r["move_vs_plain"] for k, r in workers.items()},
        "stages": {k: r["stages"] for k, r in workers.items()},
        "launches": fleet_launches(workers),
    }


# -- the serving daemon (ServiceDaemon, the persistent program cache) ------------

# service_pack's tenants under the daemon: 8 x PSO(1024, ±32 in dim 100) on
# Ackley, 8 lanes, segments of 25, budgets of 200 generations; the cold
# process is killed after the boundary of segment DAEMON["kill_after"].
DAEMON = dict(tenants=SERVICE_LANES, lanes=SERVICE_LANES, segment=SERVICE_SEGMENT, n_steps=SERVICE_GENS,
              pop=VMAP_PSO[0], dim=VMAP_PSO[1], kill_after=3)
OVERLOAD_QUEUE = 8  # the overload phase's class budget and service queue bound
OVERLOAD_ROUNDS = 6  # timed rounds, uncontended and contended
OVERLOAD_PRESSURE = 2  # submissions beyond capacity a contended round

# One daemon process over a root: ``cold`` submits the tenants, steps and
# dies by os._exit after DAEMON["kill_after"] boundaries (no shutdown path
# runs); ``warm`` replays the journal, prewarms from the root's program
# cache and runs every tenant to completion.  The package is imported from
# ``tree`` (a copy whose build/ is empty).  Each writes a JSON summary.
DAEMON_CHILD = """
import json, os, sys, time
t0, wall0 = time.perf_counter(), time.time()
mode, root, tree, out, cfg = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
sys.path.insert(0, tree)
# chip_smoke's own spec factories (an HPO spec's transform is pickled by name).
sys.path.append(cfg["script_dir"])
import torch
from evox_tpu_torch.algorithms import PSO
from evox_tpu_torch.ops import _build, philox, pso_step
from evox_tpu_torch.problems.numerical import Ackley
from evox_tpu_torch.resilience import HealthProbe
from evox_tpu_torch.service import ServiceDaemon, TenantSpec
marks = {"imported": time.perf_counter() - t0}
device = torch.device(cfg["device"])
sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
kw = {}
if "nonfinite_skip" in cfg:
    kw["health"] = HealthProbe(nonfinite_skip=tuple(cfg["nonfinite_skip"]))
if "brownout_threshold" in cfg:
    kw["brownout_threshold"] = cfg["brownout_threshold"]
daemon = ServiceDaemon(root, lanes_per_pack=cfg["lanes"], segment_steps=cfg["segment"], on_event=lambda msg: None,
                       device=device, **kw)
# The libraries each capture record lists, by program label.
saved, save = {}, daemon.exec_cache.save


def saving(label, signature, program):
    saved[label] = sorted(program.libraries)
    return save(label, signature, program)


daemon.exec_cache.save = saving
restored = daemon.start()
sync()
marks["started"] = time.perf_counter() - t0
n, d = cfg["pop"], cfg["dim"]
if mode == "cold":
    if cfg.get("hpo"):
        import chip_smoke

        specs = chip_smoke.daemon_hpo_specs(device, cfg)
    else:
        specs = [TenantSpec(f"t{uid}", PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device),
                            Ackley(), n_steps=cfg["n_steps"], uid=uid) for uid in range(cfg["tenants"])]
    for spec in specs:
        daemon.submit(spec)
    sync()
    marks["submitted"] = time.perf_counter() - t0
rounds = []
counters = {"fused_pso_move": pso_step.fused_pso_move, "fused_pso_move_batched": pso_step.fused_pso_move_batched,
            "philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}


def summary(done):
    c = daemon.exec_cache.stats
    rec = {"mode": mode, "restored": restored, "marks": marks, "wall0": wall0, "rounds_s": rounds, "done": done,
           "segments": daemon.service.stats.segments_run, "captures": daemon.stats.captures,
           "kernel_builds": dict(_build.counts), "build_dir": str(_build.BUILD_DIR),
           "cache": {"hits": c.hits, "misses": c.misses, "saves": c.saves, "quarantines": c.quarantines},
           "prewarmed": daemon.stats.prewarmed, "launches": {k: v.launches for k, v in counters.items()},
           "statuses": {t: r.status.value for t, r in daemon.service._tenants.items()},
           "generations": {t: r.generations for t, r in daemon.service._tenants.items()},
           "statusz_exec_cache": daemon._statusz()["exec_cache"], "records": saved}
    with open(out + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(out + ".tmp", out)


while True:
    t1 = time.perf_counter()
    progressed = daemon.step()
    sync()
    rounds.append(time.perf_counter() - t1)
    if len(rounds) == 1:
        marks["first_segment"] = time.perf_counter() - t0
        marks["first_segment_wall"] = time.time()
    if mode == "cold" and len(rounds) == cfg["kill_after"]:
        summary(False)
        os._exit(9)
    if not progressed:
        break
summary(True)
"""


def daemon_specs(device, uids, n_steps, prefix="t", dim=None):
    """``TenantSpec``s of service_pack's shape: PSO(1024, ±32 in dim 100,
    or in dim ``dim``) on Ackley, budgets ``n_steps``, tenant
    ``<prefix><uid>`` built on ``device``."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.service import TenantSpec

    n, d = DAEMON["pop"], dim or DAEMON["dim"]
    return [TenantSpec(f"{prefix}{uid}", PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device),
                       Ackley(), n_steps=n_steps, uid=uid) for uid in uids]


def package_copy(directory) -> Path:
    """A copy of the port's package under ``directory`` without its
    ``build/`` (and bytecode): a process importing it builds or installs
    every kernel library it launches."""
    import shutil

    shutil.copytree(Path(ROOT) / "evox_tpu_torch", Path(directory) / "evox_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    return Path(directory)


def daemon_child(mode, root, tree, out_dir, device, cfg=None, name="daemon") -> dict:
    """Run one daemon process (``DAEMON_CHILD`` with ``cfg``, DAEMON's by
    default) and read its summary; the seconds from its spawn to the end of
    its first segment are added."""
    out = Path(out_dir) / f"{name}_{mode}.json"
    env = {k: v for k, v in fleet_env().items() if k != "PYTHONPATH"}
    spawned = time.time()
    cfg = {**(cfg or DAEMON), "device": str(device), "script_dir": ROOT}
    proc = subprocess.run([sys.executable, "-c", DAEMON_CHILD, mode, str(root), str(tree), str(out),
                           json.dumps(cfg)], env=env, capture_output=True, text=True, timeout=600)
    want = 9 if mode == "cold" else 0
    if proc.returncode != want:
        raise AssertionError(f"the {mode} daemon process exited {proc.returncode}, expected {want}:\n"
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(out.read_text())
    rec["spawn_to_first_segment_s"] = rec["marks"]["first_segment_wall"] - spawned
    if not rec["build_dir"].startswith(str(tree)):
        raise AssertionError(f"the {mode} daemon built into {rec['build_dir']}, not its own copy {tree}")
    return rec


def daemon_rounds(daemon) -> list[float]:
    """Step ``daemon`` until no lane makes progress; each round's seconds
    (the card waited out)."""
    import torch

    rounds = []
    while True:
        t1 = time.perf_counter()
        progressed = daemon.step()
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t1)
        if not progressed:
            return rounds


def median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_daemon_main_path(device) -> dict:
    """``ServiceDaemon(root, lanes_per_pack=8, segment_steps=25)`` with 8
    tenants of service_pack's shape, budgets of 200 (completed at 201).
    The uninterrupted daemon runs here; launches counted from 0 over its
    run (the prewarm's captures of both cadences, 25 and 50: a warm-up
    generation and the captured ones each; the setups' draws) and over the
    two processes below.  A cold process, importing a copy of the package
    whose build/ is empty, submits, steps and dies by ``os._exit`` after
    the boundary of segment 3 published its checkpoints; a warm process,
    from a second such copy over the same root, replays the journal,
    prewarms from the root's program cache (every program a hit, no
    ``nvcc``: the libraries come out of the entries) and runs every tenant
    to completion.  Every tenant's final state and newest checkpoint
    digests then equal the uninterrupted daemon's, bit for bit.  The
    batched move and draws on the daemon's final states, and a setup's
    draws, against their plain versions."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.ops import _build
    from evox_tpu_torch.resilience.testing import last_checkpoint_digests, verify_tenants_bit_identical
    from evox_tpu_torch.service import OptimizationService, ServiceDaemon, TenantStatus
    from evox_tpu_torch.service.tenant import TenantRecord

    pycache = wait_fleet_pycache()  # the daemon processes share the fleet's bytecode cache
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_daemon_"))
    tids = [f"t{u}" for u in range(DAEMON["tenants"])]
    try:
        counters = hpo_counters()
        setups = [0]
        real_fresh = OptimizationService._fresh_state

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        ref = ServiceDaemon(root / "ref", lanes_per_pack=DAEMON["lanes"], segment_steps=DAEMON["segment"],
                            on_event=lambda msg: None, device=device)
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            ref.start()
            for spec in daemon_specs(device, range(DAEMON["tenants"]), DAEMON["n_steps"]):
                ref.submit(spec)
            torch.cuda.synchronize()
            submit_s = time.perf_counter() - t0
            rounds = daemon_rounds(ref)
        finally:
            OptimizationService._fresh_state = real_fresh
        ref_launches = counts(counters)
        for tid in tids:
            expect(ref.tenant(tid).status, TenantStatus.COMPLETED, f"daemon_main_path {tid}")
        bucket = next(iter(ref.service._buckets.values()))
        pack = bucket.pack
        seg, slow = DAEMON["segment"], DAEMON["segment"] * ref.brownout_factor
        expect(pack.captures, {"init": 1, "segment": 2}, "daemon_main_path captures (both cadences prewarmed)")
        expect(ref.stats.captures, pack.captures, "daemon_main_path DaemonStats.captures")
        expect(ref_launches["fused_pso_move_batched"], (seg + 1) + (slow + 1), "daemon_main_path batched moves")
        expect(ref_launches["fused_pso_move"], 0, "daemon_main_path solo moves")
        seen: list = []
        with recording_draws(seen):
            real_fresh(ref.service, bucket, TenantRecord(spec=ref.tenant("t0").spec, uid=0))
        draws = draws_on_path("daemon_main_path setup", seen)
        per_setup = draws["calls"]
        expect(ref_launches["philox_draws"], setups[0] * per_setup, f"daemon_main_path draws ({setups[0]} setups)")
        kernels = batched_exact_vs_plain(pack._states)
        expected = {tid: ref.result(tid) for tid in tids}
        digests = {tid: last_checkpoint_digests(root / "ref", tid) for tid in tids}
        pool = graph_pool_bytes(pack._graphs)

        # The kill and the warm restart, each in a process of its own.
        cold = daemon_child("cold", root / "killed", package_copy(root / "cold_tree"), root, device)
        warm = daemon_child("warm", root / "killed", package_copy(root / "warm_tree"), root, device)
        expect((cold["segments"], cold["done"]), (DAEMON["kill_after"], False), "the cold daemon's segments")
        expect(cold["kernel_builds"]["builds"] >= 1, True, f"the cold daemon's kernel builds {cold['kernel_builds']}")
        expect(warm["restored"], DAEMON["tenants"], "tenants the warm daemon replayed")
        expect(warm["kernel_builds"]["builds"], 0, "nvcc builds in the warm daemon")
        expect((warm["cache"]["misses"], warm["cache"]["quarantines"]), (0, 0), "the warm daemon's cache misses, "
               "quarantines")
        expect(warm["cache"]["hits"], len(warm["prewarmed"]), "the warm daemon's cache hits")
        expect(all(warm["prewarmed"].values()), True, "every warm pack program from the cache")
        expect(warm["captures"], {"init": 1, "segment": 2}, "the warm daemon's captures")
        expect(set(warm["statuses"].values()), {"completed"}, "the warm daemon's tenants")
        # The killed root's tenants against the uninterrupted daemon's.
        check = ServiceDaemon(root / "killed", lanes_per_pack=DAEMON["lanes"], segment_steps=DAEMON["segment"],
                              exec_cache=None, on_event=lambda msg: None, device=device)
        check.start()
        check.run()
        verify_tenants_bit_identical(check, root / "killed", expected, digests, "daemon_main_path kill and restart")
        launches = {k: ref_launches[k] + cold["launches"][k] + warm["launches"][k] for k in ref_launches}
        steady = rounds[1:-1]
        row = {
            "config": f"ServiceDaemon(lanes_per_pack={DAEMON['lanes']}, segment_steps={seg}): {DAEMON['tenants']} x PSO "
                      f"pop={DAEMON['pop']} dim={DAEMON['dim']} Ackley f32, budgets {DAEMON['n_steps']}; cold process "
                      f"killed after segment {DAEMON['kill_after']}, warm process restarted over the same root",
            "launches": launches, "launches_uninterrupted": ref_launches, "setups": setups[0],
            "philox_per_setup": per_setup, "captures": dict(pack.captures),
            "uninterrupted": {"submit_s": submit_s, "rounds_ms": [t * 1e3 for t in rounds],
                              "ms_per_gen": median(steady) * 1e3 / seg,
                              "gen_per_s_per_tenant": seg / median(steady)},
            "time_to_first_segment_s": {"cold": cold["marks"]["first_segment"], "warm": warm["marks"]["first_segment"]},
            "spawn_to_first_segment_s": {"cold": cold["spawn_to_first_segment_s"],
                                         "warm": warm["spawn_to_first_segment_s"]},
            "cold": {k: cold[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "rounds_s")},
            "warm": {k: warm[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "rounds_s",
                                          "statusz_exec_cache")},
            "warm_ms_per_gen": median(warm["rounds_s"][1:-1]) * 1e3 / seg,
            "bit_identical_tenants": len(tids), "pool_bytes": pool, "pycache": pycache,
            "kernels": kernels, "philox_on_path_vs_plain": draws,
            "max_abs_err": {k: v["max_abs_err"] for k, v in kernels.items()},
        }
        del ref, check, pack, bucket, expected
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_daemon_overload(device) -> dict:
    """The daemon under overload (the shape of the JAX package's
    ``tools/bench_daemon.py`` overload gate): 8 tenants of service_pack's
    shape with unbounded budgets fill the 8 lanes of a daemon whose one
    class has a queue budget of 8 (the service queue's bound too, so
    brown-out enters at 6 queued); the queue is filled to its budget, and
    every timed round submits 2 more, each of which must be shed with a
    structured ``AdmissionError(reason="shed", retry_after_segments=...)``
    while the queue never exceeds its budget.  Brown-out stretches the
    cadence to 50 without a capture (both cadences prewarmed), and returns
    it to 25 once parking queued tenants halves the pressure.  Printed,
    with no gate: the admitted tenants' gen/s as a share of an uncontended
    daemon's."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.service import AdmissionError, ServiceDaemon, TenantClass

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_overload_"))
    unbounded = 10**9
    try:
        counters = hpo_counters()
        for c in counters.values():
            c.launches = 0

        def build(tag, **kw):
            return ServiceDaemon(root / tag, lanes_per_pack=DAEMON["lanes"], segment_steps=DAEMON["segment"],
                                 checkpoint_every=10**6, on_event=lambda msg: None, device=device, **kw)

        def timed(daemon, per_round=None):
            gens, t0 = 0, time.perf_counter()
            for _ in range(OVERLOAD_ROUNDS):
                if per_round is not None:
                    per_round()
                daemon.step()
                gens += daemon.service.segment_steps
            torch.cuda.synchronize()
            return gens / (time.perf_counter() - t0)

        free = build("uncontended", max_queue=2 * OVERLOAD_QUEUE, brownout_threshold=None)
        for spec in daemon_specs(device, range(DAEMON["lanes"]), unbounded, "u"):
            free.submit(spec)
        free.step()  # admissions and the first segment
        rate_free = timed(free)
        del free
        torch.cuda.empty_cache()

        daemon = build("contended", max_queue=OVERLOAD_QUEUE, classes=[TenantClass("standard", OVERLOAD_QUEUE)])
        specs = daemon_specs(device, range(DAEMON["lanes"] + OVERLOAD_QUEUE), unbounded, "c")
        half = DAEMON["lanes"] // 2
        for part in (specs[:half], specs[half:DAEMON["lanes"]]):
            # Half a pack at a time: the running cohort alone never browns out.
            for spec in part:
                daemon.submit(spec)
            daemon.step()
        pack = next(iter(daemon.service._buckets.values())).pack
        prewarmed = dict(pack.captures)
        expect(prewarmed, {"init": 1, "segment": 2}, "daemon_overload captures (both cadences prewarmed)")
        expect(daemon.brownout, False, "brown-out before the queue filled")
        for spec in specs[DAEMON["lanes"]:]:
            daemon.submit(spec)
        sheds, extra, queue_max = [], [len(specs)], []

        def pressure():
            for spec in daemon_specs(device, range(extra[0], extra[0] + OVERLOAD_PRESSURE), unbounded, "x"):
                try:
                    daemon.submit(spec)
                    raise AssertionError(f"daemon_overload: {spec.tenant_id} was admitted beyond the budget")
                except AdmissionError as e:
                    sheds.append((e.reason, e.retry_after_segments))
            extra[0] += OVERLOAD_PRESSURE
            queue_max.append(len(daemon.service._queue))
            if queue_max[-1] > OVERLOAD_QUEUE:
                raise AssertionError(f"daemon_overload: the queue grew to {queue_max[-1]} > {OVERLOAD_QUEUE}")

        rate_busy = timed(daemon, pressure)
        expect((daemon.brownout, daemon.service.segment_steps, daemon.stats.brownout_entries),
               (True, DAEMON["segment"] * daemon.brownout_factor, 1), "daemon_overload brown-out")
        structured = [s for s in sheds if s[0] == "shed" and isinstance(s[1], int) and s[1] >= 1]
        expect(len(structured), OVERLOAD_ROUNDS * OVERLOAD_PRESSURE, f"structured sheds of {sheds}")
        expect(daemon.stats.sheds, len(sheds), "daemon_overload DaemonStats.sheds")
        # Halve the pressure: park queued tenants, then one round.
        exit_at = daemon.brownout_threshold / 2
        parked = 0
        while len(daemon.service._queue) / daemon.service.max_queue > exit_at:
            daemon.park(daemon.service._queue[-1])
            parked += 1
        daemon.step()
        expect((daemon.brownout, daemon.service.segment_steps, daemon.stats.brownout_exits),
               (False, DAEMON["segment"], 1), "daemon_overload brown-out exit")
        expect(pack.captures, prewarmed, "daemon_overload captures across the stretch and its return")
        torch.cuda.synchronize()
        launches = counts(counters)
        row = {
            "config": f"ServiceDaemon(lanes_per_pack={DAEMON['lanes']}, segment_steps={DAEMON['segment']}, "
                      f"max_queue={OVERLOAD_QUEUE}, TenantClass('standard', {OVERLOAD_QUEUE}), brownout 0.75 x 2): "
                      f"{DAEMON['lanes']} running + {OVERLOAD_QUEUE} queued PSO pop={DAEMON['pop']} "
                      f"dim={DAEMON['dim']} Ackley, {OVERLOAD_PRESSURE} excess submissions a round",
            "launches": launches, "per_tenant_gen_per_s": {"uncontended": rate_free, "contended": rate_busy},
            "contended_share": rate_busy / rate_free, "sheds": len(sheds),
            "retry_after_segments_seen": sorted({s[1] for s in structured}), "queue_max": max(queue_max),
            "brownout": {"entries": daemon.stats.brownout_entries, "exits": daemon.stats.brownout_exits,
                         "parked_to_exit": parked}, "captures": dict(pack.captures),
        }
        del daemon, pack
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- the service's HPO workload (TenantSpec(workload="hpo")) ------------------------

# Bucket (A): hpo_ladder (HPO_LADDER: PSO(64, 1e-3..0.5 in dim 2) over 64 x
# OpenES(1024, zeros(32), lr 0.05, sigma 0.1) on Sphere, 32 inner
# generations); bucket (B): CMA-ES(pop 64, mean [0.6, 2.0], sigma 0.3) over 64
# x PSO(1024, ±5 in dim 32) on Sphere, 32 inner generations (the JAX HPO
# tests' second nest at hpo_ladder's width).  Segments of 5 outer
# generations, budgets of 10.
SERVICE_HPO = dict(lanes=4, segment=5, n_steps=10, es_tenants=4, cma_tenants=2, timed_segments=3, inner_bound=5.0)
# service_hpo_grow: one bucket-(A) tenant on a constant-fitness inner
# problem, the ladder regrowing OpenES to 2048 (window 8).
SERVICE_HPO_GROW = dict(window=8, max_pop=2048, n_steps=10)
# daemon_hpo_restart: two bucket-(A) tenants and one PSO tenant of
# daemon_main_path's shape, budgets of 20; the cold process is killed after
# round 2.
DAEMON_HPO = dict(DAEMON, tenants=3, hpo_tenants=2, lanes=SERVICE_HPO["lanes"], segment=SERVICE_HPO["segment"],
                  n_steps=20, kill_after=2, hpo=True, hpo_ladder=HPO_LADDER, nonfinite_skip=["instances"],
                  brownout_threshold=None)
def cma_transform(x):
    """Bucket (B)'s solution transform (the JAX HPO tests' ``pso_transform``):
    the inner PSO's w and phi_p."""
    return {"algorithm.w": x[:, 0].clamp(0.1, 1.0), "algorithm.phi_p": x[:, 1].clamp(0.5, 3.0)}


def service_hpo_spec(name, device, n_steps, problem=None, grow=None, ladder=None):
    """The ``TenantSpec`` of tenant ``es-<uid>`` (bucket A) or ``cma-<uid>``
    (bucket B) at ``ladder``'s sizes (``HPO_LADDER``'s by default);
    ``problem`` replaces the inner Sphere."""
    import torch
    from evox_tpu_torch.algorithms import CMAES, PSO, OpenES
    from evox_tpu_torch.hpo import HPOFitnessMonitor, NestedProblem
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.service import TenantSpec
    from evox_tpu_torch.workflows import StdWorkflow

    c = ladder or HPO_LADDER
    kind, uid = name.split("-")
    inner_problem = problem if problem is not None else Sphere()
    if kind == "es":
        es = OpenES(c["inner_pop"], torch.zeros(c["dim"]), learning_rate=0.05, noise_stdev=0.1, device=device)
        inner = StdWorkflow(es, inner_problem, monitor=HPOFitnessMonitor())
        algo = PSO(c["candidates"], lb=1e-3 * torch.ones(2), ub=0.5 * torch.ones(2), device=device)
        transform = ladder_transform
    else:
        b = SERVICE_HPO["inner_bound"]
        inner = StdWorkflow(PSO(c["inner_pop"], -b * torch.ones(c["dim"]), b * torch.ones(c["dim"]), device=device),
                            inner_problem, monitor=HPOFitnessMonitor())
        algo = CMAES(torch.tensor([0.6, 2.0]), 0.3, pop_size=c["candidates"], device=device)
        transform = cma_transform
    nested = NestedProblem(inner, iterations=c["iterations"], num_candidates=c["candidates"])
    return TenantSpec(name, algo, nested, n_steps=n_steps, uid=int(uid), workload="hpo", grow=grow,
                      solution_transform=transform)


def daemon_hpo_specs(device, cfg=None):
    """daemon_hpo_restart's tenants (``cfg``, DAEMON_HPO by default):
    ``es-0``, ``es-1`` of bucket (A) and ``t2``, a PSO tenant of
    daemon_main_path's shape."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.service import TenantSpec

    cfg = cfg or DAEMON_HPO
    n, k, d = cfg["n_steps"], cfg["hpo_tenants"], cfg["dim"]
    specs = [service_hpo_spec(f"es-{u}", device, n, ladder=cfg["hpo_ladder"]) for u in range(k)]
    pso = PSO(cfg["pop"], torch.full((d,), -32.0), torch.full((d,), 32.0), device=device)
    return specs + [TenantSpec(f"t{k}", pso, Ackley(), n_steps=n, uid=k)]


def hpo_service(root, **kw):
    from evox_tpu_torch.obs import MetricsRegistry, Observability
    from evox_tpu_torch.resilience import HealthProbe
    from evox_tpu_torch.service import OptimizationService

    return OptimizationService(root, lanes_per_pack=SERVICE_HPO["lanes"], segment_steps=SERVICE_HPO["segment"],
                               health=HealthProbe(nonfinite_skip=("instances",)), on_event=lambda msg: None,
                               obs=Observability(registry=MetricsRegistry(), run_id=Path(root).name), **kw)


def bucket_name(pack) -> str:
    """``<outer algorithm>/<inner population>`` of a pack of nests."""
    from evox_tpu_torch.hpo import find_nested

    return f"{type(pack.workflow.algorithm).__name__}/{find_nested(pack.workflow.problem).inner_pop}"


@contextlib.contextmanager
def pack_calls(calls):
    """While active, each call of a pack's ``init_tenant`` and
    ``run_segment`` appends ``(method, bucket_name, the launch counters'
    change, seconds)`` to ``calls``."""
    from evox_tpu_torch.service import TenantPack

    counters = hpo_counters()
    saved = {name: getattr(TenantPack, name) for name in ("init_tenant", "run_segment")}

    def wrap(name, fn):
        def wrapped(self, *a, **kw):
            before, t0 = counts(counters), time.perf_counter()
            try:
                return fn(self, *a, **kw)
            finally:
                calls.append((name, bucket_name(self), {k: v - before[k] for k, v in counts(counters).items()},
                              time.perf_counter() - t0))
        return wrapped

    for name, fn in saved.items():
        setattr(TenantPack, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(TenantPack, name, fn)


def per_generation_launches(outer) -> dict:
    """What the code launches an outer generation of a bucket's segment:
    bucket (A) draws OpenES's normals at each of its 32 inner generations
    (one batched Philox launch over lanes x candidates) and moves the outer
    PSO once (one batched move over the lanes); bucket (B) moves the inner
    PSO at each inner generation but the first (one batched move over lanes
    x candidates) and draws CMA-ES's normals once (one batched launch over
    the lanes)."""
    it = HPO_LADDER["iterations"]
    if outer == "PSO":
        return {"fused_pso_move": 0, "fused_pso_move_batched": 1, "philox_draws": 0, "philox_draws_batched": it}
    return {"fused_pso_move": 0, "fused_pso_move_batched": it - 1, "philox_draws": 0, "philox_draws_batched": 1}


def stack_states(states):
    """States of one structure stacked along a new leading axis."""
    import torch
    from evox_tpu_torch.utils import graph

    spec = graph.flatten(states[0])[1]
    return graph.unflatten(spec, [torch.stack(col) for col in zip(*[graph.flatten(s)[0] for s in states])])


def pack_generation_recorded(pack):
    """One generation of ``pack``'s own segment program, run eagerly
    (uncaptured) on a copy of its carry: every lane, the frozen ones
    included, as its captured segment launches them.  Returns the batched
    moves (``recording_batched_moves``) and the draws
    (``recording_draws``) it launched; the pack's state is left as it
    was."""
    import torch
    from evox_tpu_torch.utils import graph

    leaves, spec = graph.flatten(pack._states)
    carry = (graph.unflatten(spec, [t.clone() for t in leaves]), pack._frozen_dev.clone(),
             torch.zeros((pack.lanes,), dtype=torch.int32, device=pack.device))
    moves, drawn = [], []
    with recording_batched_moves(moves), recording_draws(drawn):
        pack._segment_program(carry, 1)
    torch.cuda.synchronize()
    return moves, drawn


def phase_service_hpo_main_path(device) -> dict:
    """``OptimizationService(lanes_per_pack=4, segment_steps=5,
    HealthProbe(nonfinite_skip=("instances",)))`` with two buckets of HPO
    tenants (``SERVICE_HPO``): (A) 4 x hpo_ladder, (B) 2 x CMA-ES(64) over
    PSO(1024, ±5 in dim 32), budgets of 10 outer generations.  Counted from
    0 over the run, by bucket: each segment's capture (its warm-up and 5
    captured generations) against ``per_generation_launches``, exactly, and
    no launch in a replay; the init programs' (warm-up and capture, the
    nests inline).  One init and one segment capture a bucket, no nest graph
    of its own, one host sync a segment, and a replay's kernels from the
    profiler (move and Philox launches a segment against the code's count).
    Every tenant equal to itself alone (a service of the same width that
    holds one tenant at a time): state, history, newest checkpoint digests,
    ``evox_hpo_inner_generations_total``.  ms an outer generation of each
    pack (the lanes that held its tenants stepping, the padding lanes
    frozen) and of one tenant alone in a width-1 pack, the tenants' inner
    generations/s and the pack's with its padding lanes counted.  Then one
    generation of each pack's own segment program, run eagerly and
    recorded, every lane included: (B)'s inner moves at 4 x 64 instances of
    (1024, 32) and CMA-ES's draws over the 4 lanes, (A)'s outer move at
    (4, 64, 2) and OpenES's draws over 4 x 64 streams, each against its
    plain version: 0 bits off (OpenES draws the half of its population
    that its mirrored samples negate: 512 x 32 normals a candidate)."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.hpo import candidate_series, find_nested
    from evox_tpu_torch.service import TenantStatus

    c, lad = SERVICE_HPO, HPO_LADDER
    seg = c["segment"]
    es = [f"es-{u}" for u in range(c["es_tenants"])]
    cma = [f"cma-{u}" for u in range(c["es_tenants"], c["es_tenants"] + c["cma_tenants"])]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_service_hpo_"))
    try:
        counters = hpo_counters()
        calls: list = []
        svc = hpo_service(root / "packed")
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        with pack_calls(calls):
            for name in es + cma:
                svc.submit(service_hpo_spec(name, device, c["n_steps"]))
            svc.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = counts(counters)
        for name in es + cma:
            expect(svc.tenant(name).status, TenantStatus.COMPLETED, f"service_hpo {name}")
        buckets = {bucket_name(b.pack): b for b in svc._buckets.values()}
        names = {"PSO": f"PSO/{lad['inner_pop']}", "CMAES": f"CMAES/{lad['inner_pop']}"}
        expect(sorted(buckets), sorted(names.values()), "service_hpo buckets")
        per_bucket = {}
        for outer, bname in names.items():
            pack = buckets[bname].pack
            expect(pack.captures, {"init": 1, "segment": 1}, f"service_hpo {bname} captures")
            expect(len(find_nested(pack.workflow.problem)._graphs), 0, f"service_hpo {bname}: nest graphs of its own")
            segs = [d for m, b, d, _ in calls if m == "run_segment" and b == bname]
            inits = [d for m, b, d, _ in calls if m == "init_tenant" and b == bname]
            per_gen = per_generation_launches(outer)
            expect(segs[0], {k: (seg + 1) * v for k, v in per_gen.items()}, f"service_hpo {bname}: the segment's capture")
            for d in segs[1:] + inits[1:]:
                expect(d, dict.fromkeys(d, 0), f"service_hpo {bname}: a replay's wrapper calls")
            per_bucket[bname] = {"segment_capture": segs[0], "init_capture": inits[0], "segments": len(segs),
                                 "init_calls": len(inits),
                                 "capture_s": {m: next(t for mm, b, _, t in calls if mm == m and b == bname)
                                               for m in ("init_tenant", "run_segment")}}
        # The setups' draws: the rest of the run's launches.
        setups = {k: launches[k] - sum(p["segment_capture"][k] + p["init_capture"][k] for p in per_bucket.values())
                  for k in launches}
        inner_total = {name: svc.obs.registry.snapshot()[f'evox_hpo_inner_generations_total{{tenant_id="{name}"}}']
                       for name in es + cma}
        for name, v in inner_total.items():
            expect(v, (svc.tenant(name).generations - 1) * lad["candidates"] * lad["iterations"],
                   f"service_hpo {name}: evox_hpo_inner_generations_total")

        # Each tenant alone: a service of the same width holding only it.
        alone = hpo_service(root / "alone")
        checked = {}
        for name in es + cma:
            alone.submit(service_hpo_spec(name, device, c["n_steps"]))
            alone.run()
            leaves = same_state(svc.result(name), alone.result(name), f"service_hpo {name} vs alone")
            h_got, h_want = svc.tenant(name).monitor.fitness_history, alone.tenant(name).monitor.fitness_history
            expect(len(h_got), len(h_want), f"service_hpo {name}: history entries")
            for g, w in zip(h_got, h_want):
                exact(g, w, f"service_hpo {name}: history")
            expect(tenant_digests(root / "packed", name), tenant_digests(root / "alone", name),
                   f"service_hpo {name}: newest checkpoint's leaf digests")
            series = candidate_series(svc.result(name).problem)
            checked[name] = {"leaves": leaves, "history": len(h_got), "candidates_with_series": len(series),
                             "best_outer": float(svc.result(name).algorithm.fit.min())}

        # The packs: one host sync and the kernels of a replay, then ms an
        # outer generation with the lanes that held the bucket's tenants
        # stepping (the padding lanes frozen: their generations launch all
        # the same, and are selected away).
        held = {bname: sorted({int(lane) for n in (es if outer == "PSO" else cma)
                               for e in svc.tenant(n).events if e.startswith("admitted to lane ")
                               for lane in e.split()[3:4]})
                for outer, bname in names.items()}
        packs = {}
        for outer, bname in names.items():
            pack = buckets[bname].pack
            for lane in range(pack.lanes):
                pack.set_frozen(lane, lane not in held[bname])
            _, syncs = thread_syncs(lambda: pack.run_segment(seg))
            expect(syncs["calling_thread"], 1, f"service_hpo {bname}: host syncs a segment")
            prof = launches_per_call(lambda: pack.run_segment(seg), calls=1, count_names=("pso_move", "philox_draw"))
            per_gen = per_generation_launches(outer)
            want = {"pso_move": seg * per_gen["fused_pso_move_batched"],
                    "philox_draw": seg * per_gen["philox_draws_batched"]}
            expect(prof["named"], want, f"service_hpo {bname}: the move's and Philox's launches in a replay")
            executed = []
            ms, host_ms, _ = timed(lambda: [executed.append(int(pack.run_segment(seg).executed.sum()))
                                            for _ in range(c["timed_segments"])], c["timed_segments"] * seg)
            tenants = len(es) if outer == "PSO" else len(cma)
            expect(len(held[bname]), tenants, f"service_hpo {bname}: lanes that held a tenant")
            expect(sum(executed), c["timed_segments"] * seg * tenants, f"service_hpo {bname}: generations executed")
            inner = sum(executed) * lad["candidates"] * lad["iterations"]
            timed_s = ms * c["timed_segments"] * seg / 1e3
            packs[bname] = {
                "host_syncs_per_segment": syncs["calling_thread"], "replay_launches": prof["named"],
                "device_ops_per_segment": prof["launches"], "device_ms_per_segment": prof["device_ms"],
                "ms_per_outer_gen": ms, "host_ms_per_outer_gen": host_ms, "tenants": tenants,
                "ms_per_outer_gen_per_tenant": ms / tenants,
                "tenant_lanes": held[bname],
                # The tenants' inner generations, and the pack's launched
                # work with its padding lanes' counted too.
                "inner_gens_per_s": inner / timed_s,
                "inner_gens_per_s_all_lanes": pack.lanes * c["timed_segments"] * seg * lad["candidates"]
                * lad["iterations"] / timed_s,
                "idle_share": 1 - prof["device_ms"] / (ms * seg),
                "pool_bytes": graph_pool_bytes(pack._graphs), **per_bucket[bname],
            }
            # One tenant alone in a width-1 pack of the same bucket.
            solo = filled_pack(pack.workflow, 1, [0 if outer == "PSO" else len(es)], device)
            solo.run_segment(seg)
            solo_ms, _, _ = timed(lambda: [solo.run_segment(seg) for _ in range(c["timed_segments"])],
                                  c["timed_segments"] * seg)
            packs[bname]["alone_width1_ms_per_outer_gen"] = solo_ms
            del solo

        # The kernels at the shapes the packs launch them: one generation of
        # each pack's own segment program, run eagerly and recorded, every
        # lane included.
        lanes, cand = c["lanes"], lad["candidates"]
        b_moves, b_drawn = pack_generation_recorded(buckets[names["CMAES"]].pack)
        expect([tuple(a[0].shape) for a, _ in b_moves], [(lanes * cand, lad["inner_pop"], lad["dim"])]
               * (lad["iterations"] - 1), "service_hpo (B): the inner PSO's merged moves of one generation")
        expect([(e[0].shape[0], e[5]) for e in b_drawn], [(lanes, 0)],
               "service_hpo (B): CMA-ES's merged draws of one generation (streams, solo)")
        moves_b = batched_moves_vs_plain(b_moves, "service_hpo (B)")
        if moves_b["distinct_scalar_rows"] < 2:
            raise AssertionError("service_hpo (B): every candidate moved with the same scalars")
        del b_moves
        a_moves, a_drawn = pack_generation_recorded(buckets[names["PSO"]].pack)
        expect([tuple(a[0].shape) for a, _ in a_moves], [(lanes, cand, 2)],
               "service_hpo (A): the outer PSO's merged move of one generation")
        moves_a = batched_moves_vs_plain(a_moves, "service_hpo (A)")
        del a_moves
        expect([(e[0].shape[0], e[3], e[5]) for e in a_drawn],
               [(lanes * cand, lad["inner_pop"] // 2 * lad["dim"], 0)] * lad["iterations"],
               "service_hpo (A): OpenES's merged draws of one generation (streams, normals, solo)")
        # (A)'s first and last draws and (B)'s against the plain version
        # (each of (A)'s 256 streams a plain evaluation of its own).
        draws = draws_on_path("service_hpo", a_drawn[:1] + a_drawn[-1:] + b_drawn)
        draws["recorded"] = {"A": len(a_drawn), "B": len(b_drawn)}
        moves = {"A": moves_a, "B": moves_b}
        del a_drawn, b_drawn
        row = {
            "config": f"OptimizationService(lanes_per_pack={c['lanes']}, segment_steps={seg}): "
                      f"(A) {len(es)} x PSO({lad['candidates']}) over NestedProblem(OpenES({lad['inner_pop']}, "
                      f"zeros({lad['dim']})), Sphere, iterations={lad['iterations']}); (B) {len(cma)} x "
                      f"CMAES(pop {lad['candidates']}, [0.6, 2.0], 0.3) over NestedProblem(PSO({lad['inner_pop']}, "
                      f"±{c['inner_bound']} in dim {lad['dim']}), Sphere, iterations={lad['iterations']}); "
                      f"budgets {c['n_steps']}",
            "launches": launches, "setup_launches": setups, "wall_s": wall_s,
            "segments_run": svc.stats.segments_run, "packs": packs, "checked": checked,
            "inner_generations_total": inner_total,
            "batched_moves_vs_plain": moves, "philox_on_path_vs_plain": draws,
            "max_abs_err": {"fused_pso_move_batched": max(moves_a["max_abs_err"], moves_b["max_abs_err"]),
                            "philox_draws_batched": draws["max_abs_err"]},
        }
        del svc, alone, buckets
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def service_hpo_grow_run(root, device):
    """One run of service_hpo_grow's service: ``es-0`` on a constant-fitness
    inner problem with the growth ladder under a journaled Controller."""
    import torch
    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.core import Problem
    from evox_tpu_torch.hpo import GrowthLadder
    from evox_tpu_torch.service import RequestJournal

    class Flat(Problem):
        def evaluate(self, state, pop):
            return torch.ones(pop.shape[0], device=pop.device), state

    def inner_es(pop):
        return OpenES(pop, torch.zeros(HPO_LADDER["dim"]), learning_rate=0.05, noise_stdev=0.1, device=device)

    g = SERVICE_HPO_GROW
    journal = RequestJournal(Path(root) / "journal.jsonl")
    controller = Controller(journal=journal, grace=2)
    svc = hpo_service(Path(root) / "svc", controller=controller, max_restarts=2)
    ladder = GrowthLadder(inner_factory=inner_es, stagnation_window=g["window"], stagnation_tol=0.0,
                          max_inner_pop=g["max_pop"])
    svc.submit(service_hpo_spec("es-0", device, g["n_steps"], problem=Flat(), grow=ladder))
    calls: list = []
    t0 = time.perf_counter()
    with pack_calls(calls):
        svc.run()
    torch.cuda.synchronize()
    return svc, controller, journal, calls, time.perf_counter() - t0


def phase_service_hpo_grow(device) -> dict:
    """Bucket (A)'s tenant on a constant-fitness inner problem with
    ``GrowthLadder(inner_factory=OpenES, stagnation_window=8,
    stagnation_tol=0, max_inner_pop=2048)`` and a journaled
    ``Controller(grace=2)``: the first boundary's consult fires, the tenant
    re-keys into a bucket of inner population 2048 (its state moved there,
    the outer state kept, the instances rebuilt) and completes; the grown
    bucket captures its segment once, and the nests no graph of their own.
    The journal replays the decisions, and a second run of the service
    gives the grown tenant's state bit for bit.  Launches counted from 0
    over the first run: the grown bucket's segment capture against
    ``per_generation_launches``."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.hpo import find_nested
    from evox_tpu_torch.service import TenantStatus

    g, lad, seg = SERVICE_HPO_GROW, HPO_LADDER, SERVICE_HPO["segment"]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_service_hpo_grow_"))
    try:
        counters = hpo_counters()
        for k in counters.values():
            k.launches = 0
        svc, controller, journal, calls, wall_s = service_hpo_grow_run(root / "a", device)
        launches = counts(counters)
        rec = svc.tenant("es-0")
        expect((rec.status, rec.grows, rec.uid), (TenantStatus.COMPLETED, 1, 0), "service_hpo_grow status, grows, uid")
        expect(find_nested(rec.spec.problem).inner_pop, g["max_pop"], "service_hpo_grow grown inner population")
        buckets = {bucket_name(b.pack): b for b in svc._buckets.values()}
        grown, first = f"PSO/{g['max_pop']}", f"PSO/{lad['inner_pop']}"
        expect(sorted(buckets), sorted([first, grown]), "service_hpo_grow buckets")
        expect(rec.bucket, buckets[grown].key, "service_hpo_grow: the tenant's bucket")
        expect(buckets[first].pack.captures, {"init": 1, "segment": 1}, "service_hpo_grow first bucket's captures")
        expect(buckets[grown].pack.captures["segment"], 1, "service_hpo_grow grown bucket's segment captures")
        if buckets[grown].pack.captures["init"] > 1:
            raise AssertionError(f"service_hpo_grow: grown bucket captures {buckets[grown].pack.captures}")
        for b in buckets.values():
            expect(len(find_nested(b.workflow.problem)._graphs), 0, "service_hpo_grow: nest graphs of their own")
        grown_segs = [d for m, b, d, _ in calls if m == "run_segment" and b == grown]
        expect(grown_segs[0], {k: (seg + 1) * v for k, v in per_generation_launches("PSO").items()},
               "service_hpo_grow: the grown bucket's segment capture")
        fired = [d.to_manifest() for d in controller.decisions if d.kind == "hpo-grow"]
        expect([(d["action"], d["tenant_id"]) for d in fired], [(str(g["max_pop"]), "es-0")],
               "service_hpo_grow decisions")
        records, damage = journal.replay()
        expect(damage, None, "service_hpo_grow journal damage")
        expect([d.to_manifest() for d in Controller.replay_decisions(records)],
               [d.to_manifest() for d in controller.decisions], "service_hpo_grow: the journal's replayed decisions")
        final = svc.result("es-0")
        expect(tuple(final.problem.instances.algorithm.center.shape), (lad["candidates"], lad["dim"]),
               "service_hpo_grow: the grown instances' centers")
        counters_seen = {k: v for k, v in svc.obs.registry.snapshot().items() if k.startswith("evox_hpo_")}
        expect(counters_seen['evox_hpo_grows_total{tenant_id="es-0"}'], 1.0, "evox_hpo_grows_total")
        again, _, _, _, again_s = service_hpo_grow_run(root / "b", device)
        leaves = same_state(again.result("es-0"), final, "service_hpo_grow: two runs of the service")
        events = [e for e in rec.events if "hpo-grow" in e]
        row = {
            "config": f"service_hpo's bucket (A) tenant on a constant-fitness inner problem, "
                      f"GrowthLadder(OpenES, stagnation_window={g['window']}, stagnation_tol=0, "
                      f"max_inner_pop={g['max_pop']}), Controller(grace=2) journaled, budget {g['n_steps']}",
            "launches": launches, "wall_s": wall_s, "second_run_s": again_s, "decisions": fired,
            "events": events, "captures": {k: dict(b.pack.captures) for k, b in buckets.items()},
            "segment_capture_s": {b: next(t for m, bb, _, t in calls if m == "run_segment" and bb == b)
                                  for b in buckets},
            "pool_bytes": {k: graph_pool_bytes(b.pack._graphs) for k, b in buckets.items()},
            "counters": counters_seen, "leaves_equal_across_runs": leaves,
        }
        del svc, again, buckets, final
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def hpo_daemon(root, device, **kw):
    from evox_tpu_torch.resilience import HealthProbe
    from evox_tpu_torch.service import ServiceDaemon

    return ServiceDaemon(root, lanes_per_pack=DAEMON_HPO["lanes"], segment_steps=DAEMON_HPO["segment"],
                         health=HealthProbe(nonfinite_skip=tuple(DAEMON_HPO["nonfinite_skip"])),
                         brownout_threshold=DAEMON_HPO["brownout_threshold"], on_event=lambda msg: None,
                         device=device, **kw)


def phase_daemon_hpo_restart(device) -> dict:
    """``ServiceDaemon(lanes_per_pack=4, segment_steps=5)`` with two
    bucket-(A) HPO tenants and one PSO tenant of daemon_main_path's shape
    (``DAEMON_HPO``, budgets of 20), through daemon_main_path's process
    machinery: uninterrupted here, then a cold process (a copy of the
    package with an empty build/) that submits, steps and dies by
    ``os._exit`` after round 2, and a warm process over the same root that
    replays the journal (the HPO specs decoded with their nests and
    transforms), prewarms both buckets from the program cache (every
    program a hit, no ``nvcc``) and finishes every tenant.  The HPO bucket's
    segment record lists the move's and Philox's libraries.  Every tenant
    then equals the uninterrupted daemon's, state and newest checkpoint
    digests, bit for bit.  Launches counted from 0 over the three
    processes."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.resilience.testing import last_checkpoint_digests, verify_tenants_bit_identical
    from evox_tpu_torch.service import TenantStatus

    pycache = wait_fleet_pycache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_daemon_hpo_"))
    tids = [s.tenant_id for s in daemon_hpo_specs(device)]
    try:
        counters = hpo_counters()
        for k in counters.values():
            k.launches = 0
        ref = hpo_daemon(root / "ref", device)
        t0 = time.perf_counter()
        ref.start()
        for spec in daemon_hpo_specs(device):
            ref.submit(spec)
        rounds = daemon_rounds(ref)
        ref_s = time.perf_counter() - t0
        ref_launches = counts(counters)
        for tid in tids:
            expect(ref.tenant(tid).status, TenantStatus.COMPLETED, f"daemon_hpo_restart {tid}")
        expect(ref.stats.captures, {"init": 2, "segment": 2}, "daemon_hpo_restart captures (two buckets)")
        expected = {tid: ref.result(tid) for tid in tids}
        digests = {tid: last_checkpoint_digests(root / "ref", tid) for tid in tids}

        cold = daemon_child("cold", root / "killed", package_copy(root / "cold_tree"), root, device, DAEMON_HPO,
                            "daemon_hpo")
        warm = daemon_child("warm", root / "killed", package_copy(root / "warm_tree"), root, device, DAEMON_HPO,
                            "daemon_hpo")
        expect((cold["segments"], cold["done"]), (2 * DAEMON_HPO["kill_after"], False), "the cold daemon's segments")
        expect(cold["kernel_builds"]["builds"] >= 1, True, f"the cold daemon's kernel builds {cold['kernel_builds']}")
        hpo_segment = [k for k in cold["records"]
                       if k.startswith(f"pack_segment[PSO[{DAEMON_HPO['hpo_ladder']['candidates']}x2]")]
        expect(len(hpo_segment), 1, f"the cold daemon's HPO segment record among {sorted(cold['records'])}")
        libs = cold["records"][hpo_segment[0]]
        # (A CPU rehearsal loads no library.)
        if device.type == "cuda" and not (any("pso_move" in n for n in libs) and any("philox" in n for n in libs)):
            raise AssertionError(f"the HPO bucket's segment record lists {libs}")
        expect(warm["restored"], len(tids), "tenants the warm daemon replayed")
        expect(warm["kernel_builds"]["builds"], 0, "nvcc builds in the warm daemon")
        expect((warm["cache"]["misses"], warm["cache"]["quarantines"]), (0, 0), "the warm daemon's cache misses, "
               "quarantines")
        expect(warm["cache"]["hits"], len(warm["prewarmed"]), "the warm daemon's cache hits")
        expect(all(warm["prewarmed"].values()), True, "every warm pack program from the cache")
        expect(warm["captures"], {"init": 2, "segment": 2}, "the warm daemon's captures")
        expect(set(warm["statuses"].values()), {"completed"}, "the warm daemon's tenants")
        check = hpo_daemon(root / "killed", device, exec_cache=None)
        check.start()
        check.run()
        verify_tenants_bit_identical(check, root / "killed", expected, digests, "daemon_hpo_restart kill and restart")
        launches = {k: ref_launches[k] + cold["launches"][k] + warm["launches"][k] for k in ref_launches}
        row = {
            "config": f"ServiceDaemon(lanes_per_pack={DAEMON_HPO['lanes']}, segment_steps={DAEMON_HPO['segment']}): "
                      f"{DAEMON_HPO['hpo_tenants']} x hpo_ladder and 1 x PSO pop={DAEMON['pop']} dim={DAEMON['dim']} "
                      f"Ackley, budgets {DAEMON_HPO['n_steps']}; cold process killed after round "
                      f"{DAEMON_HPO['kill_after']}, warm process restarted over the same root",
            "launches": launches, "launches_uninterrupted": ref_launches,
            "uninterrupted": {"seconds": ref_s, "rounds_ms": [t * 1e3 for t in rounds]},
            "time_to_first_segment_s": {"cold": cold["marks"]["first_segment"], "warm": warm["marks"]["first_segment"]},
            "spawn_to_first_segment_s": {"cold": cold["spawn_to_first_segment_s"],
                                         "warm": warm["spawn_to_first_segment_s"]},
            "cold": {k: cold[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "rounds_s",
                                          "records")},
            "warm": {k: warm[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "rounds_s",
                                          "statusz_exec_cache")},
            "bit_identical_tenants": len(tids), "pycache": pycache,
        }
        del ref, check, expected
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- the network front door (Gateway, GatewayClient, FaultyTransport) -----------------

# daemon_main_path's daemon (8 lanes, segments of 25) behind a Gateway with two
# principals; bucket 1 is daemon_main_path's 8 tenants (PSO(1024, ±32 in dim
# 100) on Ackley, budgets 200), bucket 2 two PSO(1024, ±32 in dim 50) tenants
# submitted while bucket 1 serves; a ninth, queued bucket-1 tenant is steered
# over HTTP to ``steer_n_steps`` (bench_gateway's sacrificial tenant).
GATEWAY = dict(DAEMON, second_dim=50, second_tenants=2, steer_n_steps=50)
GATEWAY_TOKENS = {"tok-alice": "alice", "tok-bob": "bob"}
# One FaultyTransport a client thread: each fault once, on its first request.
GATEWAY_FAULTS = [dict(drop_requests=[0]), dict(drop_replies=[0]), dict(torn_replies=[0]),
                  dict(duplicate_requests=[0])]
# gateway_overhead: best of ``repeats`` batches a side, each of 8 measured
# tenants (budgets sized from a warm batch so that a batch runs at least
# ``min_batch_s``) and one queued sacrificial tenant; the operator process
# steers it, reads its status and scrapes /statusz at ``client_hz``.  JAX's
# tools/bench_gateway.py takes 3 repeats; 2 here keep the script inside its
# time limit on a slow host.
GATEWAY_OVERHEAD = dict(repeats=2, min_batch_s=5.0, client_hz=1.0, floor=0.98, calibrate_steps=200)
GATEWAY_REFERENCE: dict = {}

# The 1 Hz operator of gateway_overhead, a process of its own that imports no
# torch (and makes no CUDA context): a steer of the queued sacrificial
# tenant, a status read and a /statusz scrape a tick; it prints its counts
# after every tick.  A 5xx or a failed request is a failure; a 404/409 (the
# sacrificial tenant finished or was retired between batches) is benign.
GATEWAY_OPERATOR = """
import json, sys, time, urllib.error, urllib.request
base, token, target, hz = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
counts = {"mutations": 0, "reads": 0, "benign": 0, "failures": 0, "statuses": {}}
def call(method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Authorization": "Bearer " + token, "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            resp.read()
            code = resp.status
    except urllib.error.HTTPError as e:
        e.read()
        code = e.code
    counts["statuses"][str(code)] = counts["statuses"].get(str(code), 0) + 1
    return code
tick = 0
while True:
    time.sleep(1.0 / hz)
    tick += 1
    for method, path, body, kind in (
            ("POST", "/api/v1/tenants/%s/steer" % target, {"checkpoint_every": 4 if tick % 2 else 8}, "mutations"),
            ("GET", "/api/v1/tenants/" + target, None, "reads"), ("GET", "/statusz", None, "reads")):
        try:
            code = call(method, path, body)
        except Exception:
            counts["failures"] += 1
            continue
        if code < 300:
            counts[kind] += 1
        elif code in (404, 409):
            counts["benign"] += 1
        else:
            counts["failures"] += 1
    print(json.dumps(counts), flush=True)
"""

# One daemon and gateway process over a root, on a fixed port: ``cold``
# serves until the journal append of its ``cfg["tenants"]``-th submit, then
# SIGKILLs itself before the reply leaves (the post-append-pre-reply kill
# point: the hook is this script's, the package knows nothing of it);
# ``warm`` replays the journal, prewarms from the root's program cache and
# serves until the parent creates ``<out>.stop``.  The package is imported
# from ``tree`` (a copy whose build/ is empty).  Each writes a JSON summary
# (the cold one just before its SIGKILL) and ``<out>.ready`` once serving.
GATEWAY_CHILD = """
import json, os, signal, sys, time
t0, wall0 = time.perf_counter(), time.time()
mode, root, tree, out, cfg = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
sys.path.insert(0, tree)
import torch
from evox_tpu_torch.ops import _build, philox, pso_step
from evox_tpu_torch.service import Gateway, ServiceDaemon
marks = {"imported": time.perf_counter() - t0}
device = torch.device(cfg["device"])
daemon = ServiceDaemon(root, lanes_per_pack=cfg["lanes"], segment_steps=cfg["segment"], on_event=lambda msg: None,
                       device=device)
gateway = Gateway(daemon, tokens=cfg["tokens"], port=cfg["port"])
counters = {"fused_pso_move": pso_step.fused_pso_move, "fused_pso_move_batched": pso_step.fused_pso_move_batched,
            "philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}
submits = []


def summary(done):
    c = daemon.exec_cache.stats
    rec = {"mode": mode, "marks": marks, "wall0": wall0, "done": done, "submits": len(submits),
           "restored": daemon.stats.replayed_tenants, "segments": daemon.service.stats.segments_run,
           "captures": daemon.stats.captures, "kernel_builds": dict(_build.counts), "build_dir": str(_build.BUILD_DIR),
           "cache": {"hits": c.hits, "misses": c.misses, "saves": c.saves, "quarantines": c.quarantines},
           "prewarmed": daemon.stats.prewarmed, "launches": {k: v.launches for k, v in counters.items()},
           "statuses": {t: r.status.value for t, r in daemon.service._tenants.items()},
           "gateway": gateway.statusz_payload()}
    with open(out + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(out + ".tmp", out)


if mode == "cold":
    submit = daemon.submit

    def submit_then_die(spec, **kw):
        record = submit(spec, **kw)
        submits.append(time.time())
        if len(submits) == cfg["tenants"]:
            summary(False)
            os.kill(os.getpid(), signal.SIGKILL)
        return record

    daemon.submit = submit_then_die
gateway.start()
marks["serving"] = time.perf_counter() - t0
marks["serving_wall"] = time.time()
with open(out + ".ready", "w") as f:
    json.dump({"pid": os.getpid(), "port": daemon.endpoint.port}, f)
gateway.serve(stop=lambda: os.path.exists(out + ".stop"), idle_sleep=0.02)
summary(True)
"""


def gateway_catalog(spec) -> dict:
    """The JSON catalog form of a ``gateway_specs`` spec."""
    a = spec.algorithm
    return {"tenant_id": spec.tenant_id, "uid": spec.uid, "n_steps": spec.n_steps,
            "algorithm": {"kind": "PSO", "pop_size": a.pop_size, "dim": int(a.lb.numel()), "lb": float(a.lb[0]),
                          "ub": float(a.ub[0])},
            "problem": {"kind": "Ackley"}}


def gateway_daemon(root, device, **kw):
    from evox_tpu_torch.service import ServiceDaemon

    return ServiceDaemon(root, lanes_per_pack=GATEWAY["lanes"], segment_steps=GATEWAY["segment"],
                         on_event=lambda msg: None, device=device, **kw)


def gateway_reference(device, root) -> dict:
    """The Python API's run of every compared tenant (card-built specs, the
    qualified ids and uids the gateway phases mint; ids name namespaces
    only): uid -> (final state, newest checkpoint digests, monitor
    history), computed once."""
    from evox_tpu_torch.resilience.testing import last_checkpoint_digests, npify

    if str(device) not in GATEWAY_REFERENCE:
        ref = gateway_daemon(root, device)
        ref.start()
        specs = daemon_specs(device, range(GATEWAY["tenants"]), GATEWAY["n_steps"], prefix="ref--t")
        specs += daemon_specs(device, range(GATEWAY["tenants"], GATEWAY["tenants"] + GATEWAY["second_tenants"]),
                               GATEWAY["n_steps"], dim=GATEWAY["second_dim"], prefix="ref--w")
        for spec in specs:
            ref.submit(spec)
        ref.run()
        GATEWAY_REFERENCE[str(device)] = {
            s.uid: (ref.result(s.tenant_id), last_checkpoint_digests(root, s.tenant_id),
                    [npify(r) for r in ref.tenant(s.tenant_id).monitor.fitness_history]) for s in specs}
        del ref
    return GATEWAY_REFERENCE[str(device)]


def gateway_vs_reference(daemon, root, ids_by_uid, reference, what) -> int:
    """Each tenant's final state, newest checkpoint digests and monitor
    history on ``daemon`` against the reference of its uid, bit for bit."""
    import numpy as np

    from evox_tpu_torch.resilience.testing import assert_states_equal, last_checkpoint_digests, npify
    from evox_tpu_torch.service import TenantStatus

    for uid, tid in ids_by_uid.items():
        state, digests, history = reference[uid]
        record = daemon.tenant(tid)
        expect(record.status, TenantStatus.COMPLETED, f"{what}: {tid}")
        assert_states_equal(state, daemon.result(tid), f"{what}: {tid}")
        expect(last_checkpoint_digests(root, tid), digests, f"{what}: {tid} newest checkpoint digests")
        got = [npify(r) for r in record.monitor.fitness_history]
        expect(len(got), len(history), f"{what}: {tid} monitor history rows")
        if not all(np.array_equal(g, w) for g, w in zip(got, history)):
            raise AssertionError(f"{what}: {tid} monitor history differs")
    return len(ids_by_uid)


def gateway_client(base_url, token, transport=None, **kw):
    from evox_tpu_torch.service import GatewayClient

    kw.setdefault("backoff", 0.02)
    kw.setdefault("timeout", 120.0)
    return GatewayClient(base_url, token, transport=transport, **kw)


def await_results(client, tenant_ids, timeout_s=300) -> dict:
    """``result?wait=`` for each tenant until it is completed: the result
    documents."""
    deadline, docs = time.monotonic() + timeout_s, {}
    for tid in tenant_ids:
        while True:
            doc = client.result(tid, wait=30)
            if doc["status"] == "completed":
                docs[tid] = doc
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{tid} is {doc['status']} after {timeout_s} s")
    return docs


def npz_vs_disk(client, tid, namespace, doc) -> dict:
    """``result?format=npz`` against the newest checkpoint file on disk, byte
    for byte, and against the result document's name."""
    name, blob = client.result_npz(tid)
    expect(name, doc["checkpoint"], f"{tid}: the npz's name")
    expect(blob == (Path(namespace) / name).read_bytes(), True, f"{tid}: the npz's bytes against {name} on disk")
    return {"name": name, "bytes": len(blob)}


def journal_submits(root) -> dict:
    """The journaled submits of a daemon root, by ``principal:idem``."""
    from evox_tpu_torch.service import RequestJournal, ServiceDaemon

    records, damage = RequestJournal(Path(root) / ServiceDaemon.JOURNAL_NAME).replay(quarantine=False)
    out: dict = {}
    for r in records:
        if r.kind == "submit":
            key = f"{r.data.get('principal')}:{r.data.get('idem')}"
            out[key] = out.get(key, 0) + 1
    return out


def phase_gateway_main_path(device) -> dict:
    """daemon_main_path's daemon (``ServiceDaemon(lanes_per_pack=8,
    segment_steps=25)``, an ``Observability`` with a flight recorder and a
    registry, bucket 1 prewarmed) behind ``Gateway(tokens=)`` with two
    principals, ``gateway.serve(stop=)`` on this thread.  Four client
    threads, two a principal, each a ``GatewayClient`` over
    ``FaultyTransport(HttpTransport)`` (one dropped request, one dropped
    reply, one torn reply, one duplicated request), submit bucket 1's 8
    tenants: 4 built on the CPU (one of them sent in the catalog form) and
    4 on the card.  While bucket 1 serves, two threads submit bucket 2's
    tenants and a third the queued ninth tenant: the second bucket's
    programs are captured under the lock while the other handler threads
    decode on the host.  The ninth tenant's budget is steered over HTTP.
    Then ``result?wait=`` for every tenant, ``result?format=npz`` against
    the newest checkpoint file, one flight long-poll.  Every tenant
    completes; the journal holds one submit a key; every compared tenant's
    state, newest checkpoint digests and history equal the Python API's
    run of the same card-built spec (so the CPU-built and catalog specs
    equal their card-built twins).  The batched move and draws on both
    buckets' final states, and a setup's draws, against their plain
    versions; launches counted from 0 over the served run."""
    import shutil
    import tempfile
    import threading

    import torch
    from evox_tpu_torch.obs import FlightRecorder, MetricsRegistry, Observability
    from evox_tpu_torch.resilience import FaultyTransport
    from evox_tpu_torch.service import Gateway, HttpTransport, OptimizationService
    from evox_tpu_torch.service.tenant import TenantRecord

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gateway_"))
    n1, n2, n_steps = GATEWAY["tenants"], GATEWAY["second_tenants"], GATEWAY["n_steps"]
    try:
        counters = hpo_counters()
        setups = [0]
        real_fresh = OptimizationService._fresh_state

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        # Bucket 1: t0..t7 (uids 0-7), alice t0-t3, bob t4-t7; CPU-built
        # t0, t2 (catalog), t4, t6; bucket 2: w8 (alice), w9 (bob); the ninth
        # bucket-1 tenant q10 (alice).
        principal = {u: "alice" if u < n1 // 2 else "bob" for u in range(n1)}
        principal.update({n1: "alice", n1 + 1: "bob", n1 + n2: "alice"})
        token = {p: t for t, p in GATEWAY_TOKENS.items()}
        card = {s.uid: s for s in daemon_specs(device, range(n1), n_steps)}
        host = {s.uid: s for s in daemon_specs("cpu", range(0, n1, 2), n_steps)}
        catalog_uid = n1 - 2
        second = daemon_specs("cpu", range(n1, n1 + n2), n_steps, dim=GATEWAY["second_dim"], prefix="w")
        ninth = daemon_specs("cpu", [n1 + n2], n_steps, prefix="q")[0]
        qualified = {u: f"{principal[u]}--{s.tenant_id}" for u, s in {**card, n1: second[0], n1 + 1: second[1],
                                                                      n1 + n2: ninth}.items()}
        keys = {u: f"main-{u}" for u in qualified}

        obs = Observability(registry=MetricsRegistry(), flight=FlightRecorder(root / "flight", window=64))
        daemon = gateway_daemon(root / "svc", device, obs=obs, prewarm=[card[0]])
        gateway = Gateway(daemon, tokens=GATEWAY_TOKENS)
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        t_start = time.perf_counter()
        gateway.start()
        prewarm_s = time.perf_counter() - t_start
        stop, errors, acks, latencies, transports = threading.Event(), [], {}, {}, []

        def client_thread(slot, uids):
            try:
                p = "alice" if slot < 2 else "bob"
                transport = FaultyTransport(HttpTransport("127.0.0.1", daemon.endpoint.port), **GATEWAY_FAULTS[slot])
                transports.append(transport)
                client = gateway_client(gateway.url, token[p], transport)
                for u in uids:
                    t0 = time.perf_counter()
                    if u == catalog_uid:
                        acks[u] = client.submit(catalog=gateway_catalog(host[u]), idem_key=keys[u])
                    else:
                        acks[u] = client.submit(host.get(u, card[u]), idem_key=keys[u])
                    latencies[u] = time.perf_counter() - t0
                acks[f"retries{slot}"] = client.retries
            except BaseException as e:  # noqa: BLE001 - raised after the serving loop
                errors.append(e)

        def plain_submit(u, spec):
            try:
                t0 = time.perf_counter()
                acks[u] = gateway_client(gateway.url, token[principal[u]]).submit(spec, idem_key=keys[u])
                latencies[u] = time.perf_counter() - t0
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        reads = {}

        def orchestrate():
            try:
                slots = [[0, 1], [2, 3], [4, 5], [6, 7]]
                threads = [threading.Thread(target=client_thread, args=(i, u)) for i, u in enumerate(slots)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if errors:
                    return
                alice = gateway_client(gateway.url, token["alice"])
                t0 = time.perf_counter()
                reads["first_flight_rows"] = len(alice.flight("t0", after=-1, wait=30))
                reads["first_flight_s"] = time.perf_counter() - t0
                # The second bucket, and the ninth tenant, while bucket 1 serves.
                threads = [threading.Thread(target=plain_submit, args=(s.uid, s)) for s in second + [ninth]]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                if errors:
                    return
                reads["steer"] = alice.steer("q10", n_steps=GATEWAY["steer_n_steps"], idem_key="steer-q10")
                docs = {}
                for u, q in qualified.items():
                    client = gateway_client(gateway.url, token[principal[u]])
                    tid = q.split("--", 1)[1]
                    docs[u] = await_results(client, [tid])[tid]
                    if u != n1 + n2:
                        reads.setdefault("npz", {})[u] = npz_vs_disk(client, tid, daemon.service.namespace(q), docs[u])
                reads["docs"] = docs
                reads["flight_rows"] = len(alice.flight("t0", after=-1, wait=0))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
            finally:
                stop.set()

        conductor = threading.Thread(target=orchestrate)
        conductor.start()
        gateway.serve(stop=stop.is_set, idle_sleep=0.01)
        conductor.join()
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t_start
        OptimizationService._fresh_state = real_fresh
        launches = counts(counters)
        if errors:
            raise errors[0]

        # Exactly once, idempotent replays, the faults as scheduled.
        events = sorted(kind for t in transports for _i, kind in t.events)
        expect(events, ["drop-reply", "drop-request", "duplicate-request", "torn-reply"], "gateway_main_path faults")
        statusz = gateway.statusz_payload()
        expect(statusz["idem_replays"] >= 3, True, f"idempotent replays {statusz['idem_replays']} (lost replies 2, "
               f"duplicates 1)")
        submits = journal_submits(root / "svc")
        expect(sorted(submits), sorted(f"{principal[u]}:{k}" for u, k in keys.items()), "journaled submit keys")
        expect(set(submits.values()), {1}, "journaled submits a key")
        expect(sorted(a["uid"] for u, a in acks.items() if isinstance(u, int)), sorted(qualified), "acked uids")
        expect(reads["steer"]["knobs"], {"n_steps": GATEWAY["steer_n_steps"]}, "the steer's knobs")
        ninth_rec = daemon.tenant(qualified[n1 + n2])
        expect((ninth_rec.status.value, ninth_rec.spec.n_steps), ("completed", GATEWAY["steer_n_steps"]),
               "the steered ninth tenant")
        docs = reads["docs"]
        for u, doc in docs.items():
            expect(len(doc["fitness_history"]), doc["generations"], f"{qualified[u]}: JSON history rows")
            rec = daemon.tenant(qualified[u])
            expect(doc["leaf_digests"] is not None, True, f"{qualified[u]}: leaf digests in the result")
            want = [r.tolist() for r in rec.monitor.fitness_history]
            expect(doc["fitness_history"] == want, True, f"{qualified[u]}: the JSON history against the monitor's")
        on_card = {q: daemon.tenant(q).spec.algorithm.lb.device.type for q in qualified.values()}
        expect(set(on_card.values()), {device.type}, f"the tenants' devices {on_card}")

        # The kernels on both buckets' final states, one setup's draws.
        buckets = list(daemon.service._buckets.values())
        expect(len(buckets), 2, "gateway_main_path buckets")
        for b in buckets:
            expect(b.pack.captures, {"init": 1, "segment": 2}, "gateway_main_path captures a bucket")
        seg, slow = GATEWAY["segment"], GATEWAY["segment"] * daemon.brownout_factor
        expect(launches["fused_pso_move_batched"], 2 * ((seg + 1) + (slow + 1)), "gateway_main_path batched moves")
        expect(launches["fused_pso_move"], 0, "gateway_main_path solo moves")
        seen: list = []
        with recording_draws(seen):
            real_fresh(daemon.service, buckets[0], TenantRecord(spec=daemon.tenant(qualified[0]).spec, uid=0))
        draws = draws_on_path("gateway_main_path setup", seen)
        expect(launches["philox_draws"], setups[0] * draws["calls"], f"gateway_main_path draws ({setups[0]} setups)")
        kernels = {f"bucket{i + 1}": batched_exact_vs_plain(b.pack._states) for i, b in enumerate(buckets)}

        # Bit for bit against the Python API's run of card-built specs.
        reference = gateway_reference(device, root / "ref")
        compared = {u: q for u, q in qualified.items() if u != n1 + n2}
        n_equal = gateway_vs_reference(daemon, root / "svc", compared, reference, "gateway_main_path")
        gateway.close()
        row = {
            "config": f"Gateway(tokens={{2 principals}}) over ServiceDaemon(lanes_per_pack={GATEWAY['lanes']}, "
                      f"segment_steps={seg}): {n1} x PSO pop={GATEWAY['pop']} dim={GATEWAY['dim']} Ackley f32 "
                      f"(4 CPU-built, one as the catalog form, 4 card-built) by 4 client threads over "
                      f"FaultyTransport, {n2} x dim {GATEWAY['second_dim']} mid-run, a steered ninth; budgets "
                      f"{n_steps}",
            "launches": launches, "setups": setups[0], "philox_per_setup": draws["calls"],
            "prewarm_s": prewarm_s, "served_s": served_s,
            "submit_to_ack_s": {str(u): latencies[u] for u in sorted(latencies)},
            "submit_to_ack_s_median": median(list(latencies.values())),
            "first_flight_long_poll_s": reads["first_flight_s"], "flight_rows": reads["flight_rows"],
            "client_retries": {k: v for k, v in acks.items() if not isinstance(k, int)},
            "events": events, "statusz": {k: statusz[k] for k in ("requests", "errors", "idem_replays", "idem_keys",
                                                                 "principals", "retry_after_sent")},
            "npz": {str(u): v for u, v in reads["npz"].items()}, "bit_identical_tenants": n_equal,
            "segments": daemon.service.stats.segments_run, "round_seconds": daemon._last_segment_seconds,
            "kernels": kernels, "philox_on_path_vs_plain": draws,
            "max_abs_err": {k: max(v[k]["max_abs_err"] for v in kernels.values())
                            for k in ("fused_pso_move_batched", "philox_draws_batched")},
        }
        del daemon, gateway, buckets
        torch.cuda.empty_cache()
        return row
    finally:
        OptimizationService._fresh_state = real_fresh
        shutil.rmtree(root, ignore_errors=True)


def gateway_child(mode, root, tree, out_dir, device, port) -> tuple:
    """Start one ``GATEWAY_CHILD`` process; its ``Popen``, the paths of its
    summary, and its spawn time."""
    env = {k: v for k, v in fleet_env().items() if k != "PYTHONPATH"}
    out = Path(out_dir) / f"gateway_{mode}.json"
    cfg = {**GATEWAY, "tokens": GATEWAY_TOKENS, "port": port, "device": str(device)}
    spawned = time.time()
    proc = subprocess.Popen([sys.executable, "-c", GATEWAY_CHILD, mode, str(root), str(tree), str(out),
                             json.dumps(cfg)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, spawned


def await_ready(proc, out, timeout_s=300) -> dict:
    deadline = time.monotonic() + timeout_s
    ready = Path(str(out) + ".ready")
    while not ready.exists():
        if proc.poll() is not None:
            raise AssertionError(f"the gateway process exited {proc.returncode} before serving:\n"
                                 f"{proc.stderr.read()[-3000:]}")
        if time.monotonic() > deadline:
            raise AssertionError(f"the gateway process did not serve within {timeout_s} s")
        time.sleep(0.05)
    return json.loads(ready.read_text())


def phase_gateway_kill_restart(device) -> dict:
    """daemon_child's scheme behind the gateway: a cold process (a copy of
    the package with an empty build/) runs the daemon and gateway on the
    card on a fixed port (``free_coordinator_port``); this process's client
    submits daemon_main_path's 8 tenants (card-built, budgets 200).  The
    cold process SIGKILLs itself after the journal append of the last
    submit, before its reply (its script's hook).  The client keeps
    retrying that key while a warm process (a second such copy) starts over
    the same root and port: its retry comes back ``200`` with
    ``"idempotent_replay": true`` and the original uid, from a process that
    built nothing (every pack program a cache hit).  The journal holds one
    submit a key; ``result?format=npz`` from the warm process equals the
    files on disk; every tenant equals the Python API's run, state and
    newest checkpoint digests, bit for bit."""
    import shutil
    import tempfile
    import threading

    import torch
    from evox_tpu_torch.resilience import free_coordinator_port
    from evox_tpu_torch.resilience.testing import verify_tenants_bit_identical

    pycache = wait_fleet_pycache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gateway_kill_"))
    killed = root / "killed"
    n1 = GATEWAY["tenants"]
    procs = []
    try:
        reference = gateway_reference(device, root / "ref")
        port = free_coordinator_port()
        base = f"http://127.0.0.1:{port}"
        specs = daemon_specs(device, range(n1), GATEWAY["n_steps"])
        keys = [f"kill-{u}" for u in range(n1)]
        cold, cold_out, cold_spawned = gateway_child("cold", killed, package_copy(root / "cold_tree"), root, device,
                                                     port)
        procs.append(cold)
        await_ready(cold, cold_out)
        client = gateway_client(base, "tok-alice", max_retries=400, backoff_cap=0.25)
        acks, acked_at = [], []
        for spec, key in zip(specs[:-1], keys[:-1]):
            acks.append(client.submit(spec, idem_key=key))
            acked_at.append(time.time())
        last: dict = {}

        def retry_last():
            try:
                last["ack"] = client.submit(specs[-1], idem_key=keys[-1])
                last["at"] = time.time()
            except BaseException as e:  # noqa: BLE001 - raised below
                last["error"] = e

        retry = threading.Thread(target=retry_last)
        retry.start()
        cold.wait(timeout=300)
        killed_at = time.time()
        expect(cold.returncode, -9, "the cold gateway process's exit (SIGKILL)")
        cold_rec = json.loads(cold_out.read_text())
        warm, warm_out, warm_spawned = gateway_child("warm", killed, package_copy(root / "warm_tree"), root, device,
                                                     port)
        procs.append(warm)
        await_ready(warm, warm_out)
        retry.join(timeout=300)
        if "error" in last:
            raise last["error"]
        ack = last["ack"]
        expect((ack.get("idempotent_replay"), ack.get("route"), ack.get("uid")), (True, "submit", n1 - 1),
               "the retried submit's ack across the SIGKILL")
        docs = await_results(client, [s.tenant_id for s in specs])
        npz = {s.tenant_id: npz_vs_disk(client, s.tenant_id, killed / "tenants" / f"alice--{s.tenant_id}",
                                        docs[s.tenant_id]) for s in specs}
        Path(str(warm_out) + ".stop").write_text("")
        warm.wait(timeout=120)
        expect(warm.returncode, 0, f"the warm gateway process's exit:\n{warm.stderr.read()[-3000:]}")
        warm_rec = json.loads(warm_out.read_text())
        for rec, tree in ((cold_rec, root / "cold_tree"), (warm_rec, root / "warm_tree")):
            if not rec["build_dir"].startswith(str(tree)):
                raise AssertionError(f"the {rec['mode']} gateway process built into {rec['build_dir']}, not {tree}")
        expect(cold_rec["submits"], n1, "submits journaled by the cold process")
        expect(cold_rec["kernel_builds"]["builds"] >= 1, True, f"the cold process's builds {cold_rec['kernel_builds']}")
        expect(warm_rec["restored"], n1, "tenants the warm process replayed")
        expect(warm_rec["kernel_builds"]["builds"], 0, "nvcc builds in the warm process")
        expect((warm_rec["cache"]["misses"], warm_rec["cache"]["quarantines"]), (0, 0),
               "the warm process's cache misses, quarantines")
        expect(warm_rec["cache"]["hits"], len(warm_rec["prewarmed"]), "the warm process's cache hits")
        expect(all(warm_rec["prewarmed"].values()), True, "every warm pack program from the cache")
        expect(set(warm_rec["statuses"].values()), {"completed"}, "the warm process's tenants")
        expect(warm_rec["gateway"]["idem_replays"] >= 1, True, "the warm gateway's idempotent replays")
        submits = journal_submits(killed)
        expect(submits, {f"alice:{k}": 1 for k in keys}, "journaled submits a key across the SIGKILL")
        check = gateway_daemon(killed, device, exec_cache=None)
        check.start()
        check.run()
        ids = {u: f"alice--t{u}" for u in range(n1)}
        verify_tenants_bit_identical(check, killed, {ids[u]: reference[u][0] for u in ids},
                                     {ids[u]: reference[u][1] for u in ids}, "gateway_kill_restart")
        launches = {k: cold_rec["launches"][k] + warm_rec["launches"][k] for k in cold_rec["launches"]}
        row = {
            "config": f"Gateway over ServiceDaemon(lanes_per_pack={GATEWAY['lanes']}, segment_steps="
                      f"{GATEWAY['segment']}) in a process of its own on a fixed port: {n1} x PSO pop={GATEWAY['pop']} "
                      f"dim={GATEWAY['dim']} Ackley, budgets {GATEWAY['n_steps']}; SIGKILL after the last submit's "
                      f"journal append, warm process over the same root and port",
            "launches": launches,
            "cold_spawn_to_serving_s": cold_rec["marks"]["serving_wall"] - cold_spawned,
            "cold_spawn_to_first_ack_s": acked_at[0] - cold_spawned,
            "warm_spawn_to_serving_s": warm_rec["marks"]["serving_wall"] - warm_spawned,
            "warm_spawn_to_retried_ack_s": last["at"] - warm_spawned,
            "kill_to_retried_ack_s": last["at"] - killed_at,
            "client_retries": client.retries, "retried_ack": ack,
            "cold": {k: cold_rec[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "submits")},
            "warm": {k: warm_rec[k] for k in ("marks", "captures", "kernel_builds", "cache", "launches", "restored",
                                              "gateway")},
            "npz": npz, "bit_identical_tenants": len(ids), "pycache": pycache,
        }
        del check
        torch.cuda.empty_cache()
        return row
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)


def phase_gateway_overhead(device) -> dict:
    """The contract of the JAX package's ``tools/bench_gateway.py`` on the
    card, at daemon_main_path's width: one daemon (flight recorder armed)
    behind a gateway; batches of 8 measured tenants and 1 queued
    sacrificial tenant, submitted over HTTP and served by ``gateway.pump()``
    (the budgets sized from a warm batch so that a batch runs at least
    ``min_batch_s``), then retired; *quiet* batches against *loaded* ones,
    where a separate process that imports no torch steers the sacrificial
    tenant, reads its status and scrapes ``/statusz`` at 1 Hz; best of
    ``repeats`` a side.  The per-tenant generations/s of each side and their ratio are
    printed beside the JAX package's 98 % floor, not gated; the
    submit-to-first-flight latency is printed.  Fails if the operator's
    mutations never landed or any reply was a 5xx."""
    import math
    import shutil
    import tempfile
    import threading

    import torch
    from evox_tpu_torch.obs import FlightRecorder, MetricsRegistry, Observability
    from evox_tpu_torch.service import Gateway, OptimizationService

    cfg = GATEWAY_OVERHEAD
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_gateway_overhead_"))
    token, principal = next(iter(GATEWAY_TOKENS.items()))
    try:
        counters = hpo_counters()
        setups = [0]
        real_fresh = OptimizationService._fresh_state

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        obs = Observability(registry=MetricsRegistry(), flight=FlightRecorder(root / "flight", window=64))
        daemon = gateway_daemon(root / "svc", device, obs=obs, preemption=False)
        gateway = Gateway(daemon, tokens=GATEWAY_TOKENS)
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        gateway.start()
        client = gateway_client(gateway.url, token)
        seg = GATEWAY["segment"]

        def batch(tag, n_steps):
            # uids from the service (retired tenants free theirs).
            specs = daemon_specs(device, range(GATEWAY["tenants"]), n_steps, prefix=f"{tag}-t")
            specs.append(dataclasses.replace(daemon_specs(device, [0], seg)[0], tenant_id=f"{tag}-parked"))
            for spec in specs:
                client.submit(dataclasses.replace(spec, uid=None))
            t0 = time.perf_counter()
            gateway.pump()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            for spec in specs:
                daemon.forget(f"{principal}--{spec.tenant_id}")
            return seconds

        # The budget: a first guess from a warm batch, then scaled by the
        # time of a batch at that guess (a batch's fixed part does not
        # scale, so a shortened budget errs long), with a third in hand for
        # the spread between batches.
        warm_s = batch("warm", cfg["calibrate_steps"])
        guess = seg * math.ceil(cfg["min_batch_s"] * 1.6 * cfg["calibrate_steps"] / warm_s / seg)
        guess_s = batch("calibrate", guess)
        n_steps = seg * math.ceil(guess * 1.35 * cfg["min_batch_s"] / guess_s / seg)

        # Submit to the first flight row visible over HTTP.
        probe = dataclasses.replace(daemon_specs(device, [0], 2 * seg, prefix="probe")[0], uid=None)
        client.submit(probe)
        acked = time.perf_counter()
        pump = threading.Thread(target=gateway.pump)
        pump.start()
        rows = client.flight("probe0", after=-1, wait=60)
        first_flight_s = time.perf_counter() - acked
        pump.join(timeout=120)
        expect(bool(rows), True, "a flight row over HTTP")
        daemon.forget(f"{principal}--probe0")

        seconds = {"quiet": [], "loaded": []}
        operator = {"mutations": 0, "reads": 0, "benign": 0, "failures": 0, "statuses": {}}
        for r in range(cfg["repeats"]):
            seconds["quiet"].append(batch(f"r{2 * r}", n_steps))
            proc = subprocess.Popen([sys.executable, "-c", GATEWAY_OPERATOR, daemon.endpoint.url, token,
                                     f"r{2 * r + 1}-parked", str(cfg["client_hz"])],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                seconds["loaded"].append(batch(f"r{2 * r + 1}", n_steps))
            finally:
                proc.terminate()
                out, err = proc.communicate(timeout=30)
            lines = [ln for ln in out.splitlines() if ln.strip()]
            if lines:
                last = json.loads(lines[-1])
                for k in ("mutations", "reads", "benign", "failures"):
                    operator[k] += last[k]
                for code, n in last["statuses"].items():
                    operator["statuses"][code] = operator["statuses"].get(code, 0) + n
        torch.cuda.synchronize()
        OptimizationService._fresh_state = real_fresh
        launches = counts(counters)
        statusz = gateway.statusz_payload()
        gateway.close()
        expect(min(seconds["quiet"] + seconds["loaded"]) >= cfg["min_batch_s"], True,
               f"every batch at least {cfg['min_batch_s']} s ({seconds})")
        expect(operator["mutations"] > 0, True, f"the operator's mutations landed ({operator})")
        expect(operator["failures"], 0, f"the operator's failures, 5xx replies included ({operator})")
        fives = {k: v for k, v in statusz["requests"].items() if int(k.rsplit(":", 1)[1]) >= 500}
        expect(fives, {}, "5xx replies of the gateway")
        per_tenant = {side: n_steps / min(t) for side, t in seconds.items()}
        row = {
            "config": f"Gateway over ServiceDaemon(lanes_per_pack={GATEWAY['lanes']}, segment_steps={seg}, flight "
                      f"recorder): batches of {GATEWAY['tenants']} x PSO pop={GATEWAY['pop']} dim={GATEWAY['dim']} "
                      f"Ackley, budgets {n_steps}, + 1 queued sacrificial; operator process at {cfg['client_hz']} Hz "
                      f"(steer, status, /statusz); best of {cfg['repeats']} a side",
            "launches": launches, "setups": setups[0], "n_steps": n_steps, "warm_batch_s": warm_s,
            "calibration": {"n_steps": guess, "seconds": guess_s},
            "seconds": seconds, "per_tenant_gen_per_s": per_tenant,
            "throughput_ratio": per_tenant["loaded"] / per_tenant["quiet"], "jax_floor_ratio": cfg["floor"],
            "submit_to_first_flight_s": first_flight_s, "operator": operator,
            "gateway_requests": statusz["requests"],
        }
        del daemon, gateway
        torch.cuda.empty_cache()
        return row
    finally:
        OptimizationService._fresh_state = real_fresh
        shutil.rmtree(root, ignore_errors=True)


GATEWAY_PHASES = ("gateway_main_path", "gateway_kill_restart", "gateway_overhead")


# -- the tenant router and its members (TenantRouter, ServiceMember) -----------

# daemon_main_path's width, none cut: 8 x PSO(1024, ±32 in dim 100) on Ackley,
# budgets 200, segments of 25, over two members of 4 lanes.  The main path
# submits ``first_wave`` tenants, runs a round, submits the rest (bucket
# affinity), runs ``freeze_after`` more rounds, then freezes member 1's beat:
# the staleness threshold is ``dead_rounds`` times the longest round measured
# so far, held for ``freeze_factor`` times that threshold.  The kill process
# runs ``kill_after`` rounds before the last submit.
ROUTER = dict(GATEWAY, members=2, member_lanes=GATEWAY["lanes"] // 2, first_wave=2, freeze_after=2, dead_rounds=2.0,
              freeze_factor=1.5, kill_after=2)
# router_overhead: the contract of the JAX package's tools/bench_router.py
# (direct: one daemon of all the lanes; routed: the lanes split over two
# members, its _SLOS armed on every daemon; alternating batches, best of
# ``repeats`` a side; JAX's FLOOR reported, not gated) at this width, each
# batch sized to at least ``min_batch_s`` on the direct side; 2 repeats where
# JAX's takes 3, to keep the script inside its time limit on a slow host.
ROUTER_OVERHEAD = dict(repeats=2, min_batch_s=5.0, calibrate_steps=200, floor=0.90,
                       slos=dict(segment_seconds=60.0, gens_per_sec=0.001, window_seconds=300.0))

# One router process over two member roots: ``cold`` submits all tenants but
# the last, runs ``cfg["kill_after"]`` rounds, submits the last and SIGKILLs
# itself at that submit's forward, after the router journaled its placement
# (the post-journal-pre-forward kill point: the hook wraps this script's
# ``router.links``, the package knows nothing of it); ``warm`` replays the
# router journal (``start()`` reconciles the unforwarded placement), retries
# the last submit as the client would, and runs every tenant to completion.
# The package is imported from ``tree`` (a copy whose build/ is empty).  Each
# writes a JSON summary (the cold one just before its SIGKILL).
ROUTER_CHILD = """
import json, os, signal, sys, time
t0, wall0 = time.perf_counter(), time.time()
mode, root, tree, out, cfg = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
sys.path.insert(0, tree)
import torch
from evox_tpu_torch.algorithms import PSO
from evox_tpu_torch.ops import _build, philox, pso_step
from evox_tpu_torch.problems.numerical import Ackley
from evox_tpu_torch.service import RequestJournal, ServiceMember, TenantRouter, TenantSpec
marks = {"imported": time.perf_counter() - t0}
device = torch.device(cfg["device"])
sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
members = [ServiceMember(i, os.path.join(root, "m%d" % i), heartbeat_dir=os.path.join(root, "beats"),
                         lanes_per_pack=cfg["member_lanes"], segment_steps=cfg["segment"], on_event=lambda msg: None,
                         device=device) for i in range(cfg["members"])]
router = TenantRouter(os.path.join(root, "router"), members, fleet_dead_after=3600.0, fleet_start_grace=3600.0,
                      on_event=lambda msg: None)
n, d = cfg["pop"], cfg["dim"]
specs = [TenantSpec("t%d" % u, PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device=device), Ackley(),
                    n_steps=cfg["n_steps"], uid=u) for u in range(cfg["tenants"])]
counters = {"fused_pso_move": pso_step.fused_pso_move, "fused_pso_move_batched": pso_step.fused_pso_move_batched,
            "philox_draws": philox.philox_draws, "philox_draws_batched": philox.philox_draws_batched}
forwards, rounds = [], []


def journal_counts():
    out = {"placement": {}, "migration": {}, "submit": {}}
    paths = [os.path.join(root, "router", TenantRouter.JOURNAL_NAME)]
    paths += [os.path.join(root, "m%d" % i, "journal.jsonl") for i in range(cfg["members"])]
    for path in paths:
        for r in RequestJournal(path).replay(quarantine=False)[0]:
            if r.kind in out:
                tid = r.data.get("tenant_id")
                out[r.kind][tid] = out[r.kind].get(tid, 0) + 1
    return out


def summary(done, **extra):
    rec = {"mode": mode, "marks": marks, "wall0": wall0, "done": done, "rounds_s": rounds, "forwards": len(forwards),
           "kernel_builds": dict(_build.counts), "build_dir": str(_build.BUILD_DIR),
           "caches": [{k: getattr(m.daemon.exec_cache.stats, k) for k in ("hits", "misses", "saves", "quarantines")}
                      for m in members],
           "captures": [m.daemon.stats.captures for m in members],
           "prewarmed": [m.daemon.stats.prewarmed for m in members],
           "launches": {k: v.launches for k, v in counters.items()},
           "placements": {t: p["member"] for t, p in router._placements.items()},
           "statuses": {t: router.tenant(t).status.value for t in router._placements if router._tenant_record(t)},
           "journal": journal_counts(), **extra}
    with open(out + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(out + ".tmp", out)


class Link:
    def __init__(self, inner):
        self.inner = inner

    def request(self, method, path, headers, body):
        if path.endswith("/submit"):
            forwards.append(time.time())
            if mode == "cold" and len(forwards) == cfg["tenants"]:
                summary(False)
                os.kill(os.getpid(), signal.SIGKILL)
        return self.inner.request(method, path, headers, body)


for i in list(router.links):
    router.links[i] = Link(router.links[i])
restored = router.start()
sync()
marks["started"] = time.perf_counter() - t0


def one_round():
    t1 = time.perf_counter()
    busy = router.step()
    sync()
    rounds.append(time.perf_counter() - t1)
    if len(rounds) == 1:
        marks["first_round"] = time.perf_counter() - t0
        marks["first_round_wall"] = time.time()
    return busy


if mode == "cold":
    for spec in specs[:-1]:
        router.submit(spec)
    sync()
    marks["submitted"] = time.perf_counter() - t0
    for _ in range(cfg["kill_after"]):
        one_round()
    router.submit(specs[-1])
    raise SystemExit("the last submit's forward did not end the process")
t1 = time.perf_counter()
ack = router.submit(specs[-1])
retried = {"uid": int(ack.uid), "status": ack.status.value, "seconds": time.perf_counter() - t1}
while one_round():
    pass
summary(True, restored=restored, retried=retried)
"""


def router_fleet(root, device, slos=None, router_kw=None, **member_kw):
    """Two ``ServiceMember``s of ``member_lanes`` lanes (roots ``root/m0``,
    ``root/m1``, one heartbeat directory ``root/beats``, seed 0, on
    ``device``) behind a ``TenantRouter`` at ``root/router``; its events
    are collected."""
    from evox_tpu_torch.obs import default_slos
    from evox_tpu_torch.service import ServiceMember, TenantRouter

    root = Path(root)
    members = [ServiceMember(i, root / f"m{i}", heartbeat_dir=root / "beats", lanes_per_pack=ROUTER["member_lanes"],
                             segment_steps=ROUTER["segment"], on_event=lambda msg: None, device=device,
                             **({"slos": default_slos(**slos)} if slos else {}), **member_kw)
               for i in range(ROUTER["members"])]
    events: list = []
    kw = {"fleet_dead_after": 300.0, "fleet_start_grace": 0.0, **(router_kw or {})}
    router = TenantRouter(root / "router", members, on_event=events.append, **kw)
    return router, members, events


def journal_tally(path, kinds) -> dict:
    """Records of ``kinds`` in a journal, by kind and tenant."""
    from evox_tpu_torch.service import RequestJournal

    out: dict = {k: {} for k in kinds}
    for r in RequestJournal(path).replay(quarantine=False)[0]:
        if r.kind in out:
            tid = r.data.get("tenant_id")
            out[r.kind][tid] = out[r.kind].get(tid, 0) + 1
    return out


def router_vs_reference(router, root, ids_by_uid, reference, what, resumed=()) -> int:
    """Each tenant's final state, newest checkpoint digests (in its final
    owner's root) and monitor history against the reference of its uid,
    bit for bit.  A tenant ``resumed`` on another member holds the history
    from its resume point on, which must equal the reference's tail."""
    import numpy as np

    from evox_tpu_torch.resilience.testing import assert_states_equal, last_checkpoint_digests, npify
    from evox_tpu_torch.service import TenantStatus

    for uid, tid in ids_by_uid.items():
        state, digests, history = reference[uid]
        record = router.tenant(tid)
        expect(record.status, TenantStatus.COMPLETED, f"{what}: {tid}")
        assert_states_equal(state, router.result(tid), f"{what}: {tid}")
        owner = router._placements[tid]["member"]
        expect(last_checkpoint_digests(Path(root) / f"m{owner}", tid), digests,
               f"{what}: {tid} newest checkpoint digests")
        got = [npify(r) for r in record.monitor.fitness_history]
        if tid in resumed:
            expect(0 < len(got) < len(history), True, f"{what}: {tid} history rows {len(got)} after its resume")
            history = history[-len(got):]
        expect(len(got), len(history), f"{what}: {tid} monitor history rows")
        if not all(np.array_equal(g, w) for g, w in zip(got, history)):
            raise AssertionError(f"{what}: {tid} monitor history differs")
    return len(ids_by_uid)


def phase_router_main_path(device) -> dict:
    """daemon_main_path's 8 tenants (card-built, budgets 200) through a
    ``TenantRouter`` over two ``ServiceMember``s of 4 lanes each (seed 0,
    segments of 25, distinct roots, one heartbeat directory).  Two tenants
    are submitted, a round runs, then the other six land by bucket
    affinity, 4 / 4; every tenant's ``placement`` record is in the router's
    journal before its forward, and its owner's journal holds one submit.
    A steer is forwarded and journaled on both planes.  After two more
    rounds member 1's beat freezes while member 0 keeps beating, and the
    staleness threshold is tightened to twice the longest round measured:
    the next round declares member 1 dead, journals a ``migration`` for
    each of its tenants, copies their namespaces (equal to the originals)
    and resubmits them on member 0 under their pinned uids; ``/statusz``
    shows member 1 dead, ``/healthz`` is unhealthy with ``dead_members ==
    [1]``.  Every tenant, migrated or not, ends bit-equal to
    gateway_reference's single-daemon run (final state, newest checkpoint
    digests, monitor history).  Launches counted from 0 over the routed
    run; the batched move and draws on both members' final states, and a
    setup's draws, against their plain versions."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.resilience.testing import last_checkpoint_digests
    from evox_tpu_torch.service import OptimizationService, RequestJournal, TenantRouter
    from evox_tpu_torch.service.tenant import TenantRecord

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_router_"))
    n, n_steps, seg = ROUTER["tenants"], ROUTER["n_steps"], ROUTER["segment"]
    real_fresh = OptimizationService._fresh_state
    try:
        reference = gateway_reference(device, root / "ref")
        counters = hpo_counters()
        setups = [0]

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        router, members, events = router_fleet(root, device)
        journal_path = router.root / TenantRouter.JOURNAL_NAME
        # Each member's segment: its daemon's step, the card waited out.
        member_s: list = []
        for m in members:
            def timed_step(real=m.daemon.step, index=m.index):
                t0 = time.perf_counter()
                busy = real()
                torch.cuda.synchronize()
                member_s.append((index, time.perf_counter() - t0))
                return busy

            m.daemon.step = timed_step
        # Journal before forward: every forward finds its decision durable.
        journaled_first, forwarded_at = {}, {}
        real_forward = router._forward_submit

        def checked_forward(placement, *, allow_collision):
            tid = placement["tenant_id"]
            recs = RequestJournal(journal_path).replay(quarantine=False)[0]
            journaled_first[tid] = any(r.kind in ("placement", "migration") and r.data.get("tenant_id") == tid
                                       and r.data.get("member") == placement["member"] for r in recs)
            record = real_forward(placement, allow_collision=allow_collision)
            forwarded_at[tid] = time.perf_counter()
            return record

        router._forward_submit = checked_forward
        verdict: dict = {}
        real_migrate = router._migrate_member

        def timed_migrate(index):
            verdict["index"], verdict["at"] = index, time.perf_counter()
            real_migrate(index)
            verdict["done"] = time.perf_counter()
            # Before the survivor steps: each copied namespace's newest
            # checkpoint equals the dead member's.
            verdict["copies"] = {t: last_checkpoint_digests(root / "m0", t) == last_checkpoint_digests(root / "m1", t)
                                 for t, p in router._placements.items() if p["auto"]}

        router._migrate_member = timed_migrate

        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        t_start = time.perf_counter()
        router.start()
        specs = daemon_specs(device, range(n), n_steps)
        ack_s, rounds = {}, []

        def submit(spec):
            t0 = time.perf_counter()
            record = router.submit(spec)
            torch.cuda.synchronize()
            ack_s[spec.tenant_id] = time.perf_counter() - t0
            expect(int(record.uid), spec.uid, f"router_main_path: {spec.tenant_id}'s acked uid")

        def one_round():
            k = len(member_s)
            t0 = time.perf_counter()
            busy = router.step()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            mem = [s for _, s in member_s[k:]]
            rounds.append({"s": total, "members_s": mem, "router_ms": (total - sum(mem)) * 1e3})
            return busy

        for spec in specs[:ROUTER["first_wave"]]:
            submit(spec)
        one_round()
        affinity = {str(m.index): m.capacity()["free_lanes"] for m in members}
        for spec in specs[ROUTER["first_wave"]:]:
            submit(spec)
        placed = {tid: p["member"] for tid, p in router._placements.items()}
        expect(placed, {f"t{u}": u % 2 for u in range(n)}, "router_main_path placements (4 / 4 by affinity)")
        expect(set(journaled_first.values()), {True}, "router_main_path: a placement journaled before each forward")
        knobs = router.steer("t0", n_steps=n_steps, journal_extra={"idem": "steer-t0", "principal": "chip"})
        expect(knobs, {"n_steps": n_steps}, "router_main_path: the steer's knobs")
        for _ in range(ROUTER["freeze_after"]):
            one_round()

        # Member 1 stops beating; member 0 beats on.  The threshold: twice
        # the longest round so far (a member beats once a round).
        longest = max(r["s"] for r in rounds)
        dead_after = ROUTER["dead_rounds"] * longest
        freeze_s = ROUTER["freeze_factor"] * dead_after
        deadline = time.monotonic() + freeze_s
        while time.monotonic() < deadline:
            members[0].beat()
            time.sleep(0.05)
        router.fleet_dead_after = dead_after
        victims = [f"t{u}" for u in range(1, n, 2)]
        one_round()
        expect(sorted(router._dead), [1], "router_main_path: dead members after the freeze")
        expect({t: router._placements[t]["member"] for t in victims}, {t: 0 for t in victims},
               "router_main_path: the migrated tenants' owner")
        copies = verdict["copies"]
        expect(sorted(copies), victims, "router_main_path: the copied namespaces")
        expect(set(copies.values()), {True}, f"router_main_path: copied namespaces equal their originals {copies}")
        status = router._statusz()
        expect(status["router"]["members"]["1"]["state"], "dead", "router_main_path: member 1's /statusz state")
        expect(len(status["router"]["migrations"]), len(victims), "router_main_path: /statusz migrations")
        healthy, payload = router._healthz()
        expect((healthy, payload["dead_members"]), (False, [1]), "router_main_path: /healthz after the verdict")
        while one_round():
            pass
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t_start
        OptimizationService._fresh_state = real_fresh
        launches = counts(counters)
        expect(sorted(router._dead), [1], "router_main_path: member 0 stayed alive")

        # Exactly once on both planes.
        tally = journal_tally(journal_path, ("placement", "migration", "steer"))
        expect(tally["placement"], {f"t{u}": 1 for u in range(n)}, "router_main_path: placements a tenant")
        expect(tally["migration"], {t: 1 for t in victims}, "router_main_path: migrations a tenant")
        expect(tally["steer"], {"t0": 1}, "router_main_path: router steer records")
        owned = [journal_tally(root / f"m{i}" / "journal.jsonl", ("submit", "steer")) for i in range(2)]
        expect(owned[0]["submit"], {f"t{u}": 1 for u in range(n)}, "router_main_path: member 0's submits")
        expect(owned[1]["submit"], {t: 1 for t in victims}, "router_main_path: member 1's submits")
        expect(owned[0]["steer"], {"t0": 1}, "router_main_path: member 0's steer records")
        captures = [dict(m.daemon.stats.captures) for m in members]
        expect(captures, [{"init": 1, "segment": 2}] * 2, "router_main_path: captures a member (none on migration)")

        # The kernels on both members' final states, one setup's draws.
        seg_slow = seg * members[0].daemon.brownout_factor
        expect(launches["fused_pso_move_batched"], 2 * ((seg + 1) + (seg_slow + 1)), "router_main_path batched moves")
        expect(launches["fused_pso_move"], 0, "router_main_path solo moves")
        packs = [next(iter(m.daemon.service._buckets.values())) for m in members]
        seen: list = []
        with recording_draws(seen):
            real_fresh(members[0].daemon.service, packs[0], TenantRecord(spec=router.tenant("t0").spec, uid=0))
        draws = draws_on_path("router_main_path setup", seen)
        expect(launches["philox_draws"], setups[0] * draws["calls"], f"router_main_path draws ({setups[0]} setups)")
        kernels = {f"member{i}": batched_exact_vs_plain(b.pack._states) for i, b in enumerate(packs)}
        n_equal = router_vs_reference(router, root, {u: f"t{u}" for u in range(n)}, reference, "router_main_path",
                                      resumed=victims)
        both = rounds[1:1 + ROUTER["freeze_after"]]
        after = rounds[1 + ROUTER["freeze_after"] + 1:-1]
        row = {
            "config": f"TenantRouter over {ROUTER['members']} x ServiceMember(lanes_per_pack={ROUTER['member_lanes']}, "
                      f"segment_steps={seg}, seed 0): {n} x PSO pop={ROUTER['pop']} dim={ROUTER['dim']} Ackley f32, "
                      f"budgets {n_steps}, card-built; member 1's beat frozen after "
                      f"{1 + ROUTER['freeze_after']} rounds",
            "launches": launches, "setups": setups[0], "philox_per_setup": draws["calls"],
            "placements": placed, "free_lanes_before_wave_2": affinity,
            "submit_to_ack_s": ack_s, "submit_to_ack_s_median": median(list(ack_s.values())),
            "submit_to_ack_s_median_prewarmed": median([ack_s[f"t{u}"] for u in range(ROUTER["first_wave"], n)]),
            "rounds": rounds,
            "router_ms_per_round_median": median([r["router_ms"] for r in rounds]),
            "router_ms_per_round_two_members": [r["router_ms"] for r in both],
            "router_ms_per_round_survivor": median([r["router_ms"] for r in after]) if after else None,
            "member_segment_ms_median": median([s for r in rounds for s in r["members_s"]]) * 1e3,
            "longest_round_before_freeze_s": longest, "fleet_dead_after_s": dead_after, "freeze_s": freeze_s,
            "verdict_to_resubmit_s": verdict["done"] - verdict["at"],
            "verdict_to_each_resubmit_s": {t: forwarded_at[t] - verdict["at"] for t in victims},
            "events": [e for e in events if "dead" in e or "migrated" in e],
            "captures": captures, "served_s": served_s, "bit_identical_tenants": n_equal,
            "segments": [m.daemon.service.stats.segments_run for m in members],
            "kernels": kernels, "philox_on_path_vs_plain": draws,
            "max_abs_err": {k: max(v[k]["max_abs_err"] for v in kernels.values())
                            for k in ("fused_pso_move_batched", "philox_draws_batched")},
        }
        router.close()
        del router, members, packs
        torch.cuda.empty_cache()
        return row
    finally:
        OptimizationService._fresh_state = real_fresh
        shutil.rmtree(root, ignore_errors=True)


def router_child(mode, root, tree, out_dir, device) -> dict:
    """Run one ``ROUTER_CHILD`` process and read its summary; the seconds
    from its spawn to the end of its first round are added."""
    out = Path(out_dir) / f"router_{mode}.json"
    env = {k: v for k, v in fleet_env().items() if k != "PYTHONPATH"}
    cfg = {**ROUTER, "device": str(device)}
    spawned = time.time()
    proc = subprocess.run([sys.executable, "-c", ROUTER_CHILD, mode, str(root), str(tree), str(out), json.dumps(cfg)],
                          env=env, capture_output=True, text=True, timeout=600)
    want = -9 if mode == "cold" else 0
    if proc.returncode != want:
        raise AssertionError(f"the {mode} router process exited {proc.returncode}, expected {want}:\n"
                             f"{proc.stderr[-3000:]}")
    rec = json.loads(out.read_text())
    rec["spawn_to_first_round_s"] = rec["marks"]["first_round_wall"] - spawned
    if not rec["build_dir"].startswith(str(tree)):
        raise AssertionError(f"the {mode} router process built into {rec['build_dir']}, not its own copy {tree}")
    return rec


def phase_router_kill_restart(device) -> dict:
    """The router and both members in a process of their own, importing a
    copy of the package whose build/ is empty (``ROUTER_CHILD``): the cold
    process submits 7 of the 8 tenants (card-built, budgets 200), runs two
    rounds, submits the eighth and SIGKILLs itself at its forward, after
    the placement was journaled.  A warm process (a second such copy) over
    the same roots calls ``start()``, which restores the placement map and
    forwards the journaled placement; the client's retry of the last submit
    is an idempotent ack with its pinned uid.  That tenant has exactly one
    ``placement`` and one member ``submit``; the warm process makes 0
    ``nvcc`` builds and counts hits on both members' program caches; every
    tenant is bit-equal to gateway_reference's single-daemon run, held by a
    daemon over each member's root."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.resilience.testing import verify_tenants_bit_identical
    from evox_tpu_torch.service import ServiceDaemon

    pycache = wait_fleet_pycache()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_router_kill_"))
    killed = root / "killed"
    n = ROUTER["tenants"]
    last = f"t{n - 1}"
    try:
        reference = gateway_reference(device, root / "ref")
        cold = router_child("cold", killed, package_copy(root / "cold_tree"), root, device)
        warm = router_child("warm", killed, package_copy(root / "warm_tree"), root, device)
        expect((len(cold["rounds_s"]), cold["forwards"], cold["done"]), (ROUTER["kill_after"], n, False),
               "the cold router process's rounds and forwards at its SIGKILL")
        expect((cold["journal"]["placement"].get(last), cold["journal"]["submit"].get(last)), (1, None),
               f"{last} at the SIGKILL: placement journaled, never forwarded")
        expect(cold["kernel_builds"]["builds"] >= 1, True, f"the cold process's builds {cold['kernel_builds']}")
        expect(warm["restored"], n, "placements the warm router restored")
        expect(warm["retried"]["uid"], n - 1, "the retried submit's ack (its pinned uid)")
        expect(warm["journal"]["placement"], {f"t{u}": 1 for u in range(n)}, "router placements a tenant")
        expect(warm["journal"]["submit"], {f"t{u}": 1 for u in range(n)}, "member submits a tenant")
        expect(warm["journal"]["migration"], {}, "migrations")
        expect(warm["placements"], {f"t{u}": u % 2 for u in range(n)}, "the warm router's placement map")
        expect(warm["kernel_builds"]["builds"], 0, "nvcc builds in the warm router process")
        expect([(c["misses"], c["quarantines"], c["hits"] >= 1) for c in warm["caches"]], [(0, 0, True)] * 2,
               "the warm members' cache misses, quarantines and hits")
        expect([all(p.values()) for p in warm["prewarmed"]], [True, True], "every warm pack program from its cache")
        expect(set(warm["statuses"].values()), {"completed"}, "the warm router's tenants")
        n_equal = 0
        for i in range(ROUTER["members"]):
            check = ServiceDaemon(killed / f"m{i}", lanes_per_pack=ROUTER["member_lanes"],
                                  segment_steps=ROUTER["segment"], exec_cache=None, on_event=lambda msg: None,
                                  device=device)
            check.start()
            check.run()
            ids = {u: f"t{u}" for u in range(i, n, 2)}
            verify_tenants_bit_identical(check, killed / f"m{i}", {t: reference[u][0] for u, t in ids.items()},
                                         {t: reference[u][1] for u, t in ids.items()},
                                         f"router_kill_restart member {i}")
            n_equal += len(ids)
            del check
        launches = {k: cold["launches"][k] + warm["launches"][k] for k in cold["launches"]}
        row = {
            "config": f"TenantRouter over {ROUTER['members']} x ServiceMember(lanes_per_pack={ROUTER['member_lanes']}, "
                      f"segment_steps={ROUTER['segment']}) in a process of its own: {n} x PSO pop={ROUTER['pop']} "
                      f"dim={ROUTER['dim']} Ackley, budgets {ROUTER['n_steps']}; SIGKILL at the last submit's forward "
                      f"after {ROUTER['kill_after']} rounds, warm process over the same roots",
            "launches": launches,
            "spawn_to_first_round_s": {"cold": cold["spawn_to_first_round_s"], "warm": warm["spawn_to_first_round_s"]},
            "retried": warm["retried"], "restored": warm["restored"],
            "cold": {k: cold[k] for k in ("marks", "captures", "kernel_builds", "caches", "launches", "rounds_s",
                                          "forwards")},
            "warm": {k: warm[k] for k in ("marks", "captures", "kernel_builds", "caches", "launches", "prewarmed")},
            "warm_round_ms_median": median(warm["rounds_s"][1:-1]) * 1e3,
            "bit_identical_tenants": n_equal, "pycache": pycache,
        }
        torch.cuda.empty_cache()
        return row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_router_overhead(device) -> dict:
    """The contract of the JAX package's ``tools/bench_router.py`` on the
    card, at daemon_main_path's width: *direct*, one daemon of 8 lanes;
    *routed*, the same 8 lanes as two members of 4 behind a
    ``TenantRouter`` (every submit placed and journaled); ``_SLOS`` armed
    on every daemon.  Batches of 8 tenants (budgets sized from a warm
    direct batch so that a direct batch runs at least ``min_batch_s``),
    drained, then forgotten, alternating direct and routed, ``repeats`` a
    side (re-measured once, resized, when a direct batch ran short).  The
    per-tenant gen/s of each side (best batch), their ratio beside JAX's
    ``FLOOR`` of 0.90 (reported, not gated), every batch's value and their
    spread, and the routed members' SLO burn report."""
    import math
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.obs import default_slos
    from evox_tpu_torch.service import OptimizationService, ServiceDaemon, TenantRouter

    cfg = ROUTER_OVERHEAD
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_router_overhead_"))
    n, seg = ROUTER["tenants"], ROUTER["segment"]
    real_fresh = OptimizationService._fresh_state
    try:
        counters = hpo_counters()
        setups = [0]

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        direct = ServiceDaemon(root / "direct", lanes_per_pack=ROUTER["lanes"], segment_steps=seg, preemption=False,
                               slos=default_slos(**cfg["slos"]), on_event=lambda msg: None, device=device)
        router, members, events = router_fleet(root / "fleet", device, slos=cfg["slos"], preemption=False,
                                               router_kw={"fleet_dead_after": 3600.0, "fleet_start_grace": 3600.0})
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        direct.start()
        router.start()
        batches = [0]

        def batch(side, n_steps):
            base = batches[0] * n
            batches[0] += 1
            specs = daemon_specs(device, range(base, base + n), n_steps, prefix=f"b{base // n}-t")
            target = direct if side == "direct" else router
            for spec in specs:
                target.submit(spec)
            t0 = time.perf_counter()
            while target.step():
                pass
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            for spec in specs:
                if side == "direct":
                    direct.forget(spec.tenant_id)
                else:
                    placement = router._placements.pop(spec.tenant_id)
                    router.members[placement["member"]].daemon.forget(spec.tenant_id)
            return seconds

        warm = {side: batch(side, cfg["calibrate_steps"]) for side in ("direct", "routed")}
        guess = seg * math.ceil(cfg["min_batch_s"] * 1.6 * cfg["calibrate_steps"] / warm["direct"] / seg)
        guess_s = batch("direct", guess)
        n_steps = seg * math.ceil(guess * 1.35 * cfg["min_batch_s"] / guess_s / seg)
        # Where the host sped up after the calibration and a direct batch ran
        # shorter than min_batch_s, the budget is sized again from the
        # shortest and the rounds run once more (the first are reported).
        set_aside = []
        while True:
            seconds = {"direct": [], "routed": []}
            for _ in range(cfg["repeats"]):
                for side in ("direct", "routed"):
                    seconds[side].append(batch(side, n_steps))
            shortest = min(seconds["direct"])
            if shortest >= cfg["min_batch_s"] or set_aside:
                break
            set_aside.append({"n_steps": n_steps, "batch_seconds": seconds})
            n_steps = seg * math.ceil(n_steps * 1.35 * cfg["min_batch_s"] / shortest / seg)
        torch.cuda.synchronize()
        OptimizationService._fresh_state = real_fresh
        launches = counts(counters)
        expect(min(seconds["direct"]) >= cfg["min_batch_s"], True,
               f"every direct batch at least {cfg['min_batch_s']} s ({seconds})")
        slow = seg * direct.brownout_factor
        expect(launches["fused_pso_move_batched"], 3 * ((seg + 1) + (slow + 1)),
               "router_overhead batched moves (three packs' prewarms of both cadences)")
        per_batch = {side: [n_steps / s for s in t] for side, t in seconds.items()}
        per_tenant = {side: max(v) for side, v in per_batch.items()}
        spread = {side: (max(v) - min(v)) / min(v) for side, v in per_batch.items()}
        ratio = per_tenant["routed"] / per_tenant["direct"]
        kinds = {k: sum(v.values()) for k, v in
                 journal_tally(router.root / TenantRouter.JOURNAL_NAME, ("placement", "migration", "steer")).items()}
        row = {
            "config": f"direct ServiceDaemon(lanes_per_pack={ROUTER['lanes']}) against TenantRouter over "
                      f"{ROUTER['members']} x ServiceMember(lanes_per_pack={ROUTER['member_lanes']}), segments of "
                      f"{seg}, SLOs {cfg['slos']} on every daemon: batches of {n} x PSO pop={ROUTER['pop']} "
                      f"dim={ROUTER['dim']} Ackley, budgets {n_steps}, alternating, best of {cfg['repeats']} a side",
            "launches": launches, "setups": setups[0], "n_steps": n_steps, "warm_batch_s": warm,
            "calibration": {"n_steps": guess, "seconds": guess_s}, "rounds_set_aside": set_aside,
            # "seconds" is the phase's own (main() adds it).
            "batch_seconds": seconds, "per_batch_gen_per_s": per_batch, "per_tenant_gen_per_s": per_tenant,
            "per_tenant_gen_per_s_median": {side: median(v) for side, v in per_batch.items()},
            "spread": spread, "throughput_ratio": ratio, "jax_floor_ratio": cfg["floor"],
            "ratio_resolved": abs(ratio - 1.0) > max(spread.values()),
            "router_journal_records": kinds,
            "slo_burn_report": {str(m.index): m.daemon.slo.describe() for m in members},
            "rounds": {"direct": direct.service.stats.segments_run,
                       "routed": [m.daemon.service.stats.segments_run for m in members]},
        }
        router.close()
        direct.close()
        del router, members, direct
        torch.cuda.empty_cache()
        return row
    finally:
        OptimizationService._fresh_state = real_fresh
        shutil.rmtree(root, ignore_errors=True)


ROUTER_PHASES = ("router_main_path", "router_kill_restart", "router_overhead")


# -- the chaos conductor and the invariant registry (ChaosConductor) -----------

# The JAX chaos suite's acceptance plan (member and router kills, wire, disk
# and lane faults, a partition window) over three members of the plan's 4
# lanes and segments of 4, budgets of the plan's 8 generations, with
# daemon_main_path's tenant: PSO(1024, ±32 in dim 100) on Ackley, f32.
CHAOS = dict(seed=11, members=3, tenants=8, rounds=7, kills=2, wire=3, disk=2, lanes=1, partitions=1)
# The JAX package's tier-1 soak rung (tools/soak.py's tenant shape, POP=8,
# DIM=4); each wave's allocated card memory is held to the first wave's
# plus CHAOS_SOAK_SLACK.
CHAOS_SOAK = dict(tenants=1000, members=3, wave=250, chaos=True, seed=7)
CHAOS_SOAK_SLACK = 0.10


def chaos_plan():
    from evox_tpu_torch.resilience import ChaosPlan

    return ChaosPlan.from_seed(CHAOS["seed"], **{k: v for k, v in CHAOS.items() if k != "seed"})


def chaos_conductor(root, device):
    """A ``ChaosConductor`` of the acceptance plan on ``device`` whose
    tenants are daemon_main_path's, built on the host (the member link
    carries device-free specs), events collected, not printed."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import ChaosConductor
    from evox_tpu_torch.service import TenantSpec

    plan = chaos_plan()
    n, d = DAEMON["pop"], DAEMON["dim"]
    conductor = ChaosConductor(root, plan, device=device, member_kwargs={"on_event": lambda msg: None},
                               router_kwargs={"on_event": lambda msg: None})
    conductor.spec_factory = lambda index, uid: TenantSpec(
        conductor.tenant_id(index), PSO(n, torch.full((d,), -32.0), torch.full((d,), 32.0), device="cpu"),
        Ackley(), n_steps=plan.n_steps, uid=uid)
    return conductor


@contextlib.contextmanager
def chaos_clocks(conductor, sync):
    """While active: each round's wall seconds, each ``router.step`` and
    each member daemon's ``step`` (with the daemon, its segments before and
    after), each audit and each ``build_audit_context`` (the journals read
    from disk), and each member kill (the abandoned and rebuilt members,
    the card's reserved memory before it) are recorded in the dict it
    yields.  The card is waited out around each."""
    from evox_tpu_torch.resilience import chaos
    from evox_tpu_torch.service import ServiceDaemon, TenantRouter

    rec = {"rounds": [], "router_steps": [], "daemon_steps": [], "audits": [], "contexts": [], "kills": []}
    real = {"round": conductor._round, "audit": conductor._audit, "kill": conductor._kill_member,
            "context": chaos.build_audit_context, "router_step": TenantRouter.step,
            "daemon_step": ServiceDaemon.step}

    def timed(key, fn, *args, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync()
        rec[key].append((t0, time.perf_counter()))
        return out

    def daemon_step(self):
        before = self.service.stats.segments_run
        sync()
        t0 = time.perf_counter()
        busy = real["daemon_step"](self)
        sync()
        rec["daemon_steps"].append((t0, time.perf_counter(), self, before, self.service.stats.segments_run))
        return busy

    def kill(index):
        import torch

        old = conductor.members[index]
        sync()
        reserved = torch.cuda.memory_reserved() if old.daemon.device.type == "cuda" else None
        t0 = time.perf_counter()
        real["kill"](index)
        sync()
        new = conductor.members[index]
        rec["kills"].append({"index": index, "at": t0, "rebuilt_s": time.perf_counter() - t0, "round": conductor.round,
                             "old": old, "old_segments": old.daemon.service.stats.segments_run, "new": new,
                             "restored": len(new.daemon.service._tenants),
                             "completed_at_kill": sum(r.status.value == "completed"
                                                      for r in old.daemon.service._tenants.values()),
                             "reserved_before": reserved})

    conductor._round = lambda r, new: timed("rounds", real["round"], r, new)
    conductor._audit = lambda: timed("audits", real["audit"])
    conductor._kill_member = kill
    chaos.build_audit_context = lambda *a, **kw: timed("contexts", real["context"], *a, **kw)
    TenantRouter.step = lambda self: timed("router_steps", real["router_step"], self)
    ServiceDaemon.step = daemon_step
    try:
        yield rec
    finally:
        for name in ("_round", "_audit", "_kill_member"):
            conductor.__dict__.pop(name, None)
        chaos.build_audit_context = real["context"]
        TenantRouter.step = real["router_step"]
        ServiceDaemon.step = real["daemon_step"]


def chaos_timings(rec) -> dict:
    """A round's wall seconds, the router's own ms a round (its step less
    its members' steps), the audit's and its journal reads' ms, and for
    each kill: the seconds of the rebuild (a member over the same root, its
    journal replayed, its programs prewarmed), to the end of the rebuilt
    member's first step and of its first segment (``None`` when every
    tenant it restored had completed before the kill: each resumes from its
    checkpoint at its budget and completes with no segment), the tenants it
    restored and those the abandoned member had completed."""
    def ms(spans):
        return [(b - a) * 1e3 for a, b in spans]

    router_ms = []
    for a, b in rec["router_steps"]:
        inner = sum(d1 - d0 for d0, d1, *_ in rec["daemon_steps"] if a <= d0 and d1 <= b)
        router_ms.append((b - a - inner) * 1e3)
    kills = {}
    for k in rec["kills"]:
        steps = [(d1, after > before) for d0, d1, daemon, before, after in rec["daemon_steps"]
                 if daemon is k["new"].daemon]
        segment = next((d1 for d1, ran in steps if ran), None)
        kills[str(k["index"])] = {"round": k["round"], "rebuild_s": k["rebuilt_s"],
                                  "to_first_step_s": steps[0][0] - k["at"] if steps else None,
                                  "to_first_segment_s": None if segment is None else segment - k["at"],
                                  "restored": k["restored"], "completed_at_kill": k["completed_at_kill"]}
    rounds_s = [b - a for a, b in rec["rounds"]]
    return {"round_s": rounds_s, "round_s_median": median(rounds_s), "router_ms": router_ms,
            "router_ms_median": median(router_ms), "audit_ms": ms(rec["audits"]),
            "audit_ms_median": median(ms(rec["audits"])), "audit_context_ms": ms(rec["contexts"]),
            "audit_context_ms_median": median(ms(rec["contexts"])), "kills": kills}


def chaos_report_checks(report, what) -> None:
    expect((len(report.violations), report.completed, report.tenants, report.pending, report.acks),
           (0, CHAOS["tenants"], CHAOS["tenants"], 0, CHAOS["tenants"]),
           f"{what}: violations, completed, tenants, pending, acks")


def phase_chaos_main_path(device) -> dict:
    """The JAX chaos suite's acceptance plan (``ChaosPlan.from_seed(11,
    members=3, tenants=8, rounds=7, kills=2, wire=3, disk=2, lanes=1,
    partitions=1)``: the router journal's and member 2's stores fail a
    save each, member 0's link drops a request and member 2's duplicates
    one, member 2 is partitioned over rounds 3-4, member 1 is killed at
    round 4 and member 0 at round 5, tenant 7's lane plateaus) conducted
    over three ``ServiceMember``s of 4 lanes on the card, with
    daemon_main_path's tenant.  Launches counted from 0 over that run (A).
    It must end with 0 violations, 8 completed, 0 pending and 8 acks; a
    second run over a fresh root (B) and a run on the CPU must write the
    same ``chaos_events.jsonl``, byte for byte; each tenant's final state
    must equal the same spec (its lane-fault wrapper included) in one
    fault-free ``ServiceDaemon`` on the card, bit for bit.  The abandoned
    members never step again, no member is declared dead, no kernel is
    built after the first member's, tenant 7's faulted bucket is captured.
    The batched move and draws on every live member's packs, and a setup's
    draws, against their plain versions."""
    import shutil
    import tempfile

    import torch
    from evox_tpu_torch.ops import _build
    from evox_tpu_torch.resilience.testing import assert_states_equal
    from evox_tpu_torch.service import OptimizationService, ServiceDaemon, TenantStatus
    from evox_tpu_torch.service.daemon import _decode_spec
    from evox_tpu_torch.service.router import _link_blob
    from evox_tpu_torch.service.tenant import TenantRecord

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    real_fresh = OptimizationService._fresh_state
    try:
        counters = hpo_counters()
        setups = [0]

        def counting_fresh(self, bucket, record):
            setups[0] += 1
            return real_fresh(self, bucket, record)

        conductor = chaos_conductor(root / "a", device)
        builds_before = dict(_build.counts)
        OptimizationService._fresh_state = counting_fresh
        for c in counters.values():
            c.launches = 0
        with chaos_clocks(conductor, torch.cuda.synchronize) as rec:
            report = conductor.run()
        torch.cuda.synchronize()
        OptimizationService._fresh_state = real_fresh
        launches = counts(counters)
        reserved_after = torch.cuda.memory_reserved()
        chaos_report_checks(report, "chaos_main_path A")
        builds_after = dict(_build.counts)
        kills = rec["kills"]
        expect([(k["round"], k["index"]) for k in kills], [(4, 1), (5, 0)], "chaos_main_path: the kills")
        # Every kernel was built before the phase: no member, first or
        # rebuilt, builds one (the rebuilt ones' programs come from the cache).
        expect(builds_after["builds"], builds_before["builds"], "chaos_main_path: nvcc builds during the run")
        # The abandoned members never stepped again; every member alive.
        expect([k["old"].daemon.service.stats.segments_run for k in kills], [k["old_segments"] for k in kills],
               "chaos_main_path: the abandoned members' segments after their kill")
        expect(any(d is k["old"].daemon for k in kills for _, t1, d, *_ in rec["daemon_steps"] if t1 > k["at"]),
               False, "chaos_main_path: an abandoned daemon stepped after its kill")
        router = conductor.router
        expect((sorted(router._dead), len(router._migrations)), ([], 0), "chaos_main_path: dead members, migrations")
        expect({m.daemon.device.type for m in conductor.members.values()}, {device.type}, "chaos_main_path: devices")
        # Tenant 7's plateau runs inside its member's captured segment.
        faulted = conductor.tenant_id(int(next(iter(conductor.plan.lane_faults))))
        owner = conductor.members[router._placements[faulted]["member"]]
        bucket = owner.daemon.service._buckets[owner.daemon.tenant(faulted).bucket]
        expect((bucket.pack.capturable, bucket.pack.captures["segment"] >= 1), (True, True),
               f"chaos_main_path: {faulted}'s faulted bucket captured")
        faulted_bucket = {"tenant": faulted, "member": owner.index, "captures": dict(bucket.pack.captures)}
        captures = {str(i): dict(m.daemon.stats.captures) for i, m in sorted(conductor.members.items())}
        abandoned_captures = {str(k["index"]): dict(k["old"].daemon.stats.captures) for k in kills}
        cache = conductor.exec_cache.stats
        seen: list = []
        first = next(iter(conductor.members[0].daemon.service._buckets.values()))
        with recording_draws(seen):
            real_fresh(conductor.members[0].daemon.service, first,
                       TenantRecord(spec=router.tenant(conductor.tenant_id(0)).spec, uid=0))
        draws = draws_on_path("chaos_main_path setup", seen)
        expect(launches["philox_draws"], setups[0] * draws["calls"], f"chaos_main_path draws ({setups[0]} setups)")
        expect(launches["fused_pso_move_batched"] > 0, True, f"chaos_main_path batched moves {launches}")
        # A rebuilt member whose tenants had all completed replays them
        # from its journal without filling a pack: its packs hold no state,
        # and the abandoned member's packs hold its lanes' last states.
        kernels = {f"{tag}{i}/bucket{n}": batched_exact_vs_plain(b.pack._states)
                   for tag, fleet in (("member", sorted(conductor.members.items())),
                                      ("abandoned", [(k["index"], k["old"]) for k in kills]))
                   for i, m in fleet
                   for n, b in enumerate(m.daemon.service._buckets.values()) if b.pack._states is not None}
        expect(len(kernels) >= 1, True, "chaos_main_path: packs with states")
        timings = chaos_timings(rec)
        # Read as the first kill began and once the run (both kills) ended.
        reserved = {"before_first_kill": kills[0]["reserved_before"], "after_both_kills": reserved_after}

        # B: the same plan over a fresh root; then the plan on the CPU.
        conductor_b = chaos_conductor(root / "b", device)
        report_b = conductor_b.run()
        conductor_b.close()
        chaos_report_checks(report_b, "chaos_main_path B")
        expect(report_b.event_log_sha256, report.event_log_sha256, "chaos_main_path: B's event log")
        t0 = time.perf_counter()
        conductor_cpu = chaos_conductor(root / "cpu", torch.device("cpu"))
        report_cpu = conductor_cpu.run()
        cpu_s = time.perf_counter() - t0
        conductor_cpu.close()
        chaos_report_checks(report_cpu, "chaos_main_path on the CPU")
        log = Path(report.event_log).read_bytes()
        expect(Path(report_cpu.event_log).read_bytes(), log, "chaos_main_path: the CPU run's event log bytes")

        # Each tenant against the same spec in one fault-free daemon.
        ref = ServiceDaemon(root / "ref", lanes_per_pack=conductor.plan.lanes_per_pack,
                            segment_steps=conductor.plan.segment_steps, seed=0, exec_cache=None,
                            brownout_threshold=None, preemption=False, on_event=lambda msg: None, device=device)
        for index in range(conductor.plan.tenants):
            ref.submit(_decode_spec(_link_blob(conductor._spec(index)), device))
        ref.run()
        tids = [conductor.tenant_id(i) for i in range(conductor.plan.tenants)]
        for tid in tids:
            expect(ref.tenant(tid).status, TenantStatus.COMPLETED, f"chaos_main_path reference {tid}")
            assert_states_equal(ref.result(tid), router.result(tid), f"chaos_main_path {tid} against alone")
        row = {
            "config": f"ChaosConductor: ChaosPlan.from_seed({CHAOS['seed']}, members={CHAOS['members']}, tenants="
                      f"{CHAOS['tenants']}, rounds={CHAOS['rounds']}, kills={CHAOS['kills']}, wire={CHAOS['wire']}, "
                      f"disk={CHAOS['disk']}, lanes={CHAOS['lanes']}, partitions={CHAOS['partitions']}) over "
                      f"ServiceMember(lanes_per_pack={conductor.plan.lanes_per_pack}, segment_steps="
                      f"{conductor.plan.segment_steps}) x {CHAOS['members']}: PSO pop={DAEMON['pop']} dim="
                      f"{DAEMON['dim']} Ackley f32, budgets {conductor.plan.n_steps}",
            "launches": launches, "setups": setups[0], "philox_per_setup": draws["calls"],
            "report": {k: getattr(report, k) for k in ("rounds_run", "completed", "acks", "pending",
                                                       "injected_events", "plan_digest", "event_log_sha256",
                                                       "counters", "elapsed_seconds")},
            "events": [json.loads(line) for line in log.decode().splitlines()],
            "b_elapsed_seconds": report_b.elapsed_seconds, "cpu_run_s": cpu_s,
            "worst_burn_rate": report.slo_burn_report["worst_burn_rate"],
            **timings, "memory_reserved": reserved,
            "memory_reserved_gb": {k: gb(v) for k, v in reserved.items()},
            "captures": captures, "abandoned_captures": abandoned_captures, "faulted_bucket": faulted_bucket,
            "exec_cache": {"hits": cache.hits, "misses": cache.misses, "saves": cache.saves},
            "kernel_builds": {"before": builds_before, "after": builds_after},
            "bit_identical_tenants": len(tids),
            "kernels": kernels, "philox_on_path_vs_plain": draws,
            "max_abs_err": {k: max(v[k]["max_abs_err"] for v in kernels.values())
                            for k in ("fused_pso_move_batched", "philox_draws_batched")},
        }
        conductor.close()
        del conductor, conductor_b, conductor_cpu, ref, router, rec, kills, first, bucket, owner
        torch.cuda.empty_cache()
        return row
    finally:
        OptimizationService._fresh_state = real_fresh
        shutil.rmtree(root, ignore_errors=True)


def phase_chaos_soak(device) -> dict:
    """``tools/soak_torch.py``'s ``run_soak`` on the card at the JAX
    package's tier-1 rung: 1000 tenants of PSO(8, ±32 in dim 4) on Ackley
    through three members of 16 lanes, in waves of 250, with the seeded
    member kill; the checks of the JAX suite's ``_assert_soak_green``,
    4 waves and injected events, then the card's: no member build captures
    again after its first wave (none a wave or a tenant), and each wave's
    allocated card memory (after a cycle collection, less what was
    allocated before the run) within the first wave's plus 10 %.  Launches
    counted from 0 over the run; the batched move and draws on the members'
    packs after the last wave against their plain versions."""
    import gc
    import shutil
    import tempfile

    import torch

    sys.path.insert(0, str(Path(ROOT) / "tools"))
    import soak_torch

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_soak_"))
    counters = hpo_counters()
    waves: list = []
    builds: dict = {}
    kernels: dict = {}

    def on_wave(w, fleet, router):
        torch.cuda.synchronize()
        gc.collect()
        waves.append({"wave": w, "at": time.perf_counter(), "allocated": torch.cuda.memory_allocated(),
                      "reserved": torch.cuda.memory_reserved(), "placed": len(router._placements)})
        if w == -(-CHAOS_SOAK["tenants"] // CHAOS_SOAK["wave"]) - 1:
            # The comparisons' launches are not the path's.
            on_path = counts(counters)
            kernels.update({f"member{i}/bucket{n}": batched_exact_vs_plain(b.pack._states)
                            for i, m in sorted(fleet.items())
                            for n, b in enumerate(m.daemon.service._buckets.values())})
            for k, c in counters.items():
                c.launches = on_path[k]
        for i, m in sorted(fleet.items()):
            b = builds.setdefault(id(m.daemon), {"member": i, "first_wave": w, "captures": []})
            b["captures"].append(dict(m.daemon.stats.captures))
            expect(m.daemon.device.type, device.type, f"chaos_soak member {i}'s device")

    try:
        torch.cuda.synchronize()
        gc.collect()
        base = torch.cuda.memory_allocated()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        report = soak_torch.run_soak(root, device=device, on_wave=on_wave, **CHAOS_SOAK)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts(counters)
        tenants, wave = CHAOS_SOAK["tenants"], CHAOS_SOAK["wave"]
        expect((report["violations"], report["completed"], report["tenants"]), ([], tenants, tenants),
               "chaos_soak: violations, completed, tenants")
        expect(report["peak_resident_namespaces"] <= wave, True,
               f"chaos_soak: peak resident namespaces {report['peak_resident_namespaces']}")
        expect(report["final_resident_namespaces"], 0, "chaos_soak: final resident namespaces")
        expect({"metric", "value", "platform", "slo_burn_report"} <= set(report), True, "chaos_soak: report keys")
        expect((report["value"] > 0, report["platform"]), (True, device.type), "chaos_soak: value, platform")
        json.loads(json.dumps(report))
        expect((report["waves"], report["injected_events"] > 0), (4, True), "chaos_soak: waves, injected events")
        for b in builds.values():
            expect(all(c == b["captures"][0] for c in b["captures"]), True,
                   f"chaos_soak: member {b['member']}'s captures by wave from wave {b['first_wave']}: {b['captures']}")
        held = [w["allocated"] - base for w in waves]
        expect(all(h <= held[0] * (1 + CHAOS_SOAK_SLACK) for h in held), True,
               f"chaos_soak: allocated card memory by wave less {base} before the run: {held}")
        # Each member build prewarms both cadences of its one bucket: a
        # warm-up generation and the captured ones, segments of 4 and the
        # brown-out's 8.
        expect((launches["fused_pso_move_batched"], launches["fused_pso_move"]), (((4 + 1) + (8 + 1)) * len(builds), 0),
               f"chaos_soak launches {launches}")
        starts = [t0] + [w["at"] for w in waves[:-1]]
        row = {
            "config": f"tools/soak_torch.py run_soak(tenants={tenants}, members={CHAOS_SOAK['members']}, wave={wave}, "
                      f"chaos=True, seed={CHAOS_SOAK['seed']}): PSO pop={soak_torch.POP} dim={soak_torch.DIM} "
                      f"Ackley f32, 16 lanes, segments of 4, budgets 4",
            "launches": launches, "run_s": run_s,
            "report": {k: v for k, v in report.items() if k != "slo_burn_report"},
            "tenants_per_s": report["value"], "worst_burn_rate": report["slo_burn_report"]["worst_burn_rate"],
            "wave_s": [w["at"] - s for w, s in zip(waves, starts)],
            "allocated_before": base, "allocated_by_wave": [w["allocated"] for w in waves], "held_by_wave": held,
            "reserved_by_wave": [w["reserved"] for w in waves],
            "captures_by_build": [{"member": b["member"], "first_wave": b["first_wave"], "captures": b["captures"][-1]}
                                  for b in builds.values()],
            "kernels": kernels,
            "max_abs_err": {k: max(v[k]["max_abs_err"] for v in kernels.values())
                            for k in ("fused_pso_move_batched", "philox_draws_batched")},
        }
        del waves[:], builds
        torch.cuda.empty_cache()
        return row
    finally:
        sys.path.remove(str(Path(ROOT) / "tools"))
        shutil.rmtree(root, ignore_errors=True)


CHAOS_PHASES = ("chaos_main_path", "chaos_soak")


def _steps(wf, s, n):
    for _ in range(n):
        s = wf.step(s)
    return s


# ---------------------------------------------------------------------------
# Slice 25: vis_tools, EvalMonitor.plot and the extension autoloader.
# ---------------------------------------------------------------------------

VIS_QUICKSTART_GENS = 100  # README quick start: 100 eager steps, then monitor.plot()
VIS_NSGA2_GENS = 20  # the NSGA-II headline as run(20)
VIS_TURNS = 3  # timed replays of run(20), with and without the full histories in turns
EXT_ALGORITHM = '''
from evox_tpu_torch.algorithms import PSO


class HalfInertiaPSO(PSO):
    """PSO with an inertia weight of 0.3."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, w=0.3, **kwargs)
'''
EXT_CHILD = r'''
import json, sys
import torch
import evox_tpu_torch
from evox_tpu_torch.ops.pso_step import fused_pso_move
from evox_tpu_torch.problems.numerical import Ackley
from evox_tpu_torch.workflows import StdWorkflow

Algo = evox_tpu_torch.algorithms.HalfInertiaPSO
assert issubclass(Algo, evox_tpu_torch.Algorithm) and "HalfInertiaPSO" in evox_tpu_torch.algorithms.__all__
wf = StdWorkflow(Algo(1024, -32 * torch.ones(100), 32 * torch.ones(100)), Ackley())
state = wf.init_step(wf.init(0))
fused_pso_move.launches = 0
state = wf.step(state)
torch.cuda.synchronize()
algo = state.algorithm
print(json.dumps({
    "class": f"{Algo.__module__}.{Algo.__qualname__}", "device": str(algo.pop.device),
    "w": float(algo.w), "launches": fused_pso_move.launches, "shape": list(algo.pop.shape),
    "finite": bool(torch.isfinite(algo.pop).all()) and bool(torch.isfinite(algo.fit).all()),
    "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "evox_tpu", "evox_tpu_ext")),
}))
'''


@contextlib.contextmanager
def plotly_as(module):
    """``import plotly.graph_objects`` gives ``module`` inside the block;
    with ``None``, it raises ImportError (no plotly importable)."""
    saved = {k: sys.modules.get(k) for k in ("plotly", "plotly.graph_objects")}
    parent = None
    if module is not None:
        import types

        parent = types.ModuleType("plotly")
        parent.graph_objects = module
    sys.modules["plotly"], sys.modules["plotly.graph_objects"] = parent, module
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def recording_plotly():
    """A stand-in for ``plotly.graph_objects`` whose traces, frames and
    layouts are dicts of their arguments and whose figures keep ``data``,
    ``frames`` and ``layout`` (the card machine has no plotly)."""
    import types

    class _Trace(dict):
        def __init__(self, **kw):
            super().__init__(**kw)

    class Figure:
        def __init__(self, data=None, frames=None, layout=None):
            self.data, self.frames, self.layout = data, frames, layout

    go = types.ModuleType("plotly.graph_objects")
    for name in ("Scatter", "Scatter3d", "Histogram", "Frame", "Layout"):
        setattr(go, name, type(name, (_Trace,), {}))
    go.Figure = Figure
    return go


def real_plotly_version():
    try:
        import plotly
    except ImportError:
        return None
    return getattr(plotly, "__version__", "unknown")


def same_array(got, want, what) -> None:
    """Raise unless ``got`` (from a figure) equals ``want`` in dtype,
    shape and every value."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape or not np.array_equal(got, want, equal_nan=True):
        raise AssertionError(f"{what}: {got.dtype}{list(got.shape)} differs from {want.dtype}{list(want.shape)}")


def vis_quickstart(device) -> dict:
    """README quick start №1 to its end on the card: PSO(100, ±32, dim 10)
    on Ackley with an EvalMonitor, 100 eager steps, then ``monitor.plot()``:
    without plotly a warning and ``None`` (and ``vis_tools.plot`` raises
    ImportError), under the stand-in a figure whose traces are the
    history's."""
    import warnings

    import numpy as np
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.ops.philox import philox_draws
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.vis_tools import plot
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    fused_pso_move.launches = philox_draws.launches = 0
    monitor = EvalMonitor()
    workflow = StdWorkflow(PSO(pop_size=100, lb=-32 * torch.ones(10), ub=32 * torch.ones(10), device=device),
                           Ackley(), monitor=monitor)
    state = workflow.init_step(workflow.init(42))
    best0 = float(monitor.get_best_fitness(state.monitor))
    for _ in range(VIS_QUICKSTART_GENS):
        state = workflow.step(state)
    best = float(monitor.get_best_fitness(state.monitor))
    launches = {"fused_pso_move": fused_pso_move.launches, "philox_draws": philox_draws.launches}
    expect(launches["fused_pso_move"], VIS_QUICKSTART_GENS, "vis quick start: fused_pso_move launches")
    expect(state.algorithm.pop.device.type, torch.device(device).type, "vis quick start: the population's device")
    if not best < best0:
        raise AssertionError(f"vis quick start: the best fitness did not fall: {best0} -> {best}")

    with plotly_as(None), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fig = monitor.plot()
        try:
            plot.plot_obj_space_1d([torch.zeros(4)])
        except ImportError as e:
            refused = str(e)
        else:
            raise AssertionError("vis_tools.plot.plot_obj_space_1d ran without plotly")
    warned = [str(w.message) for w in caught]
    expect(fig, None, "vis quick start: monitor.plot() without plotly")
    expect(len(warned) == 1 and warned[0].startswith("No visualization tool available"), True,
           f"vis quick start: the warning without plotly: {warned}")

    with plotly_as(recording_plotly()):
        anim, static = monitor.plot(), monitor.plot(animation=False)
    hist = [f.numpy() for f in monitor.get_fitness_history()]
    expect(len(hist), VIS_QUICKSTART_GENS + 1, "vis quick start: generations recorded")
    expect(len(anim.frames), len(hist), "vis quick start: animated frames")
    for g, (frame, f) in enumerate(zip(anim.frames, hist)):
        same_array(frame["data"][0]["x"], f, f"vis quick start: frame {g}'s histogram")
    expect(static.frames, None, "vis quick start: a static figure's frames")
    expect([t["name"] for t in static.data], ["min", "mean", "max"], "vis quick start: static traces")
    for trace, reduce in zip(static.data, (np.min, np.mean, np.max)):
        same_array(trace["y"], np.asarray([reduce(f) for f in hist]), f"vis quick start: the {trace['name']} trace")
    # The same curves from torch's reductions on the card's history.
    torch_mean = np.asarray([float(f.double().mean()) for f in monitor.get_fitness_history()])
    mean_rel = float(np.max(np.abs(static.data[1]["y"] - torch_mean) / np.abs(torch_mean)))
    if mean_rel > 1e-6:
        raise AssertionError(f"vis quick start: the mean trace is {mean_rel} from float64 means")
    expect(float(static.data[0]["y"][-1]) >= best, True, "vis quick start: the last min against the best")
    return {"config": "README quick start: PSO(100, ±32, dim 10) Ackley, EvalMonitor, 100 eager steps, plot()",
            "launches": launches, "best_after_init": best0, "best_final": best,
            "without_plotly": {"returned": None, "warning": warned[0], "plot_obj_space_1d": refused},
            "frames": len(anim.frames), "mean_trace_vs_float64_rel": mean_rel}


def vis_nsga2(device, root) -> dict:
    """The NSGA-II headline as run(20) with every history kept: the animated
    and static plots with DTLZ2's front, the history streamed to an .exv
    file and read back byte for byte, and run(20)'s ms/gen with and without
    the full histories."""
    import numpy as np
    import torch
    from evox_tpu_torch.vis_tools import EvoXVisionAdapter, new_exv_metadata, read_exv
    from evox_tpu_torch.workflows import EvalMonitor

    counters = mo_counters()
    for c in counters.values():
        c.launches = 0
    monitor = EvalMonitor(multi_obj=True, full_fit_history=True, full_sol_history=True)
    wf, problem, _ = mo_workflow("NSGA2", NSGA2_POP, device, monitor=monitor)
    t0 = time.perf_counter()
    state = wf.run(wf.init(0), VIS_NSGA2_GENS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    expect(min(launches[k] for k in ("dominance_packed", "peel_fronts", "lex_rank", "crowding_neighbors")) >= 1,
           True, f"vis NSGA-II: a ranking kernel never launched: {launches}")
    pf = problem.pf()
    expect(pf.device.type, torch.device(device).type, "vis NSGA-II: the front's device")
    fits, sols = monitor.get_fitness_history(), monitor.get_solution_history()
    expect((len(fits), len(sols)), (VIS_NSGA2_GENS, VIS_NSGA2_GENS), "vis NSGA-II: generations recorded")
    expect((tuple(fits[-1].shape), tuple(sols[-1].shape)), ((NSGA2_POP, NSGA2_OBJ), (NSGA2_POP, NSGA2_DIM)),
           "vis NSGA-II: a generation's history")
    expect(all(bool(torch.isfinite(f).all()) for f in fits), True, "vis NSGA-II: finite fitness history")

    pf_host = pf.cpu().numpy()
    with plotly_as(recording_plotly()):
        static = monitor.plot(problem_pf=pf, animation=False)
        anim = monitor.plot(problem_pf=pf)
    expect(static.frames, None, "vis NSGA-II: a static figure's frames")
    expect(len(anim.frames), VIS_NSGA2_GENS, "vis NSGA-II: animated frames")
    for fig_name, pf_trace in [("static", static.data[0])] + [(f"frame {g}", fr["data"][0])
                                                             for g, fr in enumerate(anim.frames)]:
        for i, ax in enumerate("xyz"):
            same_array(pf_trace[ax], pf_host[:, i], f"vis NSGA-II: {fig_name}'s front {ax}")
    for g, (frame, f) in enumerate(zip(anim.frames, fits)):
        for i, ax in enumerate("xyz"):
            same_array(frame["data"][1][ax], f.numpy()[:, i], f"vis NSGA-II: frame {g}'s population {ax}")
    pooled = torch.cat(fits).numpy()
    overlay = static.data[1]
    for i, ax in enumerate("xyz"):
        same_array(overlay[ax], pooled[:, i], f"vis NSGA-II: the static overlay's {ax}")
    same_array(overlay["marker"]["color"], np.repeat(np.arange(VIS_NSGA2_GENS), NSGA2_POP),
               "vis NSGA-II: the overlay's generation colours")

    path = root / "nsga2_headline.exv"
    t0 = time.perf_counter()
    adapter = EvoXVisionAdapter(path)
    adapter.set_metadata(new_exv_metadata(sols[0], sols[1], fits[0], fits[1]))
    adapter.write_header()
    for s, f in zip(sols, fits):
        adapter.write(s, f)
    adapter.close()
    write_s = time.perf_counter() - t0
    size = path.stat().st_size
    meta, chunks = read_exv(path)
    expect((meta["n_objs"], len(chunks)), (NSGA2_OBJ, VIS_NSGA2_GENS), "vis NSGA-II: the .exv's chunks")
    for g, (chunk, s, f) in enumerate(zip(chunks, sols, fits)):
        expect(chunk["population"].tobytes() == s.numpy().tobytes(), True, f"vis NSGA-II: chunk {g}'s population")
        expect(chunk["fitness"].tobytes() == f.numpy().tobytes(), True, f"vis NSGA-II: chunk {g}'s fitness")

    def timed_run(w):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        s = w.run(w.init(0), VIS_NSGA2_GENS)
        end.record()
        torch.cuda.synchronize()
        return s, {"ms_per_gen": start.elapsed_time(end) / VIS_NSGA2_GENS,
                   "host_ms_per_gen": (time.perf_counter() - t0) * 1e3 / VIS_NSGA2_GENS}

    # Replays of the same capture from the same seed, in turns with a twin
    # that keeps no history: each replay's history equals the first run's
    # bit for bit, and both twins end on the same state.
    bare, _, _ = mo_workflow("NSGA2", NSGA2_POP, device,
                             monitor=EvalMonitor(multi_obj=True, full_fit_history=False))
    bare.run(bare.init(0), VIS_NSGA2_GENS)  # the capture
    with_hist, without_hist = [], []
    for _ in range(VIS_TURNS):
        monitor.clear_history()
        replayed, t = timed_run(wf)
        with_hist.append(t)
        expect(len(monitor.get_fitness_history()), VIS_NSGA2_GENS, "vis NSGA-II: the replay's generations")
        for g, (a, b) in enumerate(zip(monitor.get_solution_history(), sols)):
            exact(a, b, f"vis NSGA-II: replayed generation {g}'s solutions")
        exact(replayed.algorithm.fit, state.algorithm.fit, "vis NSGA-II: the replayed run's fitness")
        bare_state, t = timed_run(bare)
        without_hist.append(t)
        exact(bare_state.algorithm.fit, state.algorithm.fit, "vis NSGA-II: the run without histories")
    return {"config": f"NSGA2 pop={NSGA2_POP} d={NSGA2_DIM} m={NSGA2_OBJ} DTLZ2 f32, "
                      "EvalMonitor(multi_obj, full_fit_history, full_sol_history), run(20)",
            "launches": launches, "first_run_s": first_s, "frames": len(anim.frames),
            "front_points": int(pf.shape[0]),
            "exv": {"mb": size / 1e6, "write_s": write_s, "mb_per_s": size / 1e6 / write_s,
                    "chunks": len(chunks)},
            # Each run(20) from init(0): init_step eagerly, then the replay.
            "run20_with_full_histories": with_hist, "run20_without_full_histories": without_hist,
            "median_ms_per_gen": {"with": median([t["ms_per_gen"] for t in with_hist]),
                                  "without": median([t["ms_per_gen"] for t in without_hist])}}


def vis_extension(root) -> dict:
    """An ``evox_tpu_torch_ext.algorithms`` plugin grafted at import in a
    fresh process, its algorithm stepping once on the card."""
    pkg = root / "distro" / "evox_tpu_torch_ext" / "algorithms"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text(EXT_ALGORITHM)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([ROOT, str(root / "distro")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", EXT_CHILD], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"vis extension child failed:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    expect(out["class"], "evox_tpu_torch_ext.algorithms.HalfInertiaPSO", "vis extension: the grafted class")
    expect((out["device"].split(":")[0], out["launches"], out["finite"], out["jax_modules"]),
           ("cuda", 1, True, []), f"vis extension: the step {out}")
    expect(abs(out["w"] - 0.3) < 1e-7, True, "vis extension: the subclass's inertia")
    return out


def phase_vis_main_path(device) -> dict:
    """vis_tools, EvalMonitor.plot and the autoloader on the card: (a) the
    README quick start to its end, (b) the NSGA-II headline's run(20)
    plotted and streamed through .exv, (c) a plugin grafted at import."""
    import shutil
    import tempfile

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_vis_"))
    try:
        quick = vis_quickstart(device)
        nsga2 = vis_nsga2(device, root)
        ext = vis_extension(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"card": card_line(), "plotly": "stand-in", "real_plotly": real_plotly_version(),
            "quickstart": quick, "nsga2": nsga2, "extension": ext,
            # The kernels' launches: the quick start's moves and draws, the
            # NSGA-II runs' ranking kernels and draws, the plugin's move.
            "launches": {**{k: v for k, v in nsga2["launches"].items()},
                         "fused_pso_move": quick["launches"]["fused_pso_move"] + ext["launches"],
                         "philox_draws": quick["launches"]["philox_draws"] + nsga2["launches"]["philox_draws"]}}


# ---------------------------------------------------------------------------
# Slice 26: HPO instances split over a PopMesh (ROADMAP 12.1) and the
# resilient runner's CPU fallback from the card.
# ---------------------------------------------------------------------------

HPO_MESH_RANKS = 2  # (b): gloo processes sharing the card, HPO_LADDER["candidates"] / 2 candidates each
# FaultyProblem(error_generations=(60,), error_times=2): evaluation 60 is
# generation 61, in the segment 52..76 (boundaries 1, 26, 51, 76, 100).
FALLBACK_FAULT = 60
FALLBACK_WARNING = "retry budget exhausted; falling back to the CPU backend"
HPO_MESH_CHILD = """
import json, sys, time
t0 = time.perf_counter()
root, url, rank, world, out, kind = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], sys.argv[6]
cfg = json.loads(sys.argv[7])
sys.path.insert(0, root)
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke
# The parent's configuration of the path.
chip_smoke.HPO_LADDER.update(cfg["ladder"])
chip_smoke.HPO_GENS = cfg["gens"]
from evox_tpu_torch.parallel import ShardedProblem, init_multi_host, make_pop_mesh
from evox_tpu_torch.utils import graph
device = init_multi_host(url, world, rank, device=kind, timeout=300)
mesh = make_pop_mesh()
wf = chip_smoke.hpo_ladder_workflow(device, enable_distributed=True, mesh=mesh)
assert isinstance(wf.problem, ShardedProblem) and not wf.problem.capturable
counters = chip_smoke.hpo_counters()
started = time.perf_counter() - t0
for c in counters.values():
    c.launches = 0
s = wf.step(wf.init_step(wf.init(0)))
sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
sync()
dist.barrier()
t1 = time.perf_counter()
for _ in range(chip_smoke.HPO_GENS):
    s = wf.step(s)
sync()
ms = (time.perf_counter() - t1) * 1e3 / chip_smoke.HPO_GENS
launches = {k: c.launches for k, c in counters.items()}
np.savez(f"{out}/rank{rank}.npz", *[t.detach().cpu().numpy() for t in graph.flatten(s)[0]])
foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evox_tpu", "evox_tpu_ext"))
rec = {"rank": rank, "backend": dist.get_backend(), "device": str(device), "mesh": repr(mesh),
       "nest_graphs": len(wf.problem.problem._graphs), "candidates_per_rank": chip_smoke.HPO_LADDER["candidates"] // world,
       "eager_ms_per_outer_gen": ms, "launches": launches, "start_s": started, "foreign_modules": foreign}
with open(f"{out}/rank{rank}.json", "w") as f:
    json.dump(rec, f)
dist.barrier()
dist.destroy_process_group()
"""


def hpo_mesh_gloo(ref, device) -> dict:
    """(b) of ``phase_hpo_mesh_main_path``: HPO_MESH_RANKS processes on one
    card in a gloo group, the ladder's candidates split between them; each
    steps init_step, a step and HPO_GENS eager outer generations (gloo
    runs on the host: no outer capture; each rank's nest replays a graph of
    its own block) and its whole state equals ``ref``, the one-rank NCCL
    run's after the same steps, bit for bit.  Each process imports nothing
    of JAX."""
    import shutil
    import tempfile

    import numpy as np
    from evox_tpu_torch.utils import graph

    wait_fleet_pycache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hpo_mesh_"))
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", HPO_MESH_CHILD, ROOT, f"file://{tmp / 'store'}", str(r),
                                   str(HPO_MESH_RANKS), str(tmp), device.type,
                                   json.dumps({"ladder": HPO_LADDER, "gens": HPO_GENS})], env=fleet_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(HPO_MESH_RANKS)]
        try:
            logs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"hpo_mesh (b): rank {r} exited {p.returncode}:\n{err[-3000:]}")
        want = [t.detach().cpu().numpy() for t in graph.flatten(ref)[0]]
        ranks = []
        for r in range(HPO_MESH_RANKS):
            rec = json.loads((tmp / f"rank{r}.json").read_text())
            if rec["foreign_modules"] or rec["backend"] != "gloo" or not rec["device"].startswith(device.type):
                raise AssertionError(f"hpo_mesh (b): rank {r}: {rec}")
            with np.load(tmp / f"rank{r}.npz") as got:
                leaves = [got[f"arr_{i}"] for i in range(len(got.files))]
            if len(leaves) != len(want):
                raise AssertionError(f"hpo_mesh (b): rank {r} has {len(leaves)} leaves, the NCCL run {len(want)}")
            for i, (g, w) in enumerate(zip(leaves, want)):
                if g.shape != w.shape or g.dtype != w.dtype or g.tobytes() != w.tobytes():
                    raise AssertionError(f"hpo_mesh (b): rank {r} leaf {i} differs from the one-rank NCCL run")
            rec["leaves_equal"] = len(leaves)
            ranks.append(rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"ranks": ranks, "wall_s": wall,
            "launches": {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}}


def phase_hpo_mesh_main_path(device) -> dict:
    """HPO instances split over a PopMesh (ROADMAP 12.1) at hpo_ladder's
    width (bench.py:1280-1341: PSO(64) over 64 x OpenES(1024, zeros(32)) on
    Sphere, 32 inner generations).  (a) ``enable_distributed=True`` on a
    one-rank NCCL mesh wraps the nest in ShardedProblem: init_step, a step,
    then ``fused_vs_eager`` (HPO_GENS eager outer generations against
    run(HPO_GENS) and run_segment(HPO_GENS), the all-gathers captured
    inline with the nest); the unsharded nest's eager steps, bit-equal, and
    run(HPO_GENS), timed beside them; the outer move against its plain version and one
    uncaptured evaluation's batched draws replayed through the plain
    version, 0 ulp.  (b) ``hpo_mesh_gloo``: two gloo processes sharing the
    card, 32 candidates each, equal to (a).  Destroys the group at the
    end."""
    import torch
    import torch.distributed as dist
    from evox_tpu_torch.parallel import ShardedProblem, make_pop_mesh

    c = HPO_LADDER
    mesh = make_pop_mesh()
    out = {"card": card_line(), "mesh": repr(mesh),
           "config": f"PSO({c['candidates']}) over ShardedProblem(NestedProblem(OpenES({c['inner_pop']}, "
                     f"zeros({c['dim']})), Sphere, iterations={c['iterations']})) with enable_distributed=True"}
    counters = hpo_counters()
    wf = hpo_ladder_workflow(device, enable_distributed=True, mesh=mesh)
    twin = hpo_ladder_workflow(device)
    if not isinstance(wf.problem, ShardedProblem) or wf.problem.capturable != (torch.device(device).type == "cuda"):
        raise AssertionError(f"hpo_mesh (a): the nest is not a capturable ShardedProblem: {wf.problem}")
    for k in counters.values():
        k.launches = 0
    s1 = wf.step(wf.init_step(wf.init(0)))
    torch.cuda.synchronize()
    setup = counts(counters)
    expect(setup, {"fused_pso_move": 1, "fused_pso_move_batched": 0, "philox_draws": 2,
                   "philox_draws_batched": 2 * c["iterations"]},
           "hpo_mesh (a): launches of setup, init_step (the nest's warm-up and capture) and a step")
    fused, ref = fused_vs_eager(wf, s1, HPO_GENS, counters, "hpo_mesh (a) sharded", profile_gens=1)
    eager = fused.pop("launches_in_eager_steps")
    expect(eager, {"fused_pso_move": HPO_GENS, "fused_pso_move_batched": 0, "philox_draws": 0,
                   "philox_draws_batched": 0}, "hpo_mesh (a): launches of the eager outer steps (replayed nests)")
    t1 = twin.step(twin.init_step(twin.init(0)))
    out["leaves_equal_after_a_step"] = same_state(s1, t1, "hpo_mesh (a): sharded vs unsharded after init_step + 1 step")
    # The unsharded nest's eager steps and run(HPO_GENS) (its capture, then
    # a replay), timed beside the sharded ones.
    twin_eager_ms, _, twin_ref = timed(lambda: _steps(twin, t1, HPO_GENS), HPO_GENS)
    out["leaves_equal"] = same_state(ref, twin_ref, f"hpo_mesh (a): {HPO_GENS} sharded eager outer steps vs unsharded")
    twin.run(t1, HPO_GENS, init=False)
    twin_run_ms, _, _ = timed(lambda: twin.run(t1, HPO_GENS, init=False), HPO_GENS)
    move = move_vs_plain(wf, ref, "hpo_mesh (a)")
    seen = []
    with uncaptured_nests(), recording_draws(seen):
        wf.step(s1)
    on_path = draws_on_path("hpo_mesh (a)", seen)
    expect(on_path["launches"], {"philox_draws": 0, "philox_draws_batched": c["iterations"]},
           "hpo_mesh (a): draws recorded in one uncaptured outer step")
    del seen, twin, t1, twin_ref
    gloo = hpo_mesh_gloo(ref, torch.device(device))
    dist.destroy_process_group()
    inner_gens = c["candidates"] * c["iterations"]
    out.update({
        "sharded": fused,
        "eager_ms_per_outer_gen": fused["eager_ms_per_gen"], "run_ms_per_outer_gen": fused["run_ms_per_gen"],
        "unsharded_eager_ms_per_outer_gen": twin_eager_ms, "unsharded_run_ms_per_outer_gen": twin_run_ms,
        "inner_gens_per_s_run": inner_gens * 1e3 / fused["run_ms_per_gen"],
        "move_vs_plain": move, "philox_on_path_vs_plain": on_path, "gloo": gloo,
        "gloo_eager_ms_per_outer_gen": [r["eager_ms_per_outer_gen"] for r in gloo["ranks"]],
        # The path's launches: (a)'s counted window and (b)'s processes.
        "launches": {k: setup[k] + eager[k] + gloo["launches"][k] for k in counters},
    })
    del wf, ref
    torch.cuda.empty_cache()
    return out


def phase_resilient_fallback(device) -> dict:
    """ResilientRunner(cpu_fallback=True) from the card at
    pso_small_resilient's width (bench.py:247-262: PSO(1024, ±32 in dim
    100), Ackley, segments of 25), RESILIENT_GENS generations, with
    FaultyProblem(error_generations=(FALLBACK_FAULT,), error_times=2) and
    RetryPolicy(max_retries=1): the generations to the fault run eagerly on
    the card (a host fault), the segment fails twice, the run falls back
    once and ends on the CPU twin.  The final state is on the CPU and
    equals, bit for bit, a CPU-built workflow resumed from the failed
    segment's input checkpoint; that checkpoint equals a fault-free card
    run's state; one warning, ``cpu_fallbacks`` 1 and the counter 1; a
    second ``run(fresh=True)`` stays on the card, 0 fallbacks, equal to the
    fault-free run.  The move's launches are counted over the first run
    (setup included): the card's generations only."""
    import shutil
    import tempfile
    import warnings

    import torch
    from evox_tpu_torch import obs
    from evox_tpu_torch.ops import philox
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import FaultyProblem, ResilientRunner, RetryPolicy
    from evox_tpu_torch.utils import graph, load_state

    n, every = RESILIENT_GENS, RESILIENT_EVERY
    start = 1 + every * (FALLBACK_FAULT // every)  # the failed segment's input generation
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fallback_"))
    out = {"card": card_line(), "config": f"pso_small_resilient, {n} generations, segments of {every}, "
                                          f"FaultyProblem(error_generations=({FALLBACK_FAULT},), error_times=2), "
                                          "RetryPolicy(max_retries=1), cpu_fallback=True"}
    try:
        prob = FaultyProblem(Ackley(), error_generations=(FALLBACK_FAULT,), error_times=2)
        evaluations = []
        real = prob.evaluate

        def noted(state, pop):
            try:
                res = real(state, pop)
            except Exception:
                evaluations.append(("raised", pop.device.type, time.perf_counter()))
                raise
            evaluations.append(("done", pop.device.type, time.perf_counter()))
            return res

        prob.evaluate = noted
        wf = small_resilient_workflow(device, prob)
        plane = obs.Observability(registry=obs.MetricsRegistry(), run_id="resilient_fallback")
        runner = ResilientRunner(wf, root / "f", checkpoint_every=every, cpu_fallback=True, keep_checkpoints=0,
                                 retry=RetryPolicy(max_retries=1, **FAST_RETRY), obs=plane)
        counters = {"fused_pso_move": fused_pso_move, "philox_draws": philox.philox_draws}
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            final = runner.run(wf.init(0), n, fresh=True)
        run_s = time.perf_counter() - t0
        launches = counts(counters)
        # The card's moves: generations 2..start, and 2..(FALLBACK_FAULT + 1)
        # of the failed segment in each of its two attempts.
        expect(launches, {"fused_pso_move": (start - 1) + 2 * (FALLBACK_FAULT + 1 - start), "philox_draws": 2},
               "resilient_fallback: launches on the card")
        fell = [str(w.message) for w in caught if FALLBACK_WARNING in str(w.message)]
        expect(fell, [f"segment (generations {start + 1}..{start + every}): {FALLBACK_WARNING}"],
               "resilient_fallback: the fallback's warning")
        expect(runner.stats.cpu_fallbacks, 1, "resilient_fallback: cpu_fallbacks")
        expect(plane.registry.snapshot()["evox_runner_cpu_fallbacks_total"], 1.0,
               "resilient_fallback: evox_runner_cpu_fallbacks_total")
        expect({t.device.type for t in graph.flatten(final)[0]}, {"cpu"}, "resilient_fallback: the final state's device")
        twin = runner.workflow
        if twin is wf or twin.algorithm.lb.device.type != "cpu" or wf.algorithm.lb.device.type != torch.device(device).type:
            raise AssertionError("resilient_fallback: the run did not end on a CPU twin of the card workflow")
        cpu_wf = small_resilient_workflow("cpu", FaultyProblem(Ackley(), error_generations=(FALLBACK_FAULT,),
                                                               error_times=0))
        resumed = _steps(cpu_wf, load_state(root / "f" / f"ckpt_{start:08d}.npz", cpu_wf.init(1)), n - start)
        out["leaves_equal_cpu_resumed"] = same_state(final, resumed, "resilient_fallback: the fallback run vs a "
                                                     f"CPU workflow resumed from generation {start}")
        clean = small_resilient_workflow(device, FaultyProblem(Ackley(), error_generations=(FALLBACK_FAULT,),
                                                               error_times=0))
        before = _steps(clean, clean.init_step(clean.init(0)), start - 1)
        out["leaves_equal_before_fallback"] = same_state(
            load_state(root / "f" / f"ckpt_{start:08d}.npz", clean.init(1)), before,
            f"resilient_fallback: generation {start} against a fault-free card run")
        failed = max(t for kind, _, t in evaluations if kind == "raised")
        first_cpu = min(t for kind, dev, t in evaluations if kind == "done" and dev == "cpu" and t > failed)
        timings = [t._asdict() for t in runner.stats.segment_timings]
        last = runner.stats.segment_timings[-1]
        out.update({
            "stats": runner_stats(runner), "run_s": run_s, "launches": launches,
            "failure_to_first_cpu_generation_s": first_cpu - failed,
            "cpu_ms_per_gen": last.execute_seconds * 1e3 / runner.stats.chunk_sizes[-1],
            "cpu_segment": {"generations": runner.stats.chunk_sizes[-1], "execute_s": last.execute_seconds},
            "segment_timings": timings, "evaluations_on": {d: sum(1 for _, x, _ in evaluations if x == d)
                                                            for d in ("cuda", "cpu")},
        })
        # The outage is over (the fault's attempts consumed): a new run()
        # starts on the card workflow and stays there.
        again = quiet_run(runner, wf.init(0), n, fresh=True)
        expect(runner.stats.cpu_fallbacks, 0, "resilient_fallback: the next run's cpu_fallbacks")
        if runner.workflow is not wf:
            raise AssertionError("resilient_fallback: the next run did not start on the card workflow")
        clean_run = _steps(clean, before, n - start)
        out["next_run_leaves_equal_fault_free"] = same_state(again, clean_run,
                                                             "resilient_fallback: the next run vs a fault-free card run")
        del wf, twin, final, resumed, clean, before, again, clean_run
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


MO_KERNELS = [
    ("dominance_packed", "evox_tpu_torch/csrc/dominance.cu", "evox_tpu/ops/dominance.py:37",
     "dominance_packed_20k"),
    ("peel_fronts", "evox_tpu_torch/csrc/dominance.cu",
     "evox_tpu/operators/selection/non_dominate.py:86", "peel_fronts_20k"),
    ("lex_rank", "evox_tpu_torch/csrc/topk.cu", "evox_tpu/ops/topk.py:60", "lex_rank_20k"),
    ("crowding_neighbors", "evox_tpu_torch/csrc/crowding.cu", "evox_tpu/ops/crowding.py:42",
     "crowding_neighbors_20k_path"),
    ("scale_by_two", "evox_tpu_torch/csrc/probe.cu", "evox_tpu/ops/pallas_gate.py:62",
     "scale_by_two_probe"),
]


def kernel_row(name, source, replaces, results, timing_key) -> dict:
    t = results["timing_mo"][timing_key]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        # The probe is no kernel of a main path: 0 launches there.  The
        # ranking kernels also run on NSGA-III, RVEAa and HypE.
        "launches": results["nsga2_main_path"]["launches"].get(name, 0)
        + results["mo_family"]["launches"].get(name, 0)
        + results["vmapped_family"]["launches"].get(name, 0)
        + results["nsga2_policy_main_path"]["launches"].get(name, 0)
        # The NSGA-II headline with enable_distributed=True.
        + results["distributed_main_path"]["launches"].get(name, 0)
        # The NSGA-II headline's run(20) with every history, plotted.
        + results["vis_main_path"]["launches"].get(name, 0),
        # compare_mo's sizes, the timing rows held on the path's inputs and
        # the ranking on NSGA-III's, RVEAa's and HypE's paths.
        "max_abs_err": max([results["compare_mo"]["max_abs_err"][name],
                            results["mo_family"]["max_abs_err"].get(name, 0.0)]
                           + [r["max_abs_err"] for k, r in results["timing_mo"].items()
                              if k.startswith(name + "_") and "max_abs_err" in r]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        # The profiler's device time of a call, where the row was profiled.
        **({"device_ms": t["launches_per_call"]["device_ms"]} if "launches_per_call" in t else {}),
    }


def on_path_err(results, route) -> float:
    """The largest error of the recorded draws (``draws_on_path``) that
    took ``route``, over every phase's paths."""
    worst = 0.0
    for v in results.values():
        if isinstance(v, dict):
            rec = v.get("philox_on_path_vs_plain")
            if rec is not None and rec["launches"][route]:
                worst = max(worst, rec["max_abs_err"])
            worst = max(worst, on_path_err(v, route))
    return worst


def philox_row(results) -> dict:
    t = results["philox"]["timing"]["pso_setup_1e8_f32"]
    return {
        "name": "philox_draws", "route": "cuda", "source": "evox_tpu_torch/csrc/philox.cu",
        # The JAX package draws with jax.random inside XLA programs; no
        # Pallas kernel of it does this work.
        "replaces": "none (the port's own kernel; the plain draws of evox_tpu_torch/utils/rng.py)",
        # The main paths' draws: the PSO headline's setup, the NSGA-II,
        # RVEA, de_cec, cmaes_cec, openes_cec and neuroevolution headlines'
        # setups and generations, and the eager generations of the rest of
        # the multi-objective family, of the DE, ES and PSO families and of
        # the neuroevolution family (with their setups).
        "launches": results["main_path"]["philox_launches"]
        + results["nsga2_main_path"]["launches"]["philox_draws"]
        + results["rvea_main_path"]["launches"]["philox_draws"]
        + results["mo_family"]["launches"]["philox_draws"]
        + results["de_main_path"]["launches"]["philox_draws"]
        + results["de_family"]["launches"]["philox_draws"]
        + results["cmaes_main_path"]["launches"]["philox_draws"]
        + results["openes_main_path"]["launches"]["philox_draws"]
        + results["es_family"]["launches"]["philox_draws"]
        + results["pso_variants"]["launches"]["philox_draws"]
        + results["neuroevolution_main_path"]["launches"]["philox_draws"]
        + results["neuroevolution_family"]["launches"]["philox_draws"]
        # vis_main_path's quick start setup and NSGA-II runs.
        + results["vis_main_path"]["launches"]["philox_draws"]
        # The precision plane's paths: their setups, NSGA-II's generations
        # and the key-impl twins' setups.
        + sum(results[p]["setup"]["philox_draws"]
              for p in ("pso_policy_main_path", "nsga2_policy_main_path", "pso_bf16_main_path"))
        + results["nsga2_policy_main_path"]["launches"]["philox_draws"]
        + sum(results["key_impl_twins"][t][k]["philox_draws"] for t in TWINS
              for k in ("launches", "default_twin_launches", "env_launches"))
        # The HPO paths' outer setups and DE's generations.
        + results["hpo_main_path"]["launches"]["philox_draws"]
        + results["hpo_quickstart"]["launches"]["philox_draws"]
        # The sharded runs' generations (NSGA-II's draws).
        + results["distributed_main_path"]["launches"]["philox_draws"]
        # The resilient runner's setups, and neuroevolution_resilient's
        # OpenES draws.
        + results["resilient_main_path"]["launches"]["philox_draws"]
        + results["neuroevolution_resilient"]["launches"]["philox_draws"]
        # The control plane's runs: the outer PSO's setups (and the grown
        # ladders' rebuilt instances), pso_small_resilient's setups.
        + sum(results[p]["launches"]["philox_draws"]
              for p in ("hpo_runner_main_path", "hpo_grow", "controller_cadence"))
        # The service core: the tenants' setups (and OpenES's init program).
        + sum(results[p]["launches"]["philox_draws"] for p in ("service_pack", "service_main_path"))
        # The fleets' worker processes: their setups (and the in-kernel
        # draws' seeds), counted by each worker that wrote its summary.
        + sum(results[p]["launches"]["philox_draws"] for p in ("fleet_main_path", "fleet_straggler"))
        # The daemon's tenants' setups, in this process and in the cold and
        # warm daemon processes.
        + sum(results[p]["launches"]["philox_draws"] for p in ("daemon_main_path", "daemon_overload"))
        # The HPO tenants' setups (the outer algorithms' draws).
        + sum(results[p]["launches"]["philox_draws"] for p in HPO_WORKLOAD_PHASES)
        # The gateway's tenants' setups, in this process and in the cold and
        # warm gateway processes.
        + sum(results[p]["launches"]["philox_draws"] for p in GATEWAY_PHASES)
        # The routed tenants' setups (the migrated ones' resume templates
        # too), in this process and in the cold and warm router processes.
        + sum(results[p]["launches"]["philox_draws"] for p in ROUTER_PHASES)
        # The conducted members' tenants' setups (the rebuilt members'
        # resumed ones too) and the soak's churned tenants' setups.
        + sum(results[p]["launches"]["philox_draws"] for p in CHAOS_PHASES)
        # The outer PSO's setups of the HPO split over the mesh (the NCCL
        # run and the two gloo processes) and the fallback run's setup.
        + sum(results[p]["launches"]["philox_draws"] for p in SLICE_26_PHASES),
        # The philox phase's sizes, and every recorded draw of the paths.
        "max_abs_err": max(results["philox"]["max_abs_err"], on_path_err(results, "philox_draws")),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    }


def eigh_row(results) -> dict:
    """The Jacobi eigensolver: its launches on the paths above d = 32
    (cmaes_cadence's and cmaes_large_main_path's runs, each call one
    cooperative launch, due or not), its time on cmaes_cadence's (1000,
    1000) C in float32 with the plain version's and torch.linalg.eigh's on
    the same matrix, and the largest difference of its eigenvalues from the
    plain version's over every case (matrices of norm about 1)."""
    c = results["cmaes_cadence"]["eigh_1000"]["float32"]
    return {
        "name": "eigh_jacobi", "route": "cuda", "source": "evox_tpu_torch/csrc/eigh_jacobi.cu",
        "replaces": "none (XLA's eigh: jnp.linalg.eigh at evox_tpu/algorithms/so/es_variants/cma_es.py:142, "
                    "jnp.linalg.svd at evox_tpu/algorithms/so/es_variants/asebo.py:75)",
        "launches": results["cmaes_cadence"]["launches"]["eigh_jacobi"]
        + results["cmaes_large_main_path"]["launches"]["eigh_jacobi"],
        "max_abs_err": max(c["vs_plain_abs"], results["cmaes_large_main_path"]["max_abs_err"]),
        "ms": c["ms"], "plain_ms": c["plain_s"] * 1e3, "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["torch_linalg_eigh_ms"], "device_ms": c["profile"]["device_ms"], "sweeps": c["sweeps"],
        "dense_bound_ms": c["dense_ms"], "launches_per_call": c["profile"]["named"],
        "phase_split": "one kernel: the profiler cannot split it (tools/eigh_phase_probe.py does)",
    }


def batched_rows(results) -> list[dict]:
    """The batched routes of the PSO move and the Philox draws (one launch
    over a vmapped batch of instances), timed in ``vmapped_instances``."""
    t = results["vmapped_instances"]["kernels"]
    launches = results["vmapped_instances"]["launches"]
    return [
        {"name": "fused_pso_move_batched", "route": "cuda", "source": "evox_tpu_torch/csrc/pso_move.cu",
         # The TPU kernel under jax.vmap (the batch folded into its grid).
         "replaces": "evox_tpu/ops/pso_step.py:77",
         # With the README HPO quick start's inner PSO (a row of scalars a
         # candidate).
         "launches": launches["fused_pso_move_batched"] + results["hpo_quickstart"]["launches"]["fused_pso_move_batched"]
         # The service core's paths: the packs' segment captures (a warm-up
         # and the captured generations) and the eager vmapped segments.
         + sum(results[p]["launches"]["fused_pso_move_batched"]
               for p in ("service_pack", "vmapped_instances_resilient", "service_main_path"))
         # The daemon's packs: its prewarmed captures of both cadences, in
         # this process and in the cold and warm daemon processes.
         + sum(results[p]["launches"]["fused_pso_move_batched"] for p in ("daemon_main_path", "daemon_overload"))
         # The service's HPO workload: the packs' segment and init captures
         # (the outer PSO over the lanes, the inner PSO over lanes x
         # candidates), in this process and the HPO daemon's two.
         + sum(results[p]["launches"]["fused_pso_move_batched"] for p in HPO_WORKLOAD_PHASES)
         # The gateway's daemons: their prewarmed captures of both cadences
         # (two buckets in gateway_main_path), in this process and in the
         # cold and warm gateway processes.
         + sum(results[p]["launches"]["fused_pso_move_batched"] for p in GATEWAY_PHASES)
         # The router's members (and router_overhead's direct daemon): each
         # pack's prewarmed captures of both cadences, in this process and
         # in the cold and warm router processes.
         + sum(results[p]["launches"]["fused_pso_move_batched"] for p in ROUTER_PHASES)
         # The conducted members' packs (the rebuilt members' captures too)
         # and the soak's members' 16-lane packs.
         + sum(results[p]["launches"]["fused_pso_move_batched"] for p in CHAOS_PHASES),
         **{k: t["fused_pso_move_batched"][k] for k in KERNEL_KEYS},
         # The timed batch, the HPO path's recorded moves, the pack's shape
         # and the eager vmapped segments' recorded moves.
         "max_abs_err": max(t["fused_pso_move_batched"]["max_abs_err"],
                            results["hpo_quickstart"]["batched_moves_vs_plain"]["max_abs_err"],
                            results["service_pack"]["max_abs_err"]["fused_pso_move_batched"],
                            results["vmapped_instances_resilient"]["max_abs_err"],
                            results["daemon_main_path"]["max_abs_err"]["fused_pso_move_batched"],
                            # The packs of nests' own moves: (A)'s outer one at
                            # (4, 64, 2), (B)'s inner ones at 4 x 64 instances
                            # of (1024, 32).
                            results["service_hpo_main_path"]["max_abs_err"]["fused_pso_move_batched"],
                            # The gateway's daemon's two buckets' final states.
                            results["gateway_main_path"]["max_abs_err"]["fused_pso_move_batched"],
                            # Both members' final states behind the router.
                            results["router_main_path"]["max_abs_err"]["fused_pso_move_batched"],
                            # The conducted members' and the soak members' packs.
                            *(results[p]["max_abs_err"]["fused_pso_move_batched"] for p in CHAOS_PHASES))},
        {"name": "philox_draws_batched", "route": "cuda", "source": "evox_tpu_torch/csrc/philox.cu",
         "replaces": "none (the port's own kernel, batched over vmapped instances)",
         # With the rollouts' resets (one launch for the episodes a
         # generation).
         "launches": launches["philox_draws_batched"]
         + results["vmapped_family"]["launches"]["philox_draws_batched"]
         + results["neuroevolution_main_path"]["launches"]["philox_draws_batched"]
         + results["neuroevolution_family"]["launches"]["philox_draws_batched"]
         # The HPO paths: OpenES's normals for all candidates (hpo_ladder),
         # the inner PSO's setups (the quick start).
         + results["hpo_main_path"]["launches"]["philox_draws_batched"]
         + results["hpo_quickstart"]["launches"]["philox_draws_batched"]
         # neuroevolution_resilient's rollout resets.
         + results["neuroevolution_resilient"]["launches"]["philox_draws_batched"]
         # hpo_ladder's OpenES normals under the HPO runner and the growth
         # ladder (captured nests: counted at their warm-ups and captures).
         + results["hpo_runner_main_path"]["launches"]["philox_draws_batched"]
         + results["hpo_grow"]["launches"]["philox_draws_batched"]
         # OpenES's normals in the service's OpenES bucket (its capture).
         + results["service_main_path"]["launches"]["philox_draws_batched"]
         # The daemon's paths (PSO draws in the move kernel: none here).
         + sum(results[p]["launches"]["philox_draws_batched"] for p in ("daemon_main_path", "daemon_overload"))
         # The service's HPO workload: OpenES's normals over lanes x
         # candidates and CMA-ES's over the lanes in the packs' captures.
         + sum(results[p]["launches"]["philox_draws_batched"] for p in HPO_WORKLOAD_PHASES)
         # The gateway's and the router's paths (PSO draws in the move
         # kernel: none).
         + sum(results[p]["launches"]["philox_draws_batched"] for p in GATEWAY_PHASES + ROUTER_PHASES + CHAOS_PHASES)
         # hpo_ladder's OpenES normals split over the mesh: the nests'
         # warm-ups and captures of the NCCL run and the gloo processes.
         + results["hpo_mesh_main_path"]["launches"]["philox_draws_batched"],
         **{k: t["philox_draws_batched"][k] for k in KERNEL_KEYS},
         # The timed batch, the pack's shape, and the rollouts' recorded
         # resets.
         "max_abs_err": max(t["philox_draws_batched"]["max_abs_err"],
                            results["service_pack"]["max_abs_err"]["philox_draws_batched"],
                            results["daemon_main_path"]["max_abs_err"]["philox_draws_batched"],
                            results["gateway_main_path"]["max_abs_err"]["philox_draws_batched"],
                            results["router_main_path"]["max_abs_err"]["philox_draws_batched"],
                            *(results[p]["max_abs_err"]["philox_draws_batched"] for p in CHAOS_PHASES),
                            on_path_err(results, "philox_draws_batched"))},
    ]


HPO_WORKLOAD_PHASES = ("service_hpo_main_path", "service_hpo_grow", "daemon_hpo_restart")
SLICE_26_PHASES = ("hpo_mesh_main_path", "resilient_fallback")
KERNEL_KEYS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


# Instruction classes of the PSO move's SASS, by opcode prefix (the first
# that matches).
SASS_CLASSES = [
    ("IMAD.WIDE", "IMAD.WIDE"), ("IMAD.HI", "IMAD.HI"), ("IMAD", "IMAD"), ("LOP3", "LOP3"), ("IADD3", "IADD3"),
    ("VIADD", "VIADD"), ("SHF", "SHF"), ("I2F", "I2F"), ("F2F", "F2F"), ("FMUL/FADD", ("FMUL", "FADD")),
    ("FMNMX/FSETP/FSEL", ("FMNMX", "FSETP", "FSEL")), ("HMUL2/HADD2/HFMA2", ("HMUL2", "HADD2", "HFMA2")),
    ("HMNMX2", "HMNMX2"), ("LDGSTS", "LDGSTS"), ("LDG", "LDG"), ("LDS", "LDS"), ("STG", "STG"),
    ("BRA/BSSY/BSYNC", ("BRA", "BSSY", "BSYNC")),
]


def sass_counts(lib) -> dict:
    """Instructions an element of each 32-bit route of the PSO move, by
    class (``SASS_CLASSES``): the static count of the main loop's body
    (from the backward branch of largest span, the rarely taken change of
    instance included) over the vector width, read from ``cuobjdump
    -sass`` of the built library.  The row layout's routes are ``rows``.
    Fails unless every route of the kernel is found, each with a loop."""
    import re
    from collections import Counter

    from evox_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).resolve().parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)(.*);", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, ins in funcs.items():
        m = re.search(r"pso_move_(kernel|rows)INS_\d(BF16|F32)E(?:Li(\d+)E)?([jm]?)(?:Lb([01]))?", name)
        if not m or m.group(4) == "m":
            continue
        span = (0, -1)
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and t and int(t.group(1), 16) < addr and addr - int(t.group(1), 16) > span[1] - span[0]:
                span = (int(t.group(1), 16), addr)
        counts = Counter()
        for addr, op, _ in ins:
            if span[0] <= addr <= span[1]:
                counts[next((c for c, pre in SASS_CLASSES if op.startswith(pre)), "other")] += 1
        vec = int(m.group(3) or 1)
        layout = "rows" if m.group(1) == "rows" else f"v{vec}"
        draws = {"1": " input", "0": " hw"}.get(m.group(5), "")
        route = f"{'float32' if m.group(2) == 'F32' else 'bfloat16'} {layout}{draws}"
        if not counts:
            raise AssertionError(f"cuobjdump -sass of {lib}: no loop in {name}")
        out[route] = {"per_element": round(sum(counts.values()) / vec, 2),
                      **{c: round(counts[c] / vec, 2) for c, _ in SASS_CLASSES + [("other", "")] if counts[c]}}
    want = {f"{dtype} {layout} {draws}" for dtype, widths in (("float32", (1, 2, 4)), ("bfloat16", (1, 2, 4, 8)))
            for layout in [f"v{v}" for v in widths] + ["rows"] for draws in ("hw", "input")}
    if set(out) != want:
        raise AssertionError(f"cuobjdump -sass of {lib}: pso_move routes {sorted(out)}, expected {sorted(want)}")
    return dict(sorted(out.items()))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    # Importing the port fails in a directory that holds only this script.
    import evox_tpu_torch  # noqa: F401
    from evox_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()
    start_fleet_pycache()

    t0 = time.perf_counter()
    libs = _build.build()
    ptxas = {
        name: [ln for ln in Path(f"{path}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items()
    }
    emit("build", {"seconds": time.perf_counter() - t0, "ptxas": ptxas,
                   "pso_move_sass_per_element": sass_counts(libs["pso_move"])})

    results = {}
    for name, phase in (
        ("compare", phase_compare),
        ("draws", phase_draws),
        ("main_path", phase_main_path),
        ("quickstart", phase_quickstart),
        ("timing", phase_timing),
        ("compare_mo", phase_compare_mo),
        ("nsga2_main_path", phase_nsga2_main_path),
        ("mo_example", phase_mo_example),
        ("vis_main_path", phase_vis_main_path),
        ("timing_mo", phase_timing_mo),
        ("philox", phase_philox),
        ("segment", phase_segment),
        ("rvea_main_path", phase_rvea_main_path),
        ("mo_family", phase_mo_family),
        ("cec2022_suite", phase_cec2022_suite),
        ("de_main_path", phase_de_main_path),
        ("de_family", phase_de_family),
        ("cmaes_main_path", phase_cmaes_main_path),
        ("openes_main_path", phase_openes_main_path),
        ("es_family", phase_es_family),
        ("cmaes_cadence", phase_cmaes_cadence),
        ("cmaes_large_main_path", phase_cmaes_large_main_path),
        ("pso_variants", phase_pso_variants),
        ("vmapped_instances", phase_vmapped_instances),
        ("vmapped_family", phase_vmapped_family),
        ("neuroevolution_main_path", phase_neuroevolution_main_path),
        ("neuroevolution_family", phase_neuroevolution_family),
        ("pso_policy_main_path", phase_pso_policy_main_path),
        ("nsga2_policy_main_path", phase_nsga2_policy_main_path),
        ("pso_bf16_main_path", phase_pso_bf16_main_path),
        ("key_impl_twins", phase_key_impl_twins),
        ("hpo_main_path", phase_hpo_main_path),
        ("hpo_quickstart", phase_hpo_quickstart),
        ("distributed_main_path", phase_distributed_main_path),
        ("checkpoint_main_path", phase_checkpoint_main_path),
        ("resilient_main_path", phase_resilient_main_path),
        ("resilient_recovery", phase_resilient_recovery),
        ("neuroevolution_resilient", phase_neuroevolution_resilient),
        ("resilient_quickstart", phase_resilient_quickstart),
        ("hpo_runner_main_path", phase_hpo_runner_main_path),
        ("hpo_grow", phase_hpo_grow),
        ("controller_cadence", phase_controller_cadence),
        ("service_pack", phase_service_pack),
        ("vmapped_instances_resilient", phase_vmapped_instances_resilient),
        ("service_main_path", phase_service_main_path),
        ("fleet_main_path", phase_fleet_main_path),
        ("fleet_straggler", phase_fleet_straggler),
        ("daemon_main_path", phase_daemon_main_path),
        ("daemon_overload", phase_daemon_overload),
        ("service_hpo_main_path", phase_service_hpo_main_path),
        ("service_hpo_grow", phase_service_hpo_grow),
        ("daemon_hpo_restart", phase_daemon_hpo_restart),
        ("gateway_main_path", phase_gateway_main_path),
        ("gateway_kill_restart", phase_gateway_kill_restart),
        ("gateway_overhead", phase_gateway_overhead),
        ("router_main_path", phase_router_main_path),
        ("router_kill_restart", phase_router_kill_restart),
        ("router_overhead", phase_router_overhead),
        ("chaos_main_path", phase_chaos_main_path),
        ("chaos_soak", phase_chaos_soak),
        ("hpo_mesh_main_path", phase_hpo_mesh_main_path),
        ("resilient_fallback", phase_resilient_fallback),
    ):
        t0 = time.perf_counter()
        results[name] = phase(device)
        results[name]["seconds"] = time.perf_counter() - t0
        emit(name, results[name])

    main_path, timing = results["main_path"], results["timing"]
    f32 = timing["float32_hw"]
    # The move's launches by route: the PSO headline (float32), the
    # policy's compute form (float32), pso_northstar_bf16 (bfloat16) and
    # the key-impl twins' three runs each (both routes).
    routes = {"float32": main_path["launches"], "bfloat16": 0}
    for phase in ("pso_policy_main_path", "pso_bf16_main_path"):
        for k, v in results[phase]["routes_in_eager_steps"].items():
            routes[k] += v
    for twin in TWINS:
        for counts in ("launches", "default_twin_launches", "env_launches"):
            for k, v in results["key_impl_twins"][twin][counts]["routes"].items():
                routes[k] += v
    # hpo_ladder's outer PSO (float32), and the sharded PSO runs'
    # (distributed_8dev, the headline through ShardedProblem).
    routes["float32"] += results["hpo_main_path"]["launches"]["fused_pso_move"]
    routes["float32"] += results["distributed_main_path"]["launches"]["fused_pso_move"]
    # The resilient runner's counted runs (pso_small_resilient's cold run,
    # the headline under the runner), and the control plane's: hpo_ladder's
    # outer PSO under the HPO runner and the growth ladder, and
    # pso_small_resilient's cadence and trend runs.
    routes["float32"] += results["resilient_main_path"]["launches"]["fused_pso_move"]
    routes["float32"] += sum(results[p]["launches"]["fused_pso_move"]
                             for p in ("hpo_runner_main_path", "hpo_grow", "controller_cadence"))
    # The fleets' worker processes (distributed_8dev's width), each
    # worker's count through its last boundary (a SIGKILLed worker's too).
    routes["float32"] += sum(results[p]["launches"]["fused_pso_move"] for p in ("fleet_main_path", "fleet_straggler"))
    routes["float32"] += sum(results[p]["launches"]["fused_pso_move"]
                             for p in HPO_WORKLOAD_PHASES + GATEWAY_PHASES + ROUTER_PHASES + CHAOS_PHASES)
    # vis_main_path's quick start (100 eager steps) and its plugin's step.
    routes["float32"] += results["vis_main_path"]["launches"]["fused_pso_move"]
    # The outer PSO over the nest split over the mesh (the NCCL run and the
    # gloo processes), and the fallback run's generations on the card.
    routes["float32"] += sum(results[p]["launches"]["fused_pso_move"] for p in SLICE_26_PHASES)
    emit("kernels", [
        {
            "name": "fused_pso_move",
            "route": "cuda",
            "source": "evox_tpu_torch/csrc/pso_move.cu",
            "replaces": "evox_tpu/ops/pso_step.py:77",
            "launches": sum(routes.values()),
            "launches_by_route": routes,
            # The bfloat16 route at the headline's shape (``timing``).
            "bfloat16_route": {k: timing["bfloat16_hw"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            # compare's shapes, and the moves held on the precision paths.
            "max_abs_err": max([results["compare"]["max_abs_err"]]
                               + [results[p]["move_vs_plain"]["max_abs_err"]
                                  for p in ("pso_policy_main_path", "pso_bf16_main_path")]
                               + [results["key_impl_twins"][t]["move_vs_plain"]["max_abs_err"] for t in TWINS]
                               + [results[p]["move_vs_plain"]["max_abs_err"] for p in ("hpo_main_path", "hpo_mesh_main_path")]
                               # The fleet workers' moves (each also 0 bits differing).
                               + [r["max_abs_err"] for p in ("fleet_main_path", "fleet_straggler")
                                  for r in results[p]["move_vs_plain"].values()]),
            "ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": None,
        }
    ] + [
        kernel_row(name, source, replaces, results, timing_key)
        for name, source, replaces, timing_key in MO_KERNELS
    ] + [philox_row(results)] + batched_rows(results) + [eigh_row(results)])
    print(f"total seconds: {time.perf_counter() - t_start:.1f}", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
