#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``evox_tpu_torch``) on one CUDA card.

Run from the root of a checkout:

    python3 chip_smoke.py

It builds every kernel of the port from ``evox_tpu_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, drives the main path
(PSO on Sphere at pop=100000, dim=1000, through ``StdWorkflow``; then the
README quick start, PSO on Ackley with an ``EvalMonitor``), checks that the
path went through the kernels, and times them.  It prints one JSON line per
phase, a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero without that last line.  It needs one card and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))

HEADLINE = (100_000, 1000)  # bench.py's pso_northstar: pop=100k, dim=1000
COMPARE_SHAPES = [(100, 37), (64, 128), (30, 5), (64, 384), HEADLINE]
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


def move_inputs(n, d, dtype, seed, device):
    """Inputs of one fused move, with NaN fitness rows, NaN and +inf
    personal bests, NaN positions and values beyond the bounds ±2."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g, device=device)

    pop = (u(n, d) * 8 - 4).to(dtype)
    pop.view(-1)[:: max(1, (n * d) // 7)] = float("nan")
    fit = u(n)
    fit[::7] = float("nan")
    lbf = u(n)
    lbf[1::5] = float("inf")
    lbf[2::11] = float("nan")
    return dict(
        pop=pop,
        velocity=(u(n, d) * 6 - 3).to(dtype),
        local_best_location=(u(n, d) * 4 - 2).to(dtype),
        fit=fit.to(dtype),
        local_best_fit=lbf.to(dtype),
        global_best_location=(u(d) * 4 - 2).to(dtype),
        lb=torch.full((d,), -2.0, dtype=dtype, device=device),
        ub=torch.full((d,), 2.0, dtype=dtype, device=device),
        w=torch.tensor(0.6, dtype=dtype, device=device),
        phi_p=torch.tensor(2.5, dtype=dtype, device=device),
        phi_g=torch.tensor(0.8, dtype=dtype, device=device),
    ), (u(n, d).to(dtype), u(n, d).to(dtype))


def phase_compare(device) -> dict:
    """Kernel against plain version, both draw modes, float32 and bfloat16:
    float32 must agree exactly (0 ulp; -0 == +0, NaN at the same places),
    bfloat16 within 1 ulp."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain

    rows, worst = [], 0.0
    for dtype, limit in ((torch.float32, 0), (torch.bfloat16, 1)):
        for n, d in COMPARE_SHAPES:
            args, draws = move_inputs(n, d, dtype, seed=n * 7919 + d, device=device)
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
                    rows.append({"dtype": str(dtype).split(".")[-1], "shape": [n, d],
                                 "rand": rand, "out": name, **c})
                del got, want
            del args, draws
            torch.cuda.empty_cache()
    return {"checks": len(rows), "max_abs_err": worst,
            "max_ulp_f32": max(r["max_ulp"] for r in rows if r["dtype"] == "float32"),
            "max_ulp_bf16": max(r["max_ulp"] for r in rows if r["dtype"] == "bfloat16")}


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


def profile_steps(wf, state, steps):
    """Device time by kernel over ``steps`` generations (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state = wf.step(state)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + dev_us / 1e3 / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    busy = sum(kernels.values())
    return state, {
        "steps": steps,
        "wall_ms_per_gen_profiled": wall_ms / steps,
        "device_ms_per_gen": busy if kernels else "not measured",
        "kernels_ms_per_gen": {k[:80]: v for k, v in top},
    }


def phase_main_path(device) -> dict:
    """bench.py's headline through the port: StdWorkflow(PSO(100000, ±10 in
    dim 1000), Sphere()), init_step then warm-up, timed and profiled steps.
    The best fitness must fall, and every step must launch the kernel."""
    import torch
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.ops.pso_step import fused_pso_move
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    n, d = HEADLINE
    lb = torch.full((d,), -10.0, device=device)
    ub = torch.full((d,), 10.0, device=device)
    wf = StdWorkflow(PSO(n, lb, ub, device=device), Sphere())
    torch.cuda.reset_peak_memory_stats()
    fused_pso_move.launches = 0
    t0 = time.perf_counter()
    state = wf.init(0)
    state = wf.init_step(state)
    best0 = float(state.algorithm.global_best_fit)
    setup_s = time.perf_counter() - t0
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
    state, prof = profile_steps(wf, state, PROFILE_STEPS)
    launches = fused_pso_move.launches
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
        "launches": launches, "steps": steps,
        "ms_per_gen": ms, "gen_per_s": 1e3 / ms, "host_ms_per_gen": host_ms,
        "setup_s": setup_s, "best_after_init": best0, "best_final": best1,
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
    beyond the 50 MB L2, so every launch reads from device memory.  The
    bound counts each input byte read once and each output byte written
    once; float operations (16 per element) over 67 TFLOP/s give a far
    smaller time, so bytes bound it."""
    import torch
    from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain

    n, d = HEADLINE
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, draws = move_inputs(n, d, dtype, seed=5, device=device)
        size = torch.tensor([], dtype=dtype).element_size()
        key = str(dtype).split(".")[-1]
        for rand in ("hw", "input"):
            kw = dict(seed=99, rand=rand, rand_draws=draws if rand == "input" else None)
            nd_arrays = 6 + (2 if rand == "input" else 0)
            nbytes = size * (nd_arrays * n * d + 3 * n + 3 * d) + 12
            flops = 16 * n * d + n
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_F32_FLOPS * 1e3
            out[f"{key}_{rand}"] = {
                "ms": time_ms(lambda: fused_pso_move(**args, **kw), 20),
                "plain_ms": time_ms(lambda: fused_pso_move_plain(**args, **kw), 3, warmup=1),
                "bytes": nbytes, "bytes_ms": bytes_ms, "flop_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            }
            torch.cuda.empty_cache()
        del args, draws
        torch.cuda.empty_cache()
    return out


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

    t0 = time.perf_counter()
    libs = _build.build()
    ptxas = {
        name: [ln for ln in Path(f"{path}.log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        for name, path in libs.items()
    }
    emit("build", {"seconds": time.perf_counter() - t0, "ptxas": ptxas})

    results = {}
    for name, phase in (
        ("compare", phase_compare),
        ("draws", phase_draws),
        ("main_path", phase_main_path),
        ("quickstart", phase_quickstart),
        ("timing", phase_timing),
    ):
        t0 = time.perf_counter()
        results[name] = phase(device)
        results[name]["seconds"] = time.perf_counter() - t0
        emit(name, results[name])

    main_path, timing = results["main_path"], results["timing"]
    f32 = timing["float32_hw"]
    emit("kernels", [
        {
            "name": "fused_pso_move",
            "route": "cuda",
            "source": "evox_tpu_torch/csrc/pso_move.cu",
            "replaces": "evox_tpu/ops/pso_step.py:77",
            "launches": main_path["launches"],
            "max_abs_err": results["compare"]["max_abs_err"],
            "ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": None,
        }
    ])
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
