"""Where the Jacobi eigensolver's one kernel spends its time: a copy of
``csrc/eigh_jacobi.cu`` with SM clock counters (``clock64``) on block 0's
solver and block 1's J block, built beside the real library and run in its
place on ``chip_smoke.py``'s matrices; one JSON line.

The profiler sees one kernel a call, so it cannot split the phases; this
probe can.  For n = 64 and 1000 (``spectrum_matrix``, condition 1e3) in
float32 and float64 it reports SM cycles: an inner round of the pair solve
(warp 0's rotations, a worker warp's S update, the round to its barrier), a
whole solve and its prologue (the diagonal's roots, the sub-matrix's load
with the rotation test, round 0's rotations), an outer round's phases (the
solves, the wait at the grid barrier after them, the A apply, the wait
after it), and the J block (its cycles, its cycles and polls waiting on
the solver).  The counters are read-modify-writes of global memory on warp
0's path, so the instrumented kernel runs ~10 % slower than the real one;
``ms`` is the instrumented kernel's, beside ``ms_real``.  The copy must
give the real kernel's bits (``same_bits``).

The edits name lines of the source: when the kernel changes, an edit that
no longer matches stops the probe with the line it looked for.

    python tools/eigh_phase_probe.py

Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

COUNTERS = r'''
extern "C" int eigh_probe_counters(long long* out, int reset) {
  if (reset) {
    long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_probe, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_probe, 32 * sizeof(long long));
}
'''

# (what the source says, what the probe's copy says instead)
EDITS = [
    ("namespace cg = cooperative_groups;", "namespace cg = cooperative_groups;\n__device__ long long g_probe[32];"),
    # an inner round
    ("      const int cur = (k & 1) * kPairs, nxt = kPairs - cur;\n      const double* Sc",
     "      const long long t0 = clock64();\n      const int cur = (k & 1) * kPairs, nxt = kPairs - cur;\n"
     "      const double* Sc"),
    ("        any |= rot;\n      } else if (ww >= 0) {\n"
     "        update_s(Sc, Sn, rd.next[k], mine, pc + cur, ps + cur, ppp + cur, pqq + cur, ir + cur);\n"
     "      } else if (warp == kPublisher) {\n        publish(cs, ready, epoch, k, pc[cur + lane], ps[cur + lane]);\n"
     "      }\n      __syncthreads();",
     "        any |= rot;\n        if (tid == 0 && blockIdx.x == 0) g_probe[0] += clock64() - t0;\n"
     "      } else if (ww >= 0) {\n"
     "        update_s(Sc, Sn, rd.next[k], mine, pc + cur, ps + cur, ppp + cur, pqq + cur, ir + cur);\n"
     "        if (tid == 32 && blockIdx.x == 0) g_probe[1] += clock64() - t0;\n"
     "      } else if (warp == kPublisher) {\n        publish(cs, ready, epoch, k, pc[cur + lane], ps[cur + lane]);\n"
     "      }\n      __syncthreads();\n"
     "      if (tid == 0 && blockIdx.x == 0) { g_probe[3] += clock64() - t0; g_probe[4] += 1; }"),
    # a solve and its prologue
    ("  int lo, hi;\n  pair_of(N / kBw, r, m, &lo, &hi);\n  const T* A = pb.W + (size_t)b * N * N;\n  if (tid < kTile) {",
     "  const long long ts = clock64();\n  int lo, hi;\n  pair_of(N / kBw, r, m, &lo, &hi);\n"
     "  const T* A = pb.W + (size_t)b * N * N;\n  if (tid < kTile) {"),
    ("  const double floor_abs = eps * __ldcg(pb.norms + b * 2 + kFro) * kFloorRel;\n  __syncthreads();\n"
     "  // S into round 0's order;",
     "  const double floor_abs = eps * __ldcg(pb.norms + b * 2 + kFro) * kFloorRel;\n  __syncthreads();\n"
     "  const long long ta = clock64();\n  // S into round 0's order;"),
    ("  int any = 0;\n  if (__syncthreads_or(above)) {\n    // This thread's S blocks",
     "  int any = 0;\n  const int above_any = __syncthreads_or(above);\n  const long long tb = clock64();\n"
     "  if (tid == 0 && blockIdx.x == 0) { g_probe[17] += ta - ts; g_probe[18] += tb - ta; }\n"
     "  if (above_any) {\n    // This thread's S blocks"),
    ("    __syncthreads();\n    for (int k = 0; k < kRounds - 1; ++k) {",
     "    __syncthreads();\n    if (tid == 0 && blockIdx.x == 0) g_probe[19] += clock64() - tb;\n"
     "    for (int k = 0; k < kRounds - 1; ++k) {"),
    ("  any = __syncthreads_or(any);\n  if (tid == 0) {\n    pb.rot[",
     "  any = __syncthreads_or(any);\n  if (tid == 0 && blockIdx.x == 0) { g_probe[5] += clock64() - ts; g_probe[6] += 1; }\n"
     "  if (tid == 0) {\n    pb.rot["),
    # the J block (block 1: the pair's at n = 64)
    ("  const int base = 128 * epoch;\n  for (int e = tid;",
     "  const long long tj = clock64();\n  const int base = 128 * epoch;\n  for (int e = tid;"),
    ("      for (long long spin = 0; v < base + k0 + 1 && spin < kSpinLimit; ++spin) v = *ready;",
     "      const long long tw = clock64();\n"
     "      for (long long spin = 0; v < base + k0 + 1 && spin < kSpinLimit; ++spin) v = *ready;\n"
     "      if (blockIdx.x == 1) { g_probe[13] += clock64() - tw; g_probe[14] += 1; }"),
    ("  // After the 63 rounds J's columns are in the natural order (buffer 1).",
     "  if (tid == 0 && blockIdx.x == 1) { g_probe[15] += clock64() - tj; g_probe[16] += 1; }\n"
     "  // After the 63 rounds J's columns are in the natural order (buffer 1)."),
    # an outer round's phases (block 0)
    ("      const int solves = 2 * B * P, epoch = sweep * R + r + 1;\n",
     "      const int solves = 2 * B * P, epoch = sweep * R + r + 1;\n      const long long tp = clock64();\n"),
    ("      grid.sync();\n      halves(blockIdx.x, G, B * tri,",
     "      const long long tq = clock64();\n      grid.sync();\n"
     "      if (threadIdx.x == 0 && blockIdx.x == 0) { g_probe[8] += tq - tp; g_probe[9] += clock64() - tq; }\n"
     "      const long long tz = clock64();\n      halves(blockIdx.x, G, B * tri,"),
    ("apply_a(pb, r, w, base); });\n      grid.sync();",
     "apply_a(pb, r, w, base); });\n      const long long tx = clock64();\n      grid.sync();\n"
     "      if (threadIdx.x == 0 && blockIdx.x == 0) { g_probe[10] += tx - tz; g_probe[11] += clock64() - tx; "
     "g_probe[12] += 1; }"),
]


def instrumented_source() -> str:
    src = (ROOT / "evox_tpu_torch" / "csrc" / "eigh_jacobi.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"eigh_phase_probe: the source no longer has, once, the line:\n{old}")
        src = src.replace(old, new)
    return src + COUNTERS


def build():
    from evox_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "eigh_phase_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "eigh_jacobi_probe.cu", out / "libeigh_jacobi_probe.so"
    src.write_text(instrumented_source())
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"eigh_phase_probe: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib


def use(lib):
    """Route ``ops.linalg.eigh_jacobi`` to ``lib`` (the real library's
    entry points, plus the counters)."""
    from evox_tpu_torch.ops import _build, linalg

    handle = ctypes.CDLL(str(lib))
    with _build._lock:
        _build._loaded["eigh_jacobi"] = handle
    _build.entry.cache_clear()
    linalg._blocks_per_sm.cache_clear()
    return handle


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing to probe", file=sys.stderr)
        return 1
    from evox_tpu_torch.ops import _build, linalg

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    device = torch.device("cuda")
    mats = {(n, dt): cs.spectrum_matrix(n, "spread", dt, device) for n in (64, 1000) for dt in (torch.float32, torch.float64)}
    real = {}
    for key, C in mats.items():
        real[key] = (linalg.eigh_jacobi(C[None]), cs.time_ms(lambda: linalg.eigh_jacobi(C[None]), 3, warmup=1))
    handle = use(build())
    rows = {}
    for (n, dt), C in mats.items():
        got = linalg.eigh_jacobi(C[None])
        same = all(torch.equal(a, b) for a, b in zip(got, real[(n, dt)][0]))
        ms = cs.time_ms(lambda: linalg.eigh_jacobi(C[None]), 3, warmup=1)
        buf = (ctypes.c_longlong * 32)()
        handle.eigh_probe_counters(buf, 1)
        linalg.eigh_jacobi(C[None])
        torch.cuda.synchronize()
        handle.eigh_probe_counters(buf, 0)
        d = list(buf)
        inner, solves, outer, builds = (max(d[i], 1) for i in (4, 6, 12, 16))
        rows[f"{n}_{str(dt)[6:]}"] = {
            "sweeps": int(got[2][0]), "same_bits": same, "ms": ms, "ms_real": real[(n, dt)][1],
            "inner_round": {"warp0_rotations": d[0] / inner, "worker_update": d[1] / inner, "round": d[3] / inner},
            "solve": {"cycles": d[5] / solves, "inner_rounds": inner / solves, "roots_of_diagonal": d[17] / solves,
                      "load_and_test": d[18] / solves, "round0_rotations": d[19] / solves},
            "outer_round": {"solves": d[8] / outer, "solves_wait": d[9] / outer, "apply_a": d[10] / outer,
                            "apply_a_wait": d[11] / outer, "rounds": outer},
            "j_block": {"cycles": d[15] / builds, "waiting": d[13] / builds, "polls": d[14] / builds} if n == 64 else None,
        }
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": cs.card_line(), "sm_clock": clocks, "cases": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
