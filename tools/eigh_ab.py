"""Time the Jacobi eigensolver (``ops.linalg.eigh_jacobi``) of one tree of
the port on the card, and the CMA-ES path that runs it; one JSON line.

Run it once for each tree to compare, in turns, on one card:

    python tools/eigh_ab.py --tree PARENT --tag parent
    python tools/eigh_ab.py --tree . --tag change

``--tree`` is the directory that holds the ``evox_tpu_torch`` package to
time (a checkout, or ``git archive`` of another commit); the helpers and
the matrices come from this checkout's ``chip_smoke.py``.  For each case,
float32 and float64: the device time of one call (the median of three
profiler readings; all of its device operations), its device operations,
the sweeps, the kernel's launches, and ``torch.linalg.eigh``'s time on the
same matrix (CUDA events, median of five calls; it syncs with the host).
The cases: ``spectrum_matrix`` (condition 1e3, norm 1) at n = 64, 100 and
1000, and cmaes_cadence's covariance (CMAES(zeros(1000), 1.0) on Sphere,
2 + 16 eager steps from seed 0, symmetrised) at n = 1000.  Then a not-due
call at n = 1000 (``eigh(C, due=False)``: device time and operations) and
cmaes_cadence's ``run(16)``: ms a generation of a replay (the median of
five, after the capture).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (64, 100, 1000)
# The solver's kernels by name: this design's one, and the launch sequence's
# three before it.
KERNELS = ("eigh_jacobi_kernel", "solve_kernel", "apply_kernel", "norms_kernel")


def median_profile(cs, fn) -> dict:
    reads = [cs.launches_per_call(fn, calls=1, count_names=KERNELS) for _ in range(3)]
    return {"device_ms": statistics.median(r["device_ms"] for r in reads),
            "device_ops": statistics.median(r["launches"] for r in reads),
            "kernel_launches": statistics.median(sum(r["named"].values()) for r in reads)}


def events_ms(fn, calls=5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def case(cs, C) -> dict:
    import torch
    from evox_tpu_torch.ops import linalg

    _, _, sweeps, _ = linalg.eigh_jacobi(C[None])
    return {"sweeps": int(sweeps[0]), **median_profile(cs, lambda: linalg.eigh_jacobi(C[None])),
            "torch_linalg_eigh_ms": events_ms(lambda: torch.linalg.eigh(C))}


def cadence(cs, device):
    """cmaes_cadence's workflow, its state after 2 eager steps, and the
    symmetrised C after 16 more."""
    import torch
    from evox_tpu_torch.algorithms import CMAES
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    wf = StdWorkflow(CMAES(torch.zeros(cs.CADENCE_DIM), 1.0, device=device), Sphere())
    state = wf.init_step(wf.init(0))
    for _ in range(2):
        state = wf.step(state)
    s = state
    for _ in range(cs.CADENCE_GENS):
        s = wf.step(s)
    return wf, state, ((s.algorithm.C + s.algorithm.C.T) / 2).contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="directory holding the evox_tpu_torch package to time")
    ap.add_argument("--tag", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing to time", file=sys.stderr)
        return 1
    import importlib.util

    import evox_tpu_torch
    from evox_tpu_torch.ops import linalg

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    row = {"tag": args.tag, "package": os.path.dirname(evox_tpu_torch.__file__), "card": cs.card_line(), "cases": {}}
    for n in SIZES:
        for dt in (torch.float32, torch.float64):
            C = cs.spectrum_matrix(n, "spread", dt, device)
            row["cases"][f"spread_{n}_{str(dt)[6:]}"] = case(cs, C)
    wf, state, C = cadence(cs, device)
    for dt in (torch.float32, torch.float64):
        row["cases"][f"cadence_1000_{str(dt)[6:]}"] = case(cs, C.to(dt))
    no = torch.zeros((), dtype=torch.bool, device=device)
    row["not_due_1000"] = median_profile(cs, lambda: linalg.eigh(C, due=no))
    run = lambda: wf.run(state, cs.CADENCE_GENS, init=False)  # noqa: E731
    run()
    torch.cuda.synchronize()
    row["cadence_run16_ms_per_gen"] = statistics.median(events_ms(run, calls=1) / cs.CADENCE_GENS for _ in range(5))
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
