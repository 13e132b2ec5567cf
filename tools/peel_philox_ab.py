"""Time the front peel and the Philox draw kernel of one tree of the port on
the card, at the shapes their main paths give them, and the end-to-end
paths that run them; one JSON line.

Run it once for each tree to compare, in turns, on one card:

    python tools/peel_philox_ab.py --tree PARENT --tag parent
    python tools/peel_philox_ab.py --tree . --tag change

``--tree`` is the directory that holds the ``evox_tpu_torch`` package to
time (a checkout, or ``git archive`` of another commit); the helpers come
from this checkout's ``chip_smoke.py``.  Each kernel time is the median of
three profiler readings of the kernel's device time over 20 launches (5 at
10^8 draws), after a check that its outputs equal its plain version's.
With ``--e2e``, also the ms a generation of a replay of ``run(20)`` (the
median of five replays) of the NSGA-II headline, hpo_ladder, de_cec and
vmapped_family's NSGA-II and DE (20 vmapped generations, one captured
graph), and the device ms a generation of one profiled replay, all of it
and the two kernels'.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def median_device_ms(cs, fn, calls):
    return statistics.median(cs.launches_per_call(fn, calls=calls)["device_ms"] for _ in range(3))


def recorded_peels(cs, device):
    """The peel calls of the NSGA-II headline: init_step's (10,000 columns,
    every front) and the 20th generation's survivor selection (20,000
    merged columns, until_count 10,000), as (words, until_count)."""
    from evox_tpu_torch.operators.selection import non_dominate

    seen = []
    real = non_dominate.peel_fronts

    def record(words, until_count=None):
        seen.append((words.clone(), until_count))
        return real(words, until_count)

    wf = cs.nsga2_workflow(device, cs.NSGA2_POP)
    non_dominate.peel_fronts = record
    try:
        s = wf.init_step(wf.init(0))
        init = seen[-1]
        for _ in range(20):
            s = wf.step(s)
        last = seen[-1]
    finally:
        non_dominate.peel_fronts = real
    return {"peel_fronts_10k_init": init, "peel_fronts_20k": last}


def kernels(cs, device) -> dict:
    import torch
    from evox_tpu_torch.ops import dominance, philox
    from evox_tpu_torch.utils import rng

    out = {}
    for tag, (words, until) in recorded_peels(cs, device).items():
        rank = dominance.peel_fronts(words, until)
        if not torch.equal(rank, dominance.peel_fronts_plain(words, until)):
            raise AssertionError(f"{tag}: peel_fronts differs from its plain version")
        out[tag] = {"device_ms": median_device_ms(cs, lambda: dominance.peel_fronts(words, until), 20),
                    "columns": words.shape[1], "until": until, "fronts": cs.fronts_of(rank),
                    **cs.peel_bound(words, rank, until)}
    key = rng.key(2**63 + 1, device)
    for tag, b, numel, kinds in (("philox_batched_8x102400_f32", 8, 102_400, [torch.float32]),
                                 ("philox_batched_64x16384_f32", 64, 16_384, [torch.float32]),
                                 ("philox_batched_2048x4_f32", 2048, 4, [torch.float32])):
        keys = torch.stack([rng.key(s, device) for s in range(b)])
        got = philox.philox_draws_batched(keys, 0, numel, kinds)
        want = philox.philox_draws_batched_plain(keys, 0, numel, kinds)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: the draws differ from the plain version's")
        out[tag] = {"device_ms": median_device_ms(cs, lambda: philox.philox_draws_batched(keys, 0, numel, kinds), 20),
                    **cs.philox_bound(b * numel, kinds)}
    seed = rng.child(key, 1)
    for tag, numel, kinds in (
        ("philox_solo_1e8_f32", cs.PHILOX_BIG, [torch.float32]),
        ("philox_nsga2_sbx_60k", cs.NSGA2_POP // 2 * cs.NSGA2_DIM, [torch.float32, (0, 2), torch.float32, torch.float32]),
        ("philox_nsga2_pm_120k", cs.NSGA2_POP * cs.NSGA2_DIM, [torch.float32, torch.float32]),
        ("philox_nsga2_tournament_20k", cs.NSGA2_POP * 2, [(0, cs.NSGA2_POP)]),
        ("philox_de_cec_bin_cx_200k", cs.DE_POP * cs.DE_DIM, [torch.float32, (0, cs.DE_DIM)]),
        ("philox_de_cec_table_30k", 3 * cs.DE_POP, [(0, cs.DE_POP)]),
    ):
        got = philox.philox_draws(seed, numel, kinds, device)
        want = philox.philox_draws_plain(seed, numel, kinds, device)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag}: the draws differ from the plain version's")
        del got, want
        torch.cuda.empty_cache()
        calls = 5 if numel >= 10**7 else 20
        out[tag] = {"device_ms": median_device_ms(cs, lambda: philox.philox_draws(seed, numel, kinds, device), calls),
                    **cs.philox_bound(numel, kinds)}
    return out


def replay_ms(run, gens=20):
    """ms a generation: the median of five timed calls of ``run`` (each
    ``gens`` generations), after one untimed call (the capture)."""
    import torch

    run()
    torch.cuda.synchronize()
    return statistics.median(run_timed(run, gens) for _ in range(5))


def run_timed(run, gens):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / gens


def device_profile(run, gens=20) -> dict:
    """Device ms a generation of one profiled call of ``run``: all device
    operations, and the draw and peel kernels' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    total, ops, mine = 0.0, 0, {"philox_draw_kernel": 0.0, "peel_fronts_kernel": 0.0}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        ms = (e.end_ns() - e.start_ns()) / 1e6
        total, ops = total + ms, ops + 1
        for k in mine:
            if k in e.name():
                mine[k] += ms
    return {"device_ms_per_gen": total / gens, "device_ops_per_gen": ops / gens,
            **{f"{k}_ms_per_gen": v / gens for k, v in mine.items()}}


def end_to_end(cs, device) -> dict:
    import torch
    from torch.func import vmap
    from evox_tpu_torch.utils import rng

    out = {}
    for tag, make in (("nsga2_headline", lambda: cs.nsga2_workflow(device, cs.NSGA2_POP)),
                      ("hpo_ladder", lambda: cs.hpo_ladder_workflow(device)),
                      ("de_cec", lambda: cs.de_workflow("DE", device))):
        wf = make()
        s = wf.init_step(wf.init(0))
        s = wf.step(s)
        run = lambda: wf.run(s, 20, init=False)  # noqa: E731
        out[tag] = {"run20_ms_per_gen": replay_ms(run), **device_profile(run)}
        del wf, s
        torch.cuda.empty_cache()
    keys = torch.stack([rng.key(i, device) for i in range(cs.FAMILY_INSTANCES)])
    for tag, make in (("vmapped_family_nsga2", lambda: cs.mo_workflow("NSGA2", cs.FAMILY_NSGA2_POP, device)[0]),
                      ("vmapped_family_de", lambda: cs.family_de_workflow(device))):
        wf = make()
        s = vmap(wf.init_step)(vmap(wf.init)(keys))
        run = cs.vmapped_graph(vmap(wf.step), s, 20)
        out[tag] = {"graph20_ms_per_gen": replay_ms(run), **device_profile(run)}
        del wf, s
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="directory holding the evox_tpu_torch package to time")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--e2e", action="store_true", help="also time the end-to-end paths")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: nothing to time", file=sys.stderr)
        return 1
    import importlib.util

    import evox_tpu_torch

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    device = torch.device("cuda")
    t0 = time.perf_counter()
    row = {"tag": args.tag, "package": os.path.dirname(evox_tpu_torch.__file__), "card": cs.card_line(),
           "kernels": kernels(cs, device)}
    if args.e2e:
        row["end_to_end"] = end_to_end(cs, device)
    row["seconds"] = time.perf_counter() - t0
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
