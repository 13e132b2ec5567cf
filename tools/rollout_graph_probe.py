"""Where the time of a neuroevolution generation goes on a CUDA card, eager
against fused.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/rollout_graph_probe.py

It builds chip_smoke.py's neuroevolution workflow (bench.py's config: OpenES
at pop 2048 on cart-pole, 200 steps, MLP 4-32-32-1), and prints one JSON
line for each of: one eager step (the rollout's own captured graph
replayed), one replay of run(1)'s and run(5)'s graphs, from torch.profiler:
device operations, busy and spanned ms, the gaps between consecutive device
operations (summed, as a histogram in µs, and the largest with the
operations around them); then the host time of each graph's ``replay()``
call alone beside its time by CUDA events.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from evox_tpu_torch.ops import _build  # noqa: E402


def gap_bucket(g: float) -> str:
    for hi, name in ((0, "<0"), (0.5, "0-0.5"), (1, "0.5-1"), (2, "1-2"), (5, "2-5"), (20, "5-20")):
        if g < hi:
            return name
    return ">20"


def timeline(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))),
                key=lambda e: e.time_range.start)
    gaps = [(b.time_range.start - a.time_range.end, a.name[:50], b.name[:50]) for a, b in zip(ev, ev[1:])]
    hist: dict = {}
    for g, _, _ in gaps:
        hist[gap_bucket(g)] = hist.get(gap_bucket(g), 0) + 1
    durs = sorted(e.time_range.elapsed_us() for e in ev)
    return {"events": len(ev), "busy_ms": sum(durs) / 1e3,
            "span_ms": (ev[-1].time_range.end - ev[0].time_range.start) / 1e3,
            "gap_ms": sum(max(g, 0) for g, _, _ in gaps) / 1e3, "gap_hist_us": hist,
            "median_op_us": durs[len(durs) // 2], "largest_gaps": sorted(gaps, key=lambda x: -x[0])[:6]}


def main() -> int:
    if not torch.cuda.is_available():
        print("rollout_graph_probe: no CUDA card", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _build.build()
    wf, _ = cs.neuroevolution_workflow(torch.device("cuda"))
    state = wf.init_step(wf.init(0))
    for _ in range(3):
        state = wf.step(state)
    for n in (1, 5):
        wf.run(state, n, init=False)
    print("eager_step", json.dumps(timeline(lambda: wf.step(state))), flush=True)
    for n in (1, 5):
        print(f"run{n}", json.dumps(timeline(lambda: wf.run(state, n, init=False))), flush=True)
    graphs = [("rollout_graph", next(iter(wf.problem._graphs.graphs.values())))]
    graphs += [(f"run{k[2]}_graph", c) for k, c in wf._graphs.graphs.items()]
    for label, cap in graphs:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        cap.graph.replay()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        print(label, json.dumps({"replay_call_host_ms": host_ms, "event_ms": start.elapsed_time(end)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
