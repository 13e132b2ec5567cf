"""Host-side costs of the distributed and checkpoint paths on one CUDA card,
printed as one JSON line.

    python tools/host_stall_probe.py                 # both parts
    TORCH_NCCL_TRACE_BUFFER_SIZE=0 python tools/host_stall_probe.py --part collective

``--part collective``: eager generations of bench.py's distributed_8dev
(``PSO(8192, ±10 in dim 256)``, Sphere) with ``enable_distributed=True``
over a one-rank NCCL group against the unsharded twin (host clock, 50
generations after 5), and the host time of one fitness all-gather alone.
The process group is made here, so the NCCL environment (for instance the
flight recorder's ``TORCH_NCCL_TRACE_BUFFER_SIZE``) applies.

``--part writer``: what slows eager generations of the PSO headline
(100000 x 1000, Sphere) while a checkpoint is written on another thread:
20 generations timed by CUDA events with, on a thread started just before
them, nothing; copies of the state off the card into pageable memory; into
pinned buffers allocated then, and into pinned buffers allocated before
(what ``AsyncCheckpointWriter`` does from its second write on); the
serialization of a host copy of the state with
``np.savez`` and with the port's writer (``utils.checkpoint._write_npz``);
and the digests alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pso(device, n, d, **kw):
    import torch

    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    lb = torch.full((d,), -10.0)
    return StdWorkflow(PSO(n, lb, -lb, device=device), Sphere(), **kw)


def collective(device) -> dict:
    import torch
    import torch.distributed as dist

    from evox_tpu_torch.parallel import all_gather_rows, make_pop_mesh

    mesh = make_pop_mesh()
    out = {}
    for tag, kw in (("sharded", {"enable_distributed": True, "mesh": mesh}), ("unsharded", {})):
        wf = pso(device, 8192, 256, **kw)
        s = wf.step(wf.init_step(wf.init(0)))
        for _ in range(5):
            s = wf.step(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            s = wf.step(s)
        torch.cuda.synchronize()
        out[f"{tag}_eager_host_ms_per_gen"] = (time.perf_counter() - t0) * 1e3 / 50
    fit = torch.rand(8192, device=device)
    all_gather_rows(fit, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        all_gather_rows(fit, mesh)
    torch.cuda.synchronize()
    out["all_gather_host_us"] = (time.perf_counter() - t0) * 1e6 / 200
    dist.destroy_process_group()
    return out


def writer(device) -> dict:
    import numpy as np
    import torch

    from evox_tpu_torch.utils import graph
    from evox_tpu_torch.utils.checkpoint import _archive_entries, _entry_digest, _write_npz

    wf = pso(device, 100_000, 1000)
    s = wf.step(wf.init_step(wf.init(0)))
    leaves = graph.flatten(s)[0]
    entries, _ = _archive_entries(s)
    tmp = tempfile.mkdtemp()

    def gens():
        x = s
        for _ in range(20):
            x = wf.step(x)
        return x

    def copy(into=None):
        """The leaves off the card: into pageable memory (``into`` None),
        into pinned buffers allocated here (``"alloc"``) or into the given
        pinned buffers."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            if into is None:
                kept = [t.to("cpu") for t in leaves]
            else:
                kept = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves] \
                    if into == "alloc" else into
                for b, t in zip(kept, leaves):
                    b.copy_(t, non_blocking=True)
        side.synchronize()
        return kept

    preallocated = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in leaves]

    def serialize(fn):
        with open(os.path.join(tmp, "probe.npz"), "wb") as f:
            fn(f, entries)

    cases = (
        ("nothing", None),
        ("pageable_copy", lambda: copy()),
        ("pinned_copy_allocating", lambda: copy("alloc")),
        ("pinned_copy_preallocated", lambda: copy(preallocated)),
        ("np_savez_host_copy", lambda: serialize(lambda f, a: np.savez(f, **a))),
        ("write_npz_host_copy", lambda: serialize(_write_npz)),
        ("digests", lambda: [_entry_digest(a) for a in entries.values()]),
        ("nothing_again", None),
    )
    gens()
    out = {}
    for name, fn in cases:
        thread = threading.Thread(target=fn) if fn is not None else None
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if thread is not None:
            thread.start()
        start.record()
        gens()
        end.record()
        torch.cuda.synchronize()
        overlapped = thread is not None and thread.is_alive()
        if thread is not None:
            thread.join()
        out[name] = {"ms_per_gen": start.elapsed_time(end) / 20, "thread_s": time.perf_counter() - t0,
                     "thread_outlived_the_gens": overlapped}
    os.remove(os.path.join(tmp, "probe.npz"))
    os.rmdir(tmp)
    return out


def main() -> int:
    import subprocess

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--part", choices=("collective", "writer", "both"), default="both")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("host_stall_probe: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda")
    out = {"card": card, "torch": torch.__version__,
           "env": {k: v for k, v in os.environ.items() if k.startswith("TORCH_NCCL")}}
    if args.part in ("collective", "both"):
        out["collective"] = collective(device)
    if args.part in ("writer", "both"):
        out["writer"] = writer(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
