"""What torch.distributed does with two ranks of one host on one CUDA card.

    python tools/fleet_card_probe.py

Starts two processes on ``cuda:0`` (a TCP store on a free loopback port) for
each case and prints one JSON line: per case and rank, what the rank's
collective returned or raised.

* ``nccl`` — an NCCL group whose two ranks bind the same card
  (``device_id=cuda:0``) and one all-gather on it;
* ``gloo_cuda`` — a gloo group whose ranks hand the all-gather tensors on
  the card directly (``all_gather_into_tensor`` and the list form
  ``all_gather``), the values checked; where gloo takes them, µs a call
  of that route against the block staged through the host by the caller;
* ``port_route`` — the route the port's fleet takes: ``init_multi_host``
  on the card (two ranks, one card: a gloo group), ``make_pop_mesh()``
  (its device: the card) and ``all_gather_rows`` (the card's block handed
  to gloo as it is).

Each case's ranks are joined within ``--timeout`` seconds or killed (an
NCCL rank may wait for its peer's failed communicator).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8192  # a rank's fitness block at distributed_8dev's width


def time_routes(dist, local) -> dict:
    """µs a call of the gloo all-gather of a block on the card: handed to
    gloo as it is (``direct``), and copied to the host, gathered there and
    copied back by the caller (``staged``), in turns
    (direct, staged, staged, direct; 50 calls each after 5 warm-ups)."""
    import torch

    def direct():
        out = torch.empty(2 * local.numel(), device=local.device)
        dist.all_gather_into_tensor(out, local)
        return out

    def staged():
        host = local.cpu()
        out = torch.empty(2 * local.numel())
        dist.all_gather_into_tensor(out, host)
        return out.to(local.device)

    times: dict = {"direct": [], "staged": []}
    for name in ("direct", "staged", "staged", "direct"):
        fn = direct if name == "direct" else staged
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 50 * 1e6)
    return times


def rank_main(case: str, rank: int, port: int) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kw = dict(init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2,
              timeout=datetime.timedelta(seconds=30))
    out: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    local = torch.full((N,), float(rank + 1), device=dev)
    want = torch.cat([torch.full((N,), 1.0), torch.full((N,), 2.0)])
    try:
        if case == "nccl":
            out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
            dist.init_process_group("nccl", device_id=dev, **kw)
            gathered = torch.empty(2 * N, device=dev)
            dist.all_gather_into_tensor(gathered, local)
            torch.cuda.synchronize()
            out["all_gather_into_tensor"] = bool(torch.equal(gathered.cpu(), want))
        elif case == "gloo_cuda":
            dist.init_process_group("gloo", **kw)
            for name, fn in (
                ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(2 * N, device=dev), local)),
                ("all_gather", lambda: dist.all_gather([torch.empty(N, device=dev) for _ in range(2)], local)),
            ):
                try:
                    fn()
                    torch.cuda.synchronize()
                    out[name] = "ok"
                except Exception as e:  # noqa: BLE001 - the probe reports what was raised
                    out[name] = f"{type(e).__name__}: {str(e)[:400]}"
            parts = [torch.empty(N, device=dev) for _ in range(2)]
            try:
                dist.all_gather(parts, local)
                out["all_gather_values"] = bool(torch.equal(torch.cat(parts).cpu(), want))
            except Exception as e:  # noqa: BLE001
                out["all_gather_values"] = f"{type(e).__name__}"
            if out["all_gather_into_tensor"] == "ok":
                out["us_per_call"] = time_routes(dist, local)
        else:
            sys.path.insert(0, ROOT)
            from evox_tpu_torch.parallel import all_gather_rows, init_multi_host, make_pop_mesh

            os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"] = "127.0.0.1", str(port)
            init_multi_host(num_processes=2, process_id=rank, timeout=30)
            out["backend"] = dist.get_backend()
            mesh = make_pop_mesh()
            out["mesh_device"] = str(mesh.device)
            gathered = all_gather_rows(local, mesh)
            out["device"] = str(gathered.device)
            out["values"] = bool(torch.equal(gathered.cpu(), want))
            for _ in range(5):
                all_gather_rows(local, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                all_gather_rows(local, mesh)
            torch.cuda.synchronize()
            out["us_per_call"] = (time.perf_counter() - t0) * 1e4
        out["result"] = "ok"
    except Exception as e:  # noqa: BLE001
        out["result"] = f"{type(e).__name__}: {str(e)[:600]}"
    finally:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 - a broken group may not tear down
                pass
    return out


def run_case(case: str, timeout: float) -> dict:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--case", case, "--port", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    out = {}
    deadline = time.monotonic() + timeout
    for r, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            out[f"rank{r}"] = json.loads(lines[-1]) if lines else {"rc": p.returncode, "stderr": stderr[-800:]}
        except subprocess.TimeoutExpired:
            out[f"rank{r}"] = {"result": f"no answer within {timeout} s"}
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--case")
    ap.add_argument("--port", type=int)
    ap.add_argument("--timeout", type=float, default=90.0)
    args = ap.parse_args()
    if args.rank is not None:
        print(json.dumps(rank_main(args.case, args.rank, args.port)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fleet_card_probe: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, **{c: run_case(c, args.timeout) for c in ("nccl", "gloo_cuda", "port_route")}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
