"""Which linear-algebra routes a CUDA graph can capture on this card.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/linalg_capture_probe/probe.py

For each route (PyTorch's ``torch.linalg`` calls at the ES family's
shapes, and cuSOLVER's eigensolvers called directly through
``cusolver_probe.cu``, built with nvcc) it prints one JSON line: the host
syncs an eager call makes (``torch.cuda.set_sync_debug_mode``), its time
by CUDA events, whether a capture succeeds, and whether the replay gives
the eager bits.  Each route runs in a subprocess of its own, since a
refused capture may leave its process unusable.  The findings are what
``evox_tpu_torch/ops/linalg.py`` is built on.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
# Built into the package's build directory (listed in .gitignore).
BUILD = os.path.join(HERE, "..", "..", "evox_tpu_torch", "build", "linalg_probe")
LIB = os.path.join(BUILD, "libcusolver_probe.so")


def spd(n, seed, dtype):
    import torch
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, n, generator=g, dtype=torch.float64)
    return (a @ a.T / n + torch.eye(n, dtype=torch.float64)).to(dtype)


def flat(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    for v in x:
        out += flat(v)
    return out


def cusolver_fn(kind, n, dev):
    import torch
    lib = ctypes.CDLL(LIB)
    lib.probe_init.argtypes = [ctypes.c_int, ctypes.c_double]
    lib.probe_ws.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.probe_ws.restype = ctypes.c_longlong
    lib.probe_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    assert lib.probe_init(100, 0.0) == 0
    A0 = spd(n, 1, torch.float32).to(dev)
    W = torch.empty(n, device=dev)
    ws = lib.probe_ws(kind, n, A0.data_ptr(), W.data_ptr())
    if ws < 0:
        raise RuntimeError(f"bufferSize failed {ws}")
    work = torch.empty(max(int(ws), 4), dtype=torch.uint8, device=dev)
    info = torch.zeros(1, dtype=torch.int32, device=dev)

    def fn():
        A = A0.clone()
        w = torch.empty(n, device=dev)
        err = lib.probe_run(kind, n, A.data_ptr(), w.data_ptr(), work.data_ptr(), work.numel(), info.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"probe_run returned {err}")
        return w, A.T.contiguous(), info.clone()

    return fn, A0, ws


def torch_case(name, dev):
    import torch
    n = 1000 if name.endswith("1000") else 20
    A = spd(n, 1, torch.float32).to(dev)
    X = torch.randn(20, 20, generator=torch.Generator().manual_seed(2)).to(dev)
    R = torch.randn(8, 20, generator=torch.Generator().manual_seed(3)).to(dev)
    table = {
        "eigh20": lambda: torch.linalg.eigh(A),
        "eigh1000": lambda: torch.linalg.eigh(A),
        "eigvalsh20": lambda: torch.linalg.eigvalsh(A),
        "svd20": lambda: torch.linalg.svd(X, full_matrices=False),
        "svd8x20": lambda: torch.linalg.svd(R, full_matrices=False),
        "qr20x8": lambda: torch.linalg.qr(R.T),
        "qr20x20": lambda: torch.linalg.qr(X),
        "geqrf_householder20x8": lambda: torch.linalg.householder_product(*torch.geqrf(R.T)),
        "cholesky_ex20": lambda: torch.linalg.cholesky_ex(A, check_errors=False),
        "solve_ex20": lambda: torch.linalg.solve_ex(A, X, check_errors=False),
        "lu_factor_ex_solve20": lambda: torch.linalg.lu_solve(*torch.linalg.lu_factor_ex(A, check_errors=False)[:2], X),
        "matrix_exp20": lambda: torch.linalg.matrix_exp(X * 0.1),
        "argsort_stable8192": lambda: torch.argsort(torch.randn(8192, device=dev), stable=True),
    }
    return table[name], A


def run_case(name):
    import torch
    dev = torch.device("cuda")
    row = {"case": name}
    if name.startswith("cusolver"):
        _, kind, n = name.split("_")
        fn, A, ws = cusolver_fn(int(kind), int(n), dev)
        row["workspace_bytes"] = ws
    else:
        fn, A = torch_case(name, dev)
    out = fn()
    torch.cuda.synchronize()
    out2 = fn()
    torch.cuda.synchronize()
    row["eager_deterministic"] = all(torch.equal(a, b) for a, b in zip(flat(out), flat(out2)))
    if name.startswith("cusolver") or name.startswith("eigh"):
        w, v = flat(out)[0], flat(out)[1]
        A64 = A.double().cpu()
        w64 = torch.linalg.eigvalsh(A64)
        row["eigval_max_rel"] = float(((w.double().cpu() - w64).abs() / w64.abs()).max())
        V = v.double().cpu()
        recon = (V * w.double().cpu()) @ V.T
        row["recon_rel_fro"] = float(torch.linalg.norm(recon - A64) / torch.linalg.norm(A64))
        row["orth_err"] = float((V.T @ V - torch.eye(V.shape[0], dtype=torch.float64)).abs().max())
        if len(flat(out)) > 2:
            row["info"] = int(flat(out)[2][0])
    # host syncs when eager
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    row["eager_sync_warnings"] = len(caught)
    row["eager_sync_msgs"] = sorted({str(c.message)[:120] for c in caught})[:3]
    # eager time
    st, en = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    iters = 5 if name.endswith("1000") else 50
    st.record()
    for _ in range(iters):
        fn()
    en.record()
    torch.cuda.synchronize()
    row["eager_ms"] = st.elapsed_time(en) / iters
    # capture
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            cap = fn()
    except Exception as e:  # noqa: BLE001 - the probe reports what CUDA refused, and stops
        row["captured"] = False
        row["capture_error"] = f"{type(e).__name__}: {str(e)[:400]}"
        print(json.dumps(row), flush=True)
        return
    row["captured"] = True
    g.replay()
    torch.cuda.synchronize()
    ref = fn()
    torch.cuda.synchronize()
    row["replay_equals_eager"] = all(torch.equal(a, b) for a, b in zip(flat(cap), flat(ref)))
    st.record()
    for _ in range(iters):
        g.replay()
    en.record()
    torch.cuda.synchronize()
    row["replay_ms"] = st.elapsed_time(en) / iters
    print(json.dumps(row), flush=True)


def main():
    import torch
    print(json.dumps({"python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.time()
    b = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", LIB, os.path.join(HERE, "cusolver_probe.cu"),
                        "-lcusolver", "-Xlinker", "-rpath", "-Xlinker", "/usr/local/cuda/lib64"],
                       capture_output=True, text=True)
    print(json.dumps({"build_rc": b.returncode, "build_s": time.time() - t0, "out": (b.stdout + b.stderr)[-1500:]}),
          flush=True)
    cases = ["eigh20", "eigh1000", "eigvalsh20", "svd20", "svd8x20", "qr20x8", "qr20x20",
             "geqrf_householder20x8", "cholesky_ex20", "solve_ex20", "lu_factor_ex_solve20", "matrix_exp20",
             "argsort_stable8192"]
    if b.returncode == 0:
        cases += ["cusolver_0_20", "cusolver_1_20", "cusolver_2_20", "cusolver_3_20",
                  "cusolver_1_1000", "cusolver_2_1000", "cusolver_3_1000"]
    for c in cases:
        r = subprocess.run([sys.executable, __file__, c], capture_output=True, text=True, timeout=300)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        if r.returncode != 0 or not line:
            print(json.dumps({"case": c, "rc": r.returncode, "stderr": r.stderr[-800:]}), flush=True)
        else:
            print(line[-1], flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_case(sys.argv[1])
    else:
        main()
