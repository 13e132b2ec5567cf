"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library under the package's
``build/`` directory (listed in ``.gitignore``) on first use and loaded
with :mod:`ctypes`.  The library's file name carries a hash of the source,
of every header under ``csrc/`` (``*.cuh``, ``*.h``) and of the flags, so an
edited source or shared header is rebuilt and a stale library is never
loaded.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path

__all__ = [
    "SOURCES", "build", "load", "entry", "launch", "workspace", "pointer", "sm_count",
    "counts", "library_names", "loaded", "install", "add_library_source",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# Every kernel source of the port, by library name.
SOURCES = ("pso_move", "philox", "dominance", "topk", "crowding", "probe", "linalg", "eigh_jacobi")

# Libraries a source links beyond the CUDA runtime (``linalg.cu`` binds
# cuSOLVER), found at run time through the toolkit's ``lib64``.
LINK = {"linalg": ("-lcusolver",)}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # No contraction of a*b+c into an FMA: the kernels round like the
    # plain PyTorch versions, operator by operator.
    "--fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_loaded_paths: dict[str, Path] = {}

#: Libraries this process compiled with ``nvcc`` (``builds``) and placed
#: from a verified copy instead (``installs``).
counts = {"builds": 0, "installs": 0}

# Weak references to the callables asked for a missing library's bytes.
_sources: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
            "/usr/local/cuda/bin): the port's CUDA kernels cannot be built"
        )
    return str(path)


def _link_flags(name: str, nvcc: str) -> tuple[str, ...]:
    libs = LINK.get(name, ())
    if not libs:
        return ()
    lib64 = Path(nvcc).resolve().parent.parent / "lib64"
    return (*libs, "-Xlinker", f"-rpath={lib64}")


def _library_path(name: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted([*csrc.glob("*.cuh"), *csrc.glob("*.h")]):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK.get(name, ())).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def library_names(names=SOURCES) -> dict[str, str]:
    """The file name :func:`build` gives each source's library in this
    checkout (its hash of the source, the headers and the flags)."""
    return {name: _library_path(name).name for name in names}


def loaded() -> dict[str, Path]:
    """The libraries this process has loaded, by source name."""
    with _lock:
        return dict(_loaded_paths)


def install(file_name: str, data: bytes, sha256: str) -> bool:
    """Place a library's bytes under the name :func:`build` would give it,
    instead of building it.  Refused with :class:`ValueError`, and nothing
    written, unless ``file_name`` is the current library name of one of
    :data:`SOURCES` and the bytes' SHA-256 is ``sha256``.  The write is
    atomic (temp file, ``fsync``, ``os.replace``); returns ``False`` when
    the library is there already."""
    if file_name not in set(library_names().values()):
        raise ValueError(f"{file_name!r} is no library of this checkout's kernel sources")
    actual = hashlib.sha256(data).hexdigest()
    if actual != sha256:
        raise ValueError(f"library {file_name}: SHA-256 {actual[:12]}... is not the recorded {str(sha256)[:12]}...")
    path = BUILD_DIR / file_name
    if path.exists():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.install")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    counts["installs"] += 1
    return True


def add_library_source(source) -> None:
    """Register ``source(file_name) -> (bytes, sha256) | None``, asked for
    a missing library before ``nvcc`` builds it.  Held by a weak reference
    (a bound method's object may be collected)."""
    ref = weakref.WeakMethod(source) if hasattr(source, "__self__") else weakref.ref(source)
    _sources.append(ref)


def _supplied(file_name: str) -> bool:
    """Whether a registered source installed ``file_name``; a source whose
    bytes fail :func:`install`'s checks is passed over."""
    for ref in list(_sources):
        source = ref()
        if source is None:
            _sources.remove(ref)
            continue
        got = source(file_name)
        if got is None:
            continue
        try:
            install(file_name, *got)
        except ValueError:
            continue
        return True
    return False


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together, and wait for them.  A missing
    library a registered source supplies is installed instead.  The
    compiler's report (registers, spills) is kept beside each library as
    ``<library>.log``.  Raises :class:`RuntimeError` if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists() and not _supplied(p.name)}
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *_link_flags(name, nvcc)]
        counts["builds"] += 1
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        Path(f"{paths[name]}.log").write_text(out)
        os.replace(tmp, paths[name])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
            _loaded_paths[name] = path
        return lib


@functools.cache
def entry(name: str, fn: str, argtypes: tuple, restype=ctypes.c_int):
    """The C function ``fn`` of ``csrc/<name>.cu`` with its ``argtypes``
    declared (pointers and the stream as ``c_void_p``), returning
    ``restype`` (``int`` unless given)."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


def launch(what: str, f, device, *args) -> None:
    """Call the C entry point ``f(*args, stream)`` on ``device``'s current
    stream and raise if its launch failed (the entry point returns
    ``cudaGetLastError()`` after the launch).  The device is made current
    around the call only when it is not already."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = f(*args, stream)
    else:
        with torch.cuda.device(device):
            err = f(*args, stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def workspace(name: str, fn: str, device, *sizes: int):
    """Device scratch of the bytes that the C function ``fn(*sizes)`` of
    ``csrc/<name>.cu`` asks for, as a uint8 tensor on ``device`` (``None``
    when it asks for none).  The caller keeps it alive across the launch
    that uses it."""
    import torch

    nbytes = entry(name, fn, (ctypes.c_int,) * len(sizes), ctypes.c_longlong)(*sizes)
    return torch.empty((nbytes,), dtype=torch.uint8, device=device) if nbytes else None


def pointer(t) -> int | None:
    """``t.data_ptr()``, or ``None`` (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index`` (grid sizing)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count

