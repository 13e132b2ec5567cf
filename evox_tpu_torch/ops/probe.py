"""Build-and-launch probe of the port's CUDA toolchain (counterpart of
``evox_tpu/ops/pallas_gate.py``'s capability probe).

:func:`run_capability_probe` builds ``csrc/probe.cu`` with the port's
``nvcc`` route, launches ``o = 2x`` on an (8, 128) float32 tensor on the
card and compares the result exactly with ``2 * x``.  A failed build, a
failed launch or a mismatch raises.  Unlike the JAX package's probe it
keeps no verdict file, starts no subprocess and opens no gate: on a CUDA
tensor every wrapper of the port launches its kernel or raises.

Run it alone with ``python -m evox_tpu_torch.ops.probe``: it prints the
result as JSON and exits 0, or prints the error and exits 1.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import torch

from .. import resolve_device
from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = ["run_capability_probe", "scale_by_two", "scale_by_two_plain"]

# Names of the JAX module that have another form here: reaching one raises
# ImportError naming the port's stand-in.
_STAND_INS = {
    "pallas_enabled": "the port opens no gate; on a CUDA tensor every wrapper launches its kernel or raises",
    "PROBE_RECORD_PATH": "run_capability_probe keeps no verdict file",
}


def __getattr__(name: str):
    if name in _STAND_INS:
        raise ImportError(f"evox_tpu_torch.ops.probe has no {name}: {_STAND_INS[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p)


def scale_by_two_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`scale_by_two`."""
    return 2 * x


@register_vmap_op(name="scale_by_two")
def _scale_op(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return scale_by_two_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"scale_by_two: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"scale_by_two: the CUDA kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("scale_by_two: x must be contiguous")
    out = torch.empty_like(x)
    fn = _build.entry("probe", "scale_by_two", _ARGS)
    _build.launch("scale_by_two", fn, x.device, x.data_ptr(), out.data_ptr(), x.numel())
    scale_by_two.launches += 1
    return out


def scale_by_two(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a float32 tensor: the probe kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    return _scale_op(x)


scale_by_two.launches = 0


def run_capability_probe(device: str | torch.device | None = None) -> dict:
    """Build the probe kernel, launch it on ``device`` (``None`` means the
    CUDA card) over an (8, 128) float32 tensor and compare with ``2 * x``
    exactly.  Returns ``{"ok": True, "device_kind": ..., "elapsed_s": ...}``;
    raises on a failed build, a failed launch or a wrong result."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the capability probe runs on a CUDA card, not {device}")
    t0 = time.perf_counter()
    _build.build(("probe",))
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128) - 511.5
    out = scale_by_two(x)
    torch.cuda.synchronize(device)
    if not torch.equal(out, scale_by_two_plain(x)):
        raise RuntimeError("capability probe: the kernel's 2x differs from 2 * x")
    return {
        "ok": True,
        "device_kind": torch.cuda.get_device_name(device),
        "elapsed_s": time.perf_counter() - t0,
    }


def main() -> int:
    try:
        result = run_capability_probe()
    except Exception as exc:  # the command's boundary: report, exit 1
        print(json.dumps({"ok": False, "error": f"{type(exc).__name__}: {exc}"}))
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
