"""Program and device introspection the resilient runner publishes at
segment boundaries (counterpart of the runner-side half of
``evox_tpu/obs/xla.py``).

* :func:`device_memory_stats` / :func:`publish_device_memory_gauges` — the
  card's allocator statistics (``torch.cuda.memory_stats``: the
  ``allocated_bytes.all.current`` and ``.peak`` counters, and the card's
  total memory) under the JAX package's names, as ``evox_device_*``
  gauges.
* :func:`program_analysis` / :func:`publish_program_gauges` — a compiled
  program's cost and memory verdict.  A fused segment of the port is a
  captured CUDA graph, which has no cost model (nothing like XLA's
  ``cost_analysis``), so the analysis is empty: what the JAX package itself
  returns on a backend without a cost model, and the gauges are skipped.

The bench-side half of the JAX module (the peak constants,
``program_costs``, ``program_memory``, ``write_cost_analysis`` and the
roofline helpers) is not ported yet: it comes with the port's benchmark
(ROADMAP item 14), at the H100's peaks.  Reaching one of its names raises
ImportError by name (``_NOT_PORTED``).
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = [
    "device_memory_stats",
    "program_analysis",
    "publish_device_memory_gauges",
    "publish_program_gauges",
]

# The JAX module's bench-side names, not ported yet.
_NOT_PORTED = (
    "DEFAULT_HBM_PEAK_GBPS",
    "DEFAULT_FLOP_PEAK_TFLOPS",
    "program_costs",
    "program_memory",
    "write_cost_analysis",
    "roofline",
    "roofline_from_cost",
    "publish_roofline_gauges",
)


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.obs.xla.{name} is not ported yet (the bench half of evox_tpu/obs/xla.py; "
            "ROADMAP item 14, the port's benchmark)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def device_memory_stats(device: Any = None) -> dict[str, float] | None:
    """The card's allocator statistics as a numeric dict with the JAX
    package's keys: ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching
    allocator's ``allocated_bytes.all.current`` / ``.peak``) and
    ``bytes_limit`` (the card's total memory).  ``device`` is a CUDA device
    (default: the current one once CUDA is initialized).  ``None`` on the
    CPU, when CUDA is not initialized (this never initializes it), or on
    any error."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_initialized():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda" or not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats(device)
        limit = torch.cuda.get_device_properties(device).total_memory
    except Exception:
        return None
    if not stats:
        return None
    out = {}
    for key, name in (("allocated_bytes.all.current", "bytes_in_use"), ("allocated_bytes.all.peak", "peak_bytes_in_use")):
        if isinstance(stats.get(key), (int, float)):
            out[name] = float(stats[key])
    out["bytes_limit"] = float(limit)
    return out


def program_analysis(compiled: Any) -> dict[str, float]:
    """The cost/memory summary of a compiled segment program: always empty
    here.  A captured CUDA graph carries no cost model, and an empty
    analysis is exactly what the JAX package returns for a backend
    without one (its gauges are then skipped)."""
    del compiled
    return {}


def publish_program_gauges(registry: Any, fn: str, analysis: Mapping[str, float]) -> None:
    """Land one compiled program's cost/memory summary as
    ``evox_segment_*{fn=...}`` gauges (a no-op for an empty analysis,
    which is every analysis of the port)."""
    if not analysis:
        return
    gauges = (
        ("flops", "evox_segment_flops", "Modeled FLOPs per compiled segment program."),
        ("bytes_accessed", "evox_segment_bytes_accessed", "Modeled bytes accessed per compiled segment program."),
        ("transcendentals", "evox_segment_transcendentals", "Modeled transcendental ops per segment program."),
        ("peak_hbm_bytes", "evox_segment_peak_hbm_bytes", "Derived peak device-memory bytes of a segment program."),
    )
    for key, name, help in gauges:
        if key in analysis:
            registry.gauge(name, help, fn=fn).set(float(analysis[key]))


def publish_device_memory_gauges(registry: Any, device: Any = None) -> dict[str, float] | None:
    """Snapshot the card's allocator statistics into ``evox_device_*``
    gauges; returns the stats dict (``None`` on the CPU — nothing is
    published)."""
    stats = device_memory_stats(device)
    if not stats:
        return None
    for key, name, help in (
        ("bytes_in_use", "evox_device_bytes_in_use", "Live device HBM bytes in use."),
        ("peak_bytes_in_use", "evox_device_peak_bytes_in_use", "Peak device HBM bytes in use since process start."),
        ("bytes_limit", "evox_device_bytes_limit", "Device HBM capacity bytes."),
    ):
        if key in stats:
            registry.gauge(name, help).set(stats[key])
    return stats
