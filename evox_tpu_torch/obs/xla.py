"""Program and device introspection, and the roofline math (counterpart
of ``evox_tpu/obs/xla.py``), at the H100's peaks.

* :func:`device_memory_stats` / :func:`publish_device_memory_gauges` — the
  card's allocator statistics (``torch.cuda.memory_stats``: the
  ``allocated_bytes.all.current`` and ``.peak`` counters, and the card's
  total memory) under the JAX package's names, as ``evox_device_*``
  gauges.
* :func:`program_costs` / :func:`program_memory` / :func:`program_analysis`
  / :func:`publish_program_gauges` — a compiled program's cost and memory
  verdict.  A fused segment of the port is a captured CUDA graph, which
  has no cost model (nothing like XLA's ``cost_analysis``): the costs and
  the memory analysis are ``None`` and the analysis is empty, what the JAX
  package itself returns on a backend without a cost model, and the
  gauges are skipped.  An object that does offer JAX's
  ``cost_analysis()`` / ``memory_analysis()`` is read as JAX reads it.
* :func:`write_cost_analysis` — the ``cost_analysis.json`` /
  ``memory_analysis.json`` writer, for the halves that exist (none, for a
  captured graph).
* :func:`roofline` / :func:`roofline_from_cost` /
  :func:`publish_roofline_gauges` — achieved-vs-peak arithmetic with the
  JAX package's keys and rounding, against :data:`DEFAULT_HBM_PEAK_GBPS`
  and :data:`DEFAULT_FLOP_PEAK_TFLOPS` (the card's; the environment's
  ``EVOX_TPU_HBM_PEAK_GBPS`` / ``EVOX_TPU_FLOP_PEAK_TFLOPS`` override them,
  as in the JAX package).  The runner publishes no roofline for a
  captured segment: its analysis is empty.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

from .version import OBS_SCHEMA_VERSION

__all__ = [
    "DEFAULT_HBM_PEAK_GBPS",
    "DEFAULT_FLOP_PEAK_TFLOPS",
    "program_costs",
    "program_memory",
    "program_analysis",
    "write_cost_analysis",
    "device_memory_stats",
    "publish_program_gauges",
    "publish_device_memory_gauges",
    "publish_roofline_gauges",
    "roofline",
    "roofline_from_cost",
]

# The card's peaks the roofline math defaults to: NVIDIA H100 80GB HBM3
# (SXM) data sheet, 700 W: 3.35 TB/s of HBM3, 67 TFLOP/s of dense FP32 on
# the CUDA cores (the port's kernels compute in float32 there; none uses
# the tensor cores).  Override per deployment via the environment or per
# call.
DEFAULT_HBM_PEAK_GBPS = float(os.environ.get("EVOX_TPU_HBM_PEAK_GBPS", 3350.0))
DEFAULT_FLOP_PEAK_TFLOPS = float(os.environ.get("EVOX_TPU_FLOP_PEAK_TFLOPS", 67.0))

# The memory analysis's attribute names (the JAX package's
# CompiledMemoryStats fields) worth keeping; peak device memory is derived
# below.
_MEMORY_FIELDS = (
    "generated_code_size_in_bytes",
    "argument_size_in_bytes",
    "output_size_in_bytes",
    "alias_size_in_bytes",
    "temp_size_in_bytes",
)


def program_costs(compiled: Any) -> dict[str, float] | None:
    """A compiled program's cost model as a plain dict (``flops``,
    ``bytes accessed``, ...), read from its ``cost_analysis()``, or
    ``None`` where it has none: a captured CUDA graph, or any object
    without the method.  Never raises: introspection must not fail a
    run."""
    try:
        cost = compiled.cost_analysis()
    except Exception:
        return None
    if isinstance(cost, (list, tuple)):  # one dict per device
        cost = cost[0] if cost else None
    if not cost:
        return None
    return dict(cost)


def program_memory(compiled: Any) -> dict[str, float] | None:
    """A compiled program's ``memory_analysis()`` flattened to a dict, with
    ``peak_hbm_bytes`` derived as arguments + outputs + temporaries +
    generated code − aliased bytes; ``None`` where it has none (a captured
    CUDA graph).  Never raises."""
    try:
        mem = compiled.memory_analysis()
    except Exception:
        return None
    if mem is None:
        return None
    out: dict[str, float] = {}
    for name in _MEMORY_FIELDS:
        value = getattr(mem, name, None)
        if value is not None:
            try:
                out[name] = float(value)
            except (TypeError, ValueError):
                continue
    if not out:
        return None
    out["peak_hbm_bytes"] = (
        out.get("argument_size_in_bytes", 0.0)
        + out.get("output_size_in_bytes", 0.0)
        + out.get("temp_size_in_bytes", 0.0)
        + out.get("generated_code_size_in_bytes", 0.0)
        - out.get("alias_size_in_bytes", 0.0)
    )
    return out


def write_cost_analysis(
    compiled: Any,
    profile_dir: str,
    extra: Mapping[str, Any] | None = None,
) -> dict[str, float] | None:
    """Write ``cost_analysis.json`` (the raw cost dict, key-sorted, ``extra``
    keys such as ``n_steps`` first) and the schema-stamped
    ``memory_analysis.json`` into ``profile_dir``, each only when the
    program has that half; returns the cost dict (``None`` for a captured
    graph, which writes nothing).  File-system errors are swallowed, as in
    the JAX package: a profile dump must never kill the run it
    decorates."""
    cost = program_costs(compiled)
    mem = program_memory(compiled)
    if cost is None and mem is None:
        return None
    from ..utils.checkpoint import atomic_write_text

    try:
        os.makedirs(profile_dir, exist_ok=True)
        if cost is not None:
            payload = {**(dict(extra) if extra else {}), **dict(sorted(cost.items()))}
            atomic_write_text(os.path.join(profile_dir, "cost_analysis.json"), json.dumps(payload, indent=1))
        if mem is not None:
            atomic_write_text(
                os.path.join(profile_dir, "memory_analysis.json"),
                json.dumps({"schema": OBS_SCHEMA_VERSION, **mem}, indent=1),
            )
    except OSError:
        pass
    return cost


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
    """The compact whole-program summary the runner publishes per
    segment program: ``flops``, ``bytes_accessed``, ``transcendentals``
    (when the cost model reports them) and ``peak_hbm_bytes`` (when the
    memory analysis does).  ``{}`` for a captured CUDA graph, which has
    neither: callers skip gracefully."""
    out: dict[str, float] = {}
    cost = program_costs(compiled)
    if cost:
        for raw, name in (("flops", "flops"), ("bytes accessed", "bytes_accessed"), ("transcendentals", "transcendentals")):
            value = cost.get(raw)
            if value is not None:
                out[name] = float(value)
    mem = program_memory(compiled)
    if mem:
        out["peak_hbm_bytes"] = float(mem["peak_hbm_bytes"])
    return out


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


def roofline(
    *,
    flops_per_gen: float,
    bytes_per_gen: float,
    gen_per_sec: float,
    hbm_gbps: float | None = None,
    peak_tflops: float | None = None,
) -> dict[str, Any]:
    """Achieved-vs-peak roofline for one program shape at a measured
    throughput, the JAX package's definition (keys and rounding), against
    the card's peaks unless given."""
    hbm_gbps = DEFAULT_HBM_PEAK_GBPS if hbm_gbps is None else float(hbm_gbps)
    peak_tflops = DEFAULT_FLOP_PEAK_TFLOPS if peak_tflops is None else float(peak_tflops)
    gbps = bytes_per_gen * gen_per_sec / 1e9
    tflops = flops_per_gen * gen_per_sec / 1e12
    return {
        "bytes_per_gen": bytes_per_gen,
        "flops_per_gen": flops_per_gen,
        "achieved_GBps": round(gbps, 1),
        "pct_of_hbm_peak": round(100 * gbps / hbm_gbps, 1),
        "achieved_TFLOPs": round(tflops, 2),
        "pct_of_flop_peak": round(100 * tflops / peak_tflops, 1),
        "arithmetic_intensity_flops_per_byte": round(flops_per_gen / bytes_per_gen, 3) if bytes_per_gen else None,
        "bound": "memory" if bytes_per_gen and (gbps / hbm_gbps) > (tflops / peak_tflops) else "compute",
    }


def roofline_from_cost(
    cost: Mapping[str, Any],
    gen_per_sec: float,
    *,
    hbm_gbps: float | None = None,
    peak_tflops: float | None = None,
) -> dict[str, Any]:
    """:func:`roofline` over a raw ``cost_analysis.json`` dict; a whole-run
    profile's costs are divided by its generation count (``n_steps``)."""
    n_steps = cost.get("n_steps") or 1
    return roofline(
        flops_per_gen=float(cost.get("flops", 0.0)) / n_steps,
        bytes_per_gen=float(cost.get("bytes accessed", 0.0)) / n_steps,
        gen_per_sec=gen_per_sec,
        hbm_gbps=hbm_gbps,
        peak_tflops=peak_tflops,
    )


def publish_roofline_gauges(registry: Any, fn: str, result: Mapping[str, Any]) -> None:
    """Land a roofline verdict as ``evox_roofline_*{fn=...}`` gauges
    (achieved GB/s and TFLOP/s and their percents of the peaks)."""
    for key, name, help in (
        ("achieved_GBps", "evox_roofline_achieved_gbps", "Achieved HBM GB/s of the live segment program."),
        ("pct_of_hbm_peak", "evox_roofline_pct_of_hbm_peak", "Achieved HBM bandwidth as a percent of the chip peak."),
        ("achieved_TFLOPs", "evox_roofline_achieved_tflops", "Achieved TFLOP/s of the live segment program."),
        ("pct_of_flop_peak", "evox_roofline_pct_of_flop_peak", "Achieved FLOP throughput as a percent of the chip peak."),
    ):
        value = result.get(key)
        if value is not None:
            registry.gauge(name, help, fn=fn).set(float(value))
