"""Run-health diagnostics (counterpart of ``evox_tpu/resilience``; only the
state scan that the fused segments and ``StdWorkflow.health_metrics`` use
is ported so far: :func:`~evox_tpu_torch.resilience.health.scan_state`)."""

from .health import scan_state

__all__ = ["scan_state"]
