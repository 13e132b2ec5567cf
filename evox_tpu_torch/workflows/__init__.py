"""Workflow layer (counterpart of ``evox_tpu/workflows``)."""

__all__ = ["StdWorkflow", "SegmentConfig", "EvalMonitor"]

from .eval_monitor import EvalMonitor
from .std_workflow import SegmentConfig, StdWorkflow
