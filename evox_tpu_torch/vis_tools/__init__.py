"""Visualization tools (counterpart of ``evox_tpu/vis_tools/``): plotly
plots (optional dependency, imported on the first call) and the ``.exv``
EvoXVision streaming format.  Both take numpy arrays or torch tensors on
any device."""

__all__ = [
    "EvoXVisionAdapter",
    "new_exv_metadata",
    "read_exv",
    "exv",
    "plot",
]

from . import exv, plot
from .exv import EvoXVisionAdapter, new_exv_metadata, read_exv
