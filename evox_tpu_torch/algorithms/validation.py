"""Constructor-argument validation for algorithms (counterpart of
``evox_tpu/algorithms/validation.py``)."""

from __future__ import annotations

import torch

__all__ = ["validate_bounds", "bounds"]


def validate_bounds(lb, ub) -> None:
    """Validate a search-space bounds pair: both 1-D, identical shape.

    Raises :class:`ValueError` naming the offending shapes."""
    if lb.ndim != 1 or ub.ndim != 1 or lb.shape != ub.shape:
        raise ValueError(
            f"lb and ub must be 1-D arrays of identical shape, got "
            f"lb.shape={tuple(lb.shape)}, ub.shape={tuple(ub.shape)}"
        )


def bounds(lb, ub, dtype: torch.dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``lb`` and ``ub`` as validated 1-D tensors of ``dtype`` on
    ``device``."""
    lb = torch.as_tensor(lb, dtype=dtype, device=device)
    ub = torch.as_tensor(ub, dtype=dtype, device=device)
    validate_bounds(lb, ub)
    return lb, ub
