"""evox_tpu_torch: the PyTorch/CUDA port of ``evox_tpu``.

The JAX package ``evox_tpu`` is the reference; this package mirrors its
module layout and names so each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax`` or ``evox_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"`` (:func:`resolve_device`).  Importing the package loads no
extension and builds no kernel: kernels are built on their first launch
(:mod:`evox_tpu_torch.ops`).
"""

from __future__ import annotations

import torch

from .core import (
    Algorithm,
    Monitor,
    Mutable,
    Parameter,
    Problem,
    State,
    Workflow,
    compile,
    get_params,
    jit,
    set_params,
    use_state,
    vmap,
)

__version__ = "0.1.0"

__all__ = [
    "hpo",
    "Algorithm",
    "Monitor",
    "Mutable",
    "Parameter",
    "Problem",
    "State",
    "Workflow",
    "compile",
    "get_params",
    "jit",
    "resolve_device",
    "set_params",
    "use_state",
    "vmap",
]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card.

    Raises :class:`RuntimeError` when CUDA is asked for (explicitly or by
    default) and is not available — the port never drops to the CPU unless
    the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: evox_tpu_torch entry points run on the "
            "CUDA card by default; pass device='cpu' to run on the CPU"
        )
    return dev


# Subpackages a user reaches from the top level (the JAX package imports
# all of its own; the port's others are imported where they are used).
from . import hpo  # noqa: E402
