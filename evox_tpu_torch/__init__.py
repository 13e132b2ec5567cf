"""evox_tpu_torch: the PyTorch/CUDA port of ``evox_tpu``.

The JAX package ``evox_tpu`` is the reference; this package mirrors its
module layout and names so each module's counterpart is easy to find.  It
imports ``torch`` and never ``jax`` or ``evox_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"`` (:func:`resolve_device`).  Importing the package builds no
kernel: kernels are built on their first launch (:mod:`evox_tpu_torch.ops`).
It grafts installed plugins, the namespace packages
``evox_tpu_torch_ext.<category>``, into ``evox_tpu_torch.<category>``
(:mod:`evox_tpu_torch.autoload_ext`).
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
    "NOT_PORTED",
    "algorithms",
    "control",
    "core",
    "hpo",
    "metrics",
    "obs",
    "operators",
    "ops",
    "parallel",
    "precision",
    "problems",
    "resilience",
    "service",
    "utils",
    "vis_tools",
    "workflows",
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


# Subpackages of the JAX package that are not ported yet: reaching one from
# here raises ImportError by name.  Every subpackage is ported; the name
# stays, as the refusal's contract.
NOT_PORTED = ()

# Every subpackage, as the JAX package imports all of its own.  None builds
# a kernel when imported (kernels are built on their first launch).
from . import (  # noqa: E402
    algorithms,
    control,
    core,
    hpo,
    metrics,
    obs,
    operators,
    ops,
    parallel,
    precision,
    problems,
    resilience,
    service,
    utils,
    vis_tools,
    workflows,
)


def __getattr__(name: str):
    if name in NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.{name} is not ported yet (the JAX package's evox_tpu.{name}; ROADMAP Queue 1)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# Plugin autoload: the port's own plugins (``evox_tpu_torch_ext``), never
# the JAX package's.
try:
    from .autoload_ext import auto_load_extensions

    auto_load_extensions()
except ImportError:
    pass
