"""Hand-written CUDA kernels and their plain PyTorch versions (counterpart
of ``evox_tpu/ops``).  Kernels are built on first launch, never at import."""

from .pso_step import fused_pso_move, fused_pso_move_plain

__all__ = ["fused_pso_move", "fused_pso_move_plain"]
