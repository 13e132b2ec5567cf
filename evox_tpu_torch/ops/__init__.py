"""Hand-written CUDA kernels and their plain PyTorch versions (counterpart
of ``evox_tpu/ops``), the port's own Philox draw kernel
(:mod:`evox_tpu_torch.ops.philox`), and the ES family's factorisations on
routes a CUDA graph can hold (:mod:`evox_tpu_torch.ops.linalg`).  Every
kernel entry point is a ``torch.library`` operator with a batching rule
(:mod:`evox_tpu_torch.utils.vmap_ops`).  Kernels are built on first
launch, never at import.  The capability probe is :mod:`evox_tpu_torch.ops.probe`
(also a command: ``python -m evox_tpu_torch.ops.probe``)."""

from .crowding import (
    crowding_distance_kernel,
    crowding_distance_plain,
    crowding_neighbors,
    crowding_neighbors_plain,
)
from .dominance import (
    dominance_matrix,
    dominance_matrix_plain,
    dominance_packed,
    dominance_packed_plain,
    peel_count_plain,
    peel_fronts,
    peel_fronts_plain,
)
from .philox import philox_draws, philox_draws_batched, philox_draws_batched_plain, philox_draws_plain
from .pso_step import fused_pso_move, fused_pso_move_batched, fused_pso_move_batched_plain, fused_pso_move_plain
from .topk import lex_rank, lex_rank_plain, masked_top_k, masked_top_k_plain

__all__ = [
    "crowding_distance_kernel",
    "crowding_distance_plain",
    "crowding_neighbors",
    "crowding_neighbors_plain",
    "dominance_matrix",
    "dominance_matrix_plain",
    "dominance_packed",
    "dominance_packed_plain",
    "fused_pso_move",
    "fused_pso_move_batched",
    "fused_pso_move_batched_plain",
    "fused_pso_move_plain",
    "lex_rank",
    "lex_rank_plain",
    "masked_top_k",
    "masked_top_k_plain",
    "peel_count_plain",
    "philox_draws",
    "philox_draws_batched",
    "philox_draws_batched_plain",
    "philox_draws_plain",
    "peel_fronts",
    "peel_fronts_plain",
]
