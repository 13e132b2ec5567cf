"""Reference-vector guided (RVEA) survivor selection (counterpart of
``evox_tpu/operators/selection/rvea_selection.py``).

For each reference vector, the associated solution with the least
angle-penalized distance (APD) survives; vectors with no associated
solution give NaN rows, so the output keeps the fixed reference-vector
count.  The (n, r) cosine table is one ``torch.matmul`` in full float32
(no TF32), clipped in place and reduced by one ``torch.max`` over its rows
(the value and the first index of the maximum in one pass); survivors come
from two scatter-mins into ``r + 1`` slots, the last one taking the rows
that belong to no vector.  ``amin`` does not depend on the order of the
scatter, so the survivors are the same on every device and every run.
"""

from __future__ import annotations

import torch

from ...utils import nanmin

__all__ = ["ref_vec_guided", "apd_fn"]


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise cosine similarity between rows of ``a`` (n, m) and ``b``
    (r, m): one (n, m) x (m, r) matrix product plus norm scaling."""
    # On the CPU, ``vector_norm`` of up to three entries has the bits of
    # ``jnp.linalg.norm``; a hand-written ``sqrt(sum(x * x))`` does not.
    a_n = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-12)
    b_n = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-12)
    return a_n @ b_n.T


def apd_fn(
    partition: torch.Tensor,
    gamma: torch.Tensor,
    angle: torch.Tensor,
    obj: torch.Tensor,
    theta: torch.Tensor,
) -> torch.Tensor:
    """Angle-penalized distance for each (solution, reference-vector) slot
    of a partition table (``-1`` marks an empty slot)."""
    m = obj.shape[1]
    selected_angle = torch.take_along_dim(angle, torch.clamp(partition, min=0), dim=0)
    left = (1 + m * theta * selected_angle) / gamma[None, :]
    norm_obj = torch.linalg.vector_norm(obj, dim=1)
    right = norm_obj[partition]
    return left * right


def _apd_terms(
    f: torch.Tensor, v: torch.Tensor, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's vector (the largest cosine, first on ties), that cosine,
    its APD ``(1 + m·theta·angle) * ||obj||`` (``inf`` for a row with a
    non-finite objective) and the non-finite mask."""
    m = f.shape[1]
    obj = f - nanmin(f, dim=0, keepdim=True)
    obj = torch.clamp(obj, min=1e-32)

    cos = _cosine_similarity(obj, v).clamp_(0.0, 1.0)
    best_cos, associate = torch.max(cos, dim=1)
    del cos
    own_angle = torch.arccos(best_cos)

    nan_mask = ~torch.isfinite(f).all(dim=1)
    vals = (1.0 + m * theta * own_angle) * torch.linalg.vector_norm(obj, dim=1)
    vals = torch.where(nan_mask, torch.full_like(vals, float("inf")), vals)
    return associate, best_cos, vals, nan_mask


def _survivor_rows(
    associate: torch.Tensor, vals: torch.Tensor, nan_mask: torch.Tensor, nv: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row of least APD of each vector (ties to the lowest row) and
    the mask of the vectors that have none."""
    n = vals.shape[0]
    # Non-finite rows go to the spare slot nv, which is dropped.
    scatter_idx = torch.where(nan_mask, nv, associate)
    best = torch.full((nv + 1,), float("inf"), dtype=vals.dtype, device=vals.device)
    best = best.scatter_reduce(0, scatter_idx, vals, "amin")[:nv]
    is_best = (vals == best[torch.where(nan_mask, 0, associate)]) & ~nan_mask
    rows = torch.arange(n, device=vals.device)
    cand = torch.where(is_best, rows, n)
    next_ind = torch.full((nv + 1,), n, dtype=cand.dtype, device=vals.device)
    next_ind = next_ind.scatter_reduce(0, scatter_idx, cand, "amin")[:nv]
    return torch.clamp(next_ind, max=n - 1), ~torch.isfinite(best)


def ref_vec_guided(
    x: torch.Tensor, f: torch.Tensor, v: torch.Tensor, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """RVEA selection: ``(next_x, next_f)`` of shape ``(r, ·)``, NaN rows
    for the reference vectors with no associated solution.

    Each solution belongs to its least-angle (largest-cosine) vector, and
    the survivor of vector ``j`` is the segment-argmin of ``(1 + m·theta·
    angle) * ||obj||`` over its solutions, ties to the lowest row.  The
    per-vector ``gamma`` divisor of the APD is a positive constant within a
    group, so it is not computed.  Rows with a non-finite objective are
    never candidates."""
    associate, _, vals, nan_mask = _apd_terms(f, v, theta)
    next_ind, mask_null = _survivor_rows(associate, vals, nan_mask, v.shape[0])
    mask_null = mask_null[:, None]
    nan = torch.full((), float("nan"), dtype=f.dtype, device=f.device)
    next_x = torch.where(mask_null, nan.to(x.dtype), x[next_ind])
    next_f = torch.where(mask_null, nan, f[next_ind])
    return next_x, next_f
