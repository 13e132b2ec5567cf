"""Factorisations of the ES family on routes that a CUDA graph can capture.

The JAX package leaves these to XLA (``jnp.linalg.eigh``, ``svd``,
``qr``, ``cholesky``, ``jax.scipy.linalg.expm``); no Pallas kernel does
this work.  A fused run of the port is one captured CUDA graph, and a
graph cannot hold a host sync.  On the H100 (torch 2.11, CUDA 12.8):

* ``torch.linalg.eigh`` and ``torch.linalg.svd`` read LAPACK's ``info``
  on the host after cuSOLVER, and cuSOLVER's ``syevd``, ``Xsyevd`` and
  unbatched ``syevj`` invalidate a capture, at n = 20 as at n = 1000;
  cuSOLVER's batched Jacobi solver ``syevjBatched`` (n <= 32) captures and
  replays with the eager bits.  So :func:`eigh` on the card takes
  ``syevjBatched`` (``csrc/linalg.cu``) for n <= :data:`BATCHED_MAX_N` and
  the port's own blocked Jacobi kernel (``csrc/eigh_jacobi.cu``,
  :func:`eigh_jacobi`) above it, eagerly and under a capture alike; no
  card path reaches ``torch.linalg.eigh``.  The Jacobi route takes an
  optional device predicate ``due``: where it is false the launch
  returns at once, so a decomposition that a step computes and then
  discards (CMA-ES between its ``decomp_per_iter`` generations) costs no
  sweep.  :func:`eigh_jacobi_plain` is the same algorithm in PyTorch.
* :func:`svd_vh` on the card takes the eigenvectors of the Gram matrix
  ``X^T X`` from :func:`eigh`; on the CPU it is ``torch.linalg.svd``.
* ``torch.linalg.qr``, ``cholesky_ex(check_errors=False)`` and
  ``solve_ex(check_errors=False)`` make no host sync and capture: they are
  used as they are.
* ``torch.linalg.matrix_exp`` reads a norm on the host (and uses other
  approximants than JAX): :func:`expm` is the port's copy of
  ``jax._src.scipy.linalg.expm`` (Padé degree chosen by ``torch.where``,
  16 masked squarings).

On the CPU every function is the plain PyTorch call.  :func:`eigh` and
:func:`eigh_batched` call one operator (:mod:`evox_tpu_torch.utils.
vmap_ops`) on a stack of matrices (one, for :func:`eigh`) whose batching
rule merges the instances' matrices of a ``torch.func.vmap`` into one
call of the card's route (one ``syevjBatched`` call, or one cooperative
launch of the Jacobi kernel).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = [
    "BATCHED_MAX_N", "MAX_SWEEPS", "eigh", "eigh_batched", "eigh_jacobi", "eigh_jacobi_plain", "svd_vh", "qr",
    "cholesky", "solve", "expm",
]

# The largest n of cuSOLVER's batched Jacobi eigensolver; above it the card
# takes the port's Jacobi kernel.
BATCHED_MAX_N = 32

# The Jacobi kernel's sweeps, by storage type (csrc/eigh_jacobi.cu says why).
MAX_SWEEPS = {torch.float32: 20, torch.float64: 32}
# Its column block width b; matrices are padded to a multiple of 2b.
_BW = 32
_TILE = 2 * _BW
# The rotation's floor, relative to eps |A|_F.
_FLOOR_REL = 1.0 / 16.0
# The kernel's threads a block, which fix the order of its sums of squares.
_THREADS = 512

_P = ctypes.c_void_p
# The C entry points' arguments, the stream last (as a pointer: an
# undeclared argument would go as a C int and lose the pointer's high bits).
_EIGH_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)
_WORKSPACE_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P)
_JACOBI_ARGTYPES = (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_double, ctypes.c_double, ctypes.c_int, _P)


@functools.cache
def _workspace_bytes(n: int, batch: int, dtype: torch.dtype, index: int) -> int:
    """cuSOLVER's workspace for ``batch`` n x n matrices, asked once (on the
    first, eager call: a fused segment's warm-up generation)."""
    fn = _build.entry("linalg", "eigh_batched_workspace", _WORKSPACE_ARGTYPES, ctypes.c_longlong)
    A = torch.empty((batch, n, n), dtype=dtype, device=f"cuda:{index}")
    w = torch.empty((batch, n), dtype=dtype, device=A.device)
    with torch.cuda.device(index):
        nbytes = fn(n, batch, int(dtype == torch.float64), A.data_ptr(), w.data_ptr())
    if nbytes < 0:
        raise RuntimeError(f"eigh: cuSOLVER refused the workspace query for n={n} ({nbytes})")
    return nbytes


def _check_square(x: torch.Tensor, what: str) -> int:
    if x.ndim != 2 or x.shape[0] != x.shape[1]:
        raise ValueError(f"{what}: expected a square matrix, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: float32 or float64 only, got {x.dtype}")
    return x.shape[0]


def _nan_unless_finite(fn, X: torch.Tensor):
    """``fn(X)``, every output all NaN where ``X`` holds a value that is not
    finite, as the JAX package's factorisations give (PyTorch's raise or
    iterate on such input): ``fn`` sees zeros instead, and no host reads
    the check."""
    finite = torch.isfinite(X).all()
    out = fn(torch.where(finite, X, 0.0))
    return tuple(torch.where(finite, o, torch.nan) for o in out)


def eigh(C: torch.Tensor, due: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigenvalues, eigenvectors)`` of the symmetric matrix ``C`` (every
    route reads its lower triangle), eigenvalues ascending, eigenvector
    ``j`` in column ``j``, as ``torch.linalg.eigh``; all NaN when ``C``
    holds a value that is not finite.  On the card, n <= 32 is one call of cuSOLVER's
    ``syevjBatched`` and larger n one cooperative launch of the Jacobi
    kernel (:func:`eigh_jacobi`), neither with a host sync.

    :param due: an optional 0-dim bool tensor.  Where it is false the
        Jacobi kernel does no sweep and the result is ``C``'s diagonal,
        sorted, with the matching columns of the identity: a caller that
        passes ``due`` keeps the result only where it is true (CMA-ES's
        decomposition cadence).  The other routes compute regardless."""
    _check_square(C, "eigh")
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"eigh: no route for device {C.device}")
    return _nan_unless_finite(lambda X: _solo(X, due), C)


def _syevj(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One cuSOLVER ``syevjBatched`` call on the card over the (B, n, n)
    stack ``C`` (n <= 32): ``(eigenvalues (B, n), eigenvectors (B, n, n))``."""
    batch, n = C.shape[0], C.shape[-1]
    device = C.device
    A = C.clone(memory_format=torch.contiguous_format)  # overwritten by the eigenvectors
    w = torch.empty((batch, n), dtype=C.dtype, device=device)
    info = torch.empty((batch,), dtype=torch.int32, device=device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    work = torch.empty((max(_workspace_bytes(n, batch, C.dtype, index), 8),), dtype=torch.uint8, device=device)
    fn = _build.entry("linalg", "eigh_batched", _EIGH_ARGTYPES)
    _build.launch("eigh", fn, device, A.data_ptr(), w.data_ptr(), work.data_ptr(), work.numel(),
                  info.data_ptr(), n, batch, int(C.dtype == torch.float64))
    # Column-major eigenvectors: the transpose of the row-major buffer, the
    # layout torch.linalg.eigh returns too.
    return w, A.mT


def _merge_rule(info, in_dims, C, due, solo):
    # The level's V stacks of B matrices become one (V * B, n, n) stack for
    # the card's route (B is 1 for a vmap of the solo entry point), with
    # their predicates beside them.
    v = info.batch_size
    C = C.movedim(in_dims[0], 0)
    b, n = C.shape[1], C.shape[-1]
    if due is not None:
        due = due.movedim(in_dims[1], 0) if in_dims[1] is not None else due.expand(v, *due.shape)
        due = due.reshape(v * b)
    w, V = _op(C.reshape(v * b, n, n), due, 0)
    return (w.reshape(v, b, n), V.reshape(v, b, n, n)), (0, 0)


@register_vmap_op(vmap_fn=_merge_rule, name="eigh")
def _op(C: torch.Tensor, due: Optional[torch.Tensor], solo: int) -> tuple[torch.Tensor, torch.Tensor]:
    if C.device.type == "cpu":
        return torch.linalg.eigh(C)
    if C.shape[-1] > BATCHED_MAX_N:
        w, V, _, _ = eigh_jacobi(C, due)
    else:
        w, V = _syevj(C)
    # A solo call is a batch of one matrix; a vmap merges into a batch.
    (eigh if solo else eigh_batched).launches += 1
    return w, V


def _solo(C: torch.Tensor, due: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    w, V = _op(C[None], None if due is None else due.reshape(1), 1)
    return w[0], V[0]


def eigh_batched(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`eigh` of each matrix of the (B, n, n) stack ``C`` (the route
    of :func:`eigh` under ``torch.func.vmap``): on the card one cuSOLVER
    ``syevjBatched`` call for n <= 32, else one cooperative launch of the
    Jacobi kernel; the plain ``torch.linalg.eigh`` of the stack on the
    CPU.  No non-finite check: :func:`eigh` makes it per matrix before the
    batch is formed."""
    if C.ndim != 3 or C.shape[1] != C.shape[2]:
        raise ValueError(f"eigh_batched: a (B, n, n) stack, got {tuple(C.shape)}")
    return _op(C, None, 0)


# -- the blocked Jacobi route (csrc/eigh_jacobi.cu) and its plain version -----


def _padded(n: int) -> int:
    return max(_TILE, -(-n // _TILE) * _TILE)


def _tol(dtype: torch.dtype, N: int) -> float:
    """off(A) <= tol |A|_F ends the sweeps."""
    return torch.finfo(dtype).eps * math.sqrt(N)


def _check_stack(C: torch.Tensor, due, what: str) -> None:
    if C.ndim != 3 or C.shape[1] != C.shape[2] or C.shape[0] == 0:
        raise ValueError(f"{what}: a (B, n, n) stack, got {tuple(C.shape)}")
    if C.dtype not in MAX_SWEEPS:
        raise TypeError(f"{what}: float32 or float64 only, got {C.dtype}")
    if due is not None and due.numel() != C.shape[0]:
        raise ValueError(f"{what}: one predicate a matrix, got {tuple(due.shape)} for {C.shape[0]}")


def _start(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweeps' starting point: the symmetric matrix of ``C``'s lower
    triangle, padded with zeros to a multiple of 64, and the identity."""
    B, n = C.shape[0], C.shape[-1]
    N = _padded(n)
    W = C.new_zeros((B, N, N))
    L = C.tril()
    W[:, :n, :n] = L + L.tril(-1).mT
    return W, torch.eye(N, dtype=C.dtype, device=C.device).expand(B, N, N).contiguous()


def _sorted(W: torch.Tensor, V: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal's first ``n`` entries ascending, and ``V``'s columns to
    match (a stable sort on the device)."""
    w, order = torch.sort(W.diagonal(dim1=-2, dim2=-1)[:, :n], dim=-1, stable=True)
    return w, V[:, :n, :n].gather(-1, order[:, None, :].expand(-1, n, -1))


@functools.cache
def _blocks_per_sm(f64: bool, index: int) -> int:
    """Blocks of the kernel that one SM of card ``index`` holds at once
    (asked once a type and card); raises when the card refuses the query
    or no block fits."""
    fn = _build.entry("eigh_jacobi", "eigh_jacobi_blocks_per_sm", (ctypes.c_int,))
    with torch.cuda.device(index):
        per_sm = fn(int(f64))
    if per_sm < 0:
        raise RuntimeError("eigh_jacobi: the card refused the occupancy query")
    if per_sm == 0:
        raise RuntimeError("eigh_jacobi: no block of the kernel fits on an SM")
    return per_sm


def _grid(batch: int, N: int, per_sm: int, sms: int) -> int:
    """The cooperative launch's blocks: every one resident (``per_sm`` on
    each of ``sms``), and no more than the largest phase's work items (a V
    tile and a tile's sums of squares of each of the (N/64)^2 tiles of
    each matrix)."""
    return min(per_sm * sms, 2 * batch * (N // _TILE) ** 2)


def eigh_jacobi(C: torch.Tensor, due: Optional[torch.Tensor] = None):
    """The blocked Jacobi eigensolver (``csrc/eigh_jacobi.cu``) over the
    symmetric (B, n, n) stack ``C`` (its lower triangles), float32 or
    float64, any n: ``(eigenvalues (B, n) ascending, eigenvectors (B, n, n)
    in columns, sweeps (B,) int32, off (B,) float64)``, where ``sweeps``
    counts the sweeps each matrix took and ``off`` is the Frobenius norm of
    its off-diagonal part at the end, both left on the device.  ``due``
    (B,) bool, optional: a matrix whose predicate is false takes no sweep
    (its result is its sorted diagonal and identity columns, 0 sweeps, off
    0).  One cooperative kernel launch on a CUDA tensor, with no host sync
    and nothing that invalidates a capture; :func:`eigh_jacobi_plain` on a
    CPU tensor.  No non-finite check (:func:`eigh` makes it)."""
    _check_stack(C, due, "eigh_jacobi")
    if C.device.type == "cpu":
        return eigh_jacobi_plain(C, due)
    if C.device.type != "cuda":
        raise ValueError(f"eigh_jacobi: no route for device {C.device}")
    B, n = C.shape[0], C.shape[-1]
    W, V = _start(C)
    N = W.shape[-1]
    f64 = C.dtype == torch.float64
    index = C.device.index if C.device.index is not None else torch.cuda.current_device()
    blocks = _grid(B, N, _blocks_per_sm(f64, index), _build.sm_count(index))
    work = _build.workspace("eigh_jacobi", "eigh_jacobi_workspace", C.device, N, B, int(f64))
    flags = torch.zeros((B, 4), dtype=torch.int32, device=C.device)  # done, sweeps, rotated, unused
    norms = torch.zeros((B, 2), dtype=torch.float64, device=C.device)  # |A|_F, off(A)
    due = None if due is None else due.to(device=C.device, dtype=torch.bool).reshape(B).contiguous()
    fn = _build.entry("eigh_jacobi", "eigh_jacobi", _JACOBI_ARGTYPES)
    _build.launch("eigh_jacobi", fn, C.device, W.data_ptr(), V.data_ptr(), work.data_ptr(), flags.data_ptr(),
                  norms.data_ptr(), _build.pointer(due), N, B, int(f64), MAX_SWEEPS[C.dtype],
                  torch.finfo(C.dtype).eps, _tol(C.dtype, N), blocks)
    eigh_jacobi.launches += 1
    w, V = _sorted(W, V, n)
    return w, V, flags[:, 1], norms[:, 1]


def _pairs(m: int, r: int) -> list[tuple[int, int]]:
    """Round ``r`` of the circle method over ``m`` (even) players: the pairs
    (lo, hi), the one at position ``i`` first to last (the kernel's
    ``pair_of``)."""
    k = m - 1
    order = [0] + [1 + (j + r) % k for j in range(k)]
    return [(min(order[i], order[m - 1 - i]), max(order[i], order[m - 1 - i])) for i in range(m // 2)]


@functools.cache
def _inner_orders(device: torch.device) -> tuple[list[torch.Tensor], torch.Tensor]:
    """For each of the 63 rounds over a 64 x 64 sub-matrix, the gather that
    takes the previous round's order of the indices (the natural one before
    the first) to the order that puts this round's 32 pairs (p, q) side by
    side; and the gather back to the natural order after the last."""
    orders = [[i for pq in _pairs(_TILE, r) for i in pq] for r in range(_TILE - 1)]
    steps, where = [], list(range(_TILE))  # where[i]: the position of index i
    for order in orders:
        steps.append(torch.tensor([where[i] for i in order], device=device))
        where = [0] * _TILE
        for pos, i in enumerate(order):
            where[i] = pos
    return steps, torch.tensor(where, device=device)


def _rotation(app, aqq, apq, eps: float, floor: float):
    """The kernel's rotation of each pair: ``(rotates, t, c, s)``; ``t = s =
    0`` and ``c = 1`` where ``|a_pq| <= max(eps sqrt|a_pp| sqrt|a_qq|,
    floor)``."""
    thr = torch.clamp(eps * torch.sqrt(app.abs()) * torch.sqrt(aqq.abs()), min=floor)
    rot = apq.abs() > thr
    theta = (aqq - app) / (2.0 * torch.where(rot, apq, 1.0))
    t = torch.copysign(1.0 / (theta.abs() + torch.sqrt(1.0 + theta * theta)), theta)
    t = torch.where(rot, t, 0.0)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return rot, t, c, t * c


def _above(S: torch.Tensor, eps: float, floor: float) -> torch.Tensor:
    """Whether any entry above the diagonal of each (64, 64) sub-matrix of
    ``S`` passes the rotation test (the kernel's test before a pair's
    solve): where none does, none of its 63 rounds rotates."""
    sd = torch.sqrt(S.diagonal(dim1=-2, dim2=-1).abs())
    thr = torch.clamp(eps * sd[:, :, None] * sd[:, None, :], min=floor)
    return (S.abs() > thr).triu(1).flatten(1).any(1)


def _inner_plain(S: torch.Tensor, eps: float, floor: float, skip: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's ``solve``: one sweep of parallel cyclic Jacobi (63
    rounds of 32 disjoint rotations) over the (P, 64, 64) float64
    sub-matrices ``S``, with the kernel's elementwise formulas; ``(J,
    rotated (P,) bool)``.  Each round works in the order of the indices
    that puts its pairs side by side.  With ``skip``, as the kernel, a
    sub-matrix with no entry above the test keeps J = I without the rounds
    (the same values)."""
    P = S.shape[0]
    J = torch.eye(_TILE, dtype=S.dtype, device=S.device).repeat(P, 1, 1)
    rotated = torch.zeros((P,), dtype=torch.bool, device=S.device)
    active = _above(S, eps, floor) if skip else torch.ones_like(rotated)
    if not bool(active.any()):
        return J, rotated
    if not bool(active.all()):
        Ja, ra = _inner_plain(S[active], eps, floor, skip=False)
        J[active], rotated[active] = Ja, ra
        return J, rotated
    steps, back = _inner_orders(S.device)
    lower = torch.arange(_BW, device=S.device)
    lower = (lower[:, None] > lower[None, :])[None, :, None, :, None]  # blocks (m, n), m > n
    for step in steps:
        S = S.index_select(1, step).index_select(2, step)
        J = J.index_select(2, step)
        L = S.view(P, _BW, 2, _BW, 2)  # L[:, m, a, n, b]: pairs m and n, a and b = 0 for p, 1 for q
        D = L.diagonal(dim1=1, dim2=3)  # (P, 2, 2, 32): each pair's 2 x 2 block
        app, aqq, apq = D[:, 0, 0], D[:, 1, 1], D[:, 0, 1]
        rot, t, c, s = _rotation(app, aqq, apq, eps, floor)
        pp, qq, off = app - t * apq, aqq + t * apq, torch.where(rot, 0.0, apq)
        # Rows p and q (S <- R^T S), then columns (S <- S R, J <- J R).
        cr, sr = c[:, :, None, None], s[:, :, None, None]
        sp, sq = L[:, :, 0], L[:, :, 1]
        L = torch.stack([cr * sp - sr * sq, sr * sp + cr * sq], dim=2)
        cc, sc = c[:, None, None, :], s[:, None, None, :]
        sp, sq = L[..., 0], L[..., 1]
        L = torch.stack([cc * sp - sc * sq, sc * sp + cc * sq], dim=-1)
        # The kernel computes the blocks above the diagonal and mirrors
        # them; a pair's own block takes its exact values (a_pq = 0).
        L = torch.where(lower, L.permute(0, 3, 4, 1, 2), L)
        E = L.diagonal(dim1=1, dim2=3)
        E[:, 0, 0], E[:, 1, 1], E[:, 0, 1], E[:, 1, 0] = pp, qq, off, off
        S = L.reshape(P, _TILE, _TILE)
        Jv = J.view(P, _TILE, _BW, 2)
        jp, jq = Jv[..., 0], Jv[..., 1]
        cj, sj = c[:, None, :], s[:, None, :]
        J = torch.stack([cj * jp - sj * jq, sj * jp + cj * jq], dim=-1).view(P, _TILE, _TILE)
        rotated |= rot.any(1)
    return J.index_select(2, back), rotated


def _products(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``X @ Y`` over the last two dimensions (broadcast over the others)
    in the kernel's order: each output summed over k = 0, 1, ... from 0
    in the storage type, one rounding a product and one a sum."""
    shape = torch.broadcast_shapes(X.shape[:-2], Y.shape[:-2]) + (X.shape[-2], Y.shape[-1])
    acc = torch.zeros(shape, dtype=X.dtype, device=X.device)
    for k in range(X.shape[-1]):
        acc = acc + X[..., :, k:k + 1] * Y[..., k:k + 1, :]
    return acc


def _norms(W: torch.Tensor) -> tuple[float, float]:
    """``(|W|_F, off(W))`` of one padded matrix in float64, in the kernel's
    order: each 64 x 64 tile (row-major) summed by ``_THREADS`` threads,
    thread t its entries t, t + _THREADS, ... from 0, then a tree over the
    threads; the tiles' sums added in row-major order on the host (Python's
    float64)."""
    N = W.shape[-1]
    P = N // _TILE
    X = W.double().view(P, _TILE, P, _TILE).transpose(1, 2).reshape(P * P, _TILE * _TILE)
    sq = X * X
    t = torch.arange(P * P, device=W.device)
    e = torch.arange(_TILE * _TILE, device=W.device)
    diagonal = ((t // P) == (t % P))[:, None] & ((e // _TILE) == (e % _TILE))[None, :]
    sums = []
    for x in (sq, torch.where(diagonal, 0.0, sq)):
        x = x.view(P * P, -1, _THREADS)
        acc = torch.zeros((P * P, _THREADS), dtype=torch.float64, device=W.device)
        for k in range(x.shape[1]):
            acc = acc + x[:, k]
        s = _THREADS // 2
        while s:
            acc = acc[:, :s] + acc[:, s:2 * s]
            s //= 2
        total = 0.0
        for v in acc[:, 0].tolist():
            total += v
        sums.append(math.sqrt(total))
    return sums[0], sums[1]


def _sweeps_plain(W: torch.Tensor, V: torch.Tensor, skip: bool = True) -> tuple[int, float]:
    """The kernel's sweeps over one padded matrix ``W`` and ``V``, in place;
    ``(sweeps, off)``.  With ``skip`` (the kernel's rule), pairs with no
    entry above the rotation test skip their solve and products with a J
    that is I are skipped; without it every pair and product is computed
    (the same values)."""
    N = W.shape[-1]
    nb, P = N // _BW, N // _TILE
    eps = torch.finfo(W.dtype).eps
    tol = _tol(W.dtype, N)
    fro, off = _norms(W)
    if off <= tol * fro:
        return 0, off
    floor = eps * fro * _FLOOR_REL
    tiles = torch.arange(P, device=W.device)
    e = torch.arange(_TILE, device=W.device)
    # The kernel's apply computes tiles (i, j), i <= j, and writes their
    # transposes into (j, i); of a tile (i, i), the entries on and above its
    # diagonal into those below.
    mirror = ((tiles[:, None] > tiles[None, :])[:, :, None, None]
              | ((tiles[:, None] == tiles[None, :])[:, :, None, None] & (e[:, None] > e[None, :])))
    for sweep in range(1, MAX_SWEEPS[W.dtype] + 1):
        rotated = False
        for r in range(nb - 1):
            idx = torch.tensor([[*range(lo * _BW, lo * _BW + _BW), *range(hi * _BW, hi * _BW + _BW)]
                                for lo, hi in _pairs(nb, r)], device=W.device)
            J, rot = _inner_plain(W[idx[:, :, None], idx[:, None, :]].double(), eps, floor, skip)
            rotated |= bool(rot.any())
            J = J.to(W.dtype)
            perm = idx.reshape(-1)
            # A[Pi, Pj] <- Ji^T (A[Pi, Pj] Jj) over the tiles (i, j, rows,
            # columns); with the skip, a product with J = I is its other
            # factor (the same values).
            X = W[perm[:, None], perm].view(P, _TILE, P, _TILE).transpose(1, 2)
            T = _products(X, J[None])
            if skip:
                T = torch.where(~rot[None, :, None, None], X, T)
            out = _products(J.mT[:, None], T)
            if skip:
                out = torch.where(~rot[:, None, None, None], T, out)
            out = torch.where(mirror, out.transpose(0, 1).transpose(2, 3), out)
            # V[:, Pj] <- V[:, Pj] Jj over the pairs (j, rows, columns).
            Y = V[:, perm].view(N, P, _TILE).transpose(0, 1)
            outv = _products(Y, J)
            if skip:
                outv = torch.where(~rot[:, None, None], Y, outv)
            W[perm[:, None], perm] = out.transpose(1, 2).reshape(N, N)
            V[:, perm] = outv.transpose(0, 1).reshape(N, N)
        _, off = _norms(W)
        if off <= tol * fro or not rotated:
            return sweep, off
    return MAX_SWEEPS[W.dtype], off


def eigh_jacobi_plain(C: torch.Tensor, due: Optional[torch.Tensor] = None):
    """:func:`eigh_jacobi`'s algorithm in PyTorch, on any device, operation
    for operation: the same padding and mirrored lower triangle,
    round-robin pairing, float64 inner solves with the same rotations,
    thresholds and skips, products summed in the kernel's order, the same
    sums of squares, stopping rule and sweep cap.  On the card (IEEE
    rounding of every multiply, add, divide and square root) it gives the
    kernel's bits; on the CPU PyTorch's vectorised float64 square root is
    not correctly rounded, so the two agree to rounding.  It reads the host
    every sweep; nothing on the main path calls it when a
    card is present."""
    _check_stack(C, due, "eigh_jacobi_plain")
    B, n = C.shape[0], C.shape[-1]
    W, V = _start(C)
    sweeps = torch.zeros((B,), dtype=torch.int32)
    off = torch.zeros((B,), dtype=torch.float64)
    for b in range(B):
        if due is None or bool(due.reshape(B)[b]):
            sweeps[b], off[b] = _sweeps_plain(W[b], V[b])
    w, V = _sorted(W, V, n)
    return w, V, sweeps.to(C.device), off.to(C.device)


# Decompositions on the card by each entry, on either route (never bumped on
# the CPU), and launches of the Jacobi kernel; reset them to 0 to
# count the decompositions of one run.
eigh.launches = 0
eigh_batched.launches = 0
eigh_jacobi.launches = 0


def svd_vh(X: torch.Tensor) -> torch.Tensor:
    """``Vh`` of the reduced SVD of the (m, n) matrix ``X``: its (min(m, n),
    n) right singular vectors as rows, by descending singular value.  On
    the CPU ``torch.linalg.svd``; on the card, at any n, the eigenvectors of
    ``X^T X`` (:func:`eigh`) in descending order, with no host sync.  Rows
    of equal (for instance zero) singular values span the same space either
    way but are not unique; the ES family consumes only projectors ``Vh^T
    Vh``.  All NaN when ``X`` holds a value that is not finite."""
    if X.ndim != 2:
        raise ValueError(f"svd_vh: expected a matrix, got {tuple(X.shape)}")
    if X.device.type == "cpu":
        return _nan_unless_finite(lambda x: (torch.linalg.svd(x, full_matrices=False).Vh,), X)[0]
    return _gram_vh(X)


def _gram_vh(X: torch.Tensor) -> torch.Tensor:
    """:func:`svd_vh`'s route on the card: the eigenvectors of ``X^T X``,
    by descending eigenvalue, as rows."""
    _, V = eigh(X.T @ X)
    return V.flip(-1).mT[: min(X.shape)]


def qr(X: torch.Tensor) -> torch.Tensor:
    """``Q`` of the reduced QR factorisation (``torch.linalg.qr``: no host
    sync, captures on the card)."""
    return torch.linalg.qr(X).Q


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, its lower triangle NaN where the
    factorisation fails (as ``jnp.linalg.cholesky``), from
    ``cholesky_ex(check_errors=False)``: no host sync."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where(info == 0, L, torch.full_like(L, torch.nan).tril())


def solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^{-1} B`` by LU (``solve_ex(check_errors=False)``: no host sync)."""
    return torch.linalg.solve_ex(A, B, check_errors=False).result


# -- the matrix exponential: jax._src.scipy.linalg.expm --------------------

_PADE = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240., 2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600., 1187353796428800., 129060195264000.,
         10559470521600., 670442572800., 33522128640., 1323241920., 40840800., 960960., 16380., 182., 1.),
}
# (maxnorm, the 1-norm thresholds between degrees, the degrees) by dtype.
_SCALING = {
    torch.float32: (3.925724783138660, (4.258730016922831e-001, 1.880152677804762e+000), (3, 5, 7)),
    torch.float64: (5.371920351148152, (1.495585217958292e-002, 2.539398330063230e-001,
                                         9.504178996162932e-001, 2.097847961257068e+000), (3, 5, 7, 9, 13)),
}


def _pade(A: torch.Tensor, powers: dict, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_pade<m>``: the odd part U and the even part V."""
    b = _PADE[m]
    ident = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    A2, A4, A6 = powers[2], powers.get(4), powers.get(6)
    if m == 3:
        return A @ (b[3] * A2 + b[1] * ident), b[2] * A2 + b[0] * ident
    if m == 5:
        return A @ (b[5] * A4 + b[3] * A2 + b[1] * ident), b[4] * A4 + b[2] * A2 + b[0] * ident
    if m == 7:
        U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
        return U, b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    if m == 9:
        A8 = powers[8]
        U = A @ (b[9] * A8 + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
        return U, b[8] * A8 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
    V = A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    return U, V


def expm(A: torch.Tensor, max_squarings: int = 16) -> torch.Tensor:
    """The matrix exponential of the square ``A`` by scaling and squaring,
    as ``jax.scipy.linalg.expm``: ``n = max(0, floor(log2(|A|_1 /
    maxnorm)))`` halvings, the Padé approximant of the degree that ``|A|_1``
    selects (3/5/7 in float32, 3-13 in float64), ``solve(Q, P)``, then
    ``n`` of ``max_squarings`` masked squarings; all NaN when ``n >
    max_squarings``.  Every degree is computed and one kept by
    ``torch.where``, so no host reads the norm."""
    _check_square(A, "expm")
    maxnorm, conds, degrees = _SCALING[A.dtype]
    A_L1 = torch.amax(torch.sum(torch.abs(A), dim=0))
    n_squarings = torch.maximum(torch.zeros_like(A_L1), torch.floor(torch.log2(A_L1 / maxnorm)))
    A = A / 2.0**n_squarings
    idx = sum((A_L1 >= c).to(torch.int32) for c in conds)
    powers = {2: A @ A}
    if max(degrees) >= 5:
        powers[4] = powers[2] @ powers[2]
    if max(degrees) >= 7:
        powers[6] = powers[4] @ powers[2]
    if max(degrees) >= 9:
        powers[8] = powers[6] @ powers[2]
    U, V = _pade(A, powers, degrees[-1])
    for i in range(len(degrees) - 2, -1, -1):
        Ui, Vi = _pade(A, powers, degrees[i])
        U, V = torch.where(idx == i, Ui, U), torch.where(idx == i, Vi, V)
    P = U + V  # p_m(A): numerator
    Q = -U + V  # q_m(A): denominator
    R = solve(Q, P)
    for i in range(max_squarings):
        R = torch.where(i < n_squarings, R @ R, R)
    return torch.where(n_squarings > max_squarings, torch.nan, R)
