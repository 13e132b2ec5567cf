"""Factorisations of the ES family on routes that a CUDA graph can capture.

The JAX package leaves these to XLA (``jnp.linalg.eigh``, ``svd``,
``qr``, ``cholesky``, ``jax.scipy.linalg.expm``); no Pallas kernel does
this work.  A fused run of the port is one captured CUDA graph, and a
graph cannot hold a host sync.  On the H100 (torch 2.11, CUDA 12.8):

* ``torch.linalg.eigh`` and ``torch.linalg.svd`` read LAPACK's ``info``
  on the host after cuSOLVER, and cuSOLVER's ``syevd``, ``Xsyevd`` and
  unbatched ``syevj`` invalidate a capture, at n = 20 as at n = 1000;
  cuSOLVER's batched Jacobi solver ``syevjBatched`` (n <= 32) captures and
  replays with the eager bits.  :func:`eigh` takes it on the card
  (``csrc/linalg.cu``) for n <= :data:`BATCHED_MAX_N`; above that it runs
  ``torch.linalg.eigh`` eagerly and raises :class:`NotImplementedError`
  under a capture.
* :func:`svd_vh` on the card takes the eigenvectors of the Gram matrix
  ``X^T X`` from :func:`eigh` (same limit); on the CPU it is
  ``torch.linalg.svd``.
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
``syevjBatched`` call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build

__all__ = ["BATCHED_MAX_N", "eigh", "eigh_batched", "svd_vh", "qr", "cholesky", "solve", "expm"]

# The largest n of cuSOLVER's batched Jacobi eigensolver.
BATCHED_MAX_N = 32

_P = ctypes.c_void_p
_EIGH_ARGTYPES = (_P, _P, _P, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int)
_WORKSPACE_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P)


def _refuse_capture(what: str, n: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(
            f"{what} of a {n} x {n} matrix cannot run inside a CUDA graph: torch.linalg reads cuSOLVER's "
            f"info on the host and cuSOLVER's syevd/Xsyevd/syevj invalidate a capture; the batched Jacobi "
            f"route covers n <= {BATCHED_MAX_N}.  Step eagerly at this size."
        )


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


def eigh(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(eigenvalues, eigenvectors)`` of the symmetric matrix ``C`` (its
    lower triangle is read), eigenvalues ascending, eigenvector ``j`` in
    column ``j``, as ``torch.linalg.eigh``; all NaN when ``C`` holds a
    value that is not finite.  On the card, n <= 32 is one call of
    cuSOLVER's ``syevjBatched`` with no host sync (``info`` stays on the
    card, unread); larger n runs ``torch.linalg.eigh`` (which reads
    ``info`` on the host) and refuses a capture."""
    n = _check_square(C, "eigh")
    device = C.device
    if device.type == "cpu":
        return _nan_unless_finite(_solo, C)
    if device.type != "cuda":
        raise ValueError(f"eigh: no route for device {device}")
    if n > BATCHED_MAX_N:
        _refuse_capture("eigh", n)
        return _nan_unless_finite(torch.linalg.eigh, C)
    return _nan_unless_finite(_solo, C)


def _jacobi(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
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


def _merge_rule(info, in_dims, C, solo):
    # The level's V stacks of B matrices become one (V * B, n, n) stack for
    # cuSOLVER (B is 1 for a vmap of the solo entry point).
    C = C.movedim(in_dims[0], 0)
    v, b, n = C.shape[:3]
    w, V = _op(C.reshape(v * b, n, n), 0)
    return (w.reshape(v, b, n), V.reshape(v, b, n, n)), (0, 0)


@register_vmap_op(vmap_fn=_merge_rule, name="eigh")
def _op(C: torch.Tensor, solo: int) -> tuple[torch.Tensor, torch.Tensor]:
    if C.device.type == "cpu":
        return torch.linalg.eigh(C)
    w, V = _jacobi(C)
    # A solo call is a batch of one matrix; a vmap merges into a batch.
    (eigh if solo else eigh_batched).launches += 1
    return w, V


def _solo(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    w, V = _op(C[None], 1)
    return w[0], V[0]


def eigh_batched(C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`eigh` of each matrix of the (B, n, n) stack ``C``, n <= 32 on
    the card, in one cuSOLVER ``syevjBatched`` call (the route of
    :func:`eigh` under ``torch.func.vmap``); the plain
    ``torch.linalg.eigh`` of the stack on the CPU.  No non-finite check:
    :func:`eigh` makes it per matrix before the batch is formed."""
    if C.ndim != 3 or C.shape[1] != C.shape[2] or C.shape[1] > BATCHED_MAX_N:
        raise ValueError(f"eigh_batched: a (B, n, n) stack with n <= {BATCHED_MAX_N}, got {tuple(C.shape)}")
    return _op(C, 0)


# Calls of the cuSOLVER route by each entry (never bumped on the CPU or
# above BATCHED_MAX_N); reset them to 0 to count the decompositions of one
# run.
eigh.launches = 0
eigh_batched.launches = 0


def svd_vh(X: torch.Tensor) -> torch.Tensor:
    """``Vh`` of the reduced SVD of the (m, n) matrix ``X``: its (min(m, n),
    n) right singular vectors as rows, by descending singular value.  On
    the CPU ``torch.linalg.svd``; on the card, for n <= 32, the
    eigenvectors of ``X^T X`` (:func:`eigh`) in descending order, with no
    host sync.  Rows of equal (for instance zero) singular values span the
    same space either way but are not unique; the ES family consumes only
    projectors ``Vh^T Vh``.  All NaN when ``X`` holds a value that is not
    finite."""
    if X.ndim != 2:
        raise ValueError(f"svd_vh: expected a matrix, got {tuple(X.shape)}")
    m, n = X.shape

    def vh(x):
        return (torch.linalg.svd(x, full_matrices=False).Vh,)

    if X.device.type == "cpu":
        return _nan_unless_finite(vh, X)[0]
    if n > BATCHED_MAX_N:
        _refuse_capture("svd", n)
        return _nan_unless_finite(vh, X)[0]
    _, V = eigh(X.T @ X)
    return V.flip(-1).mT[: min(m, n)]


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
