"""Fused PSO move (counterpart of ``evox_tpu/ops/pso_step.py``).

:func:`fused_pso_move` performs the whole PSO move in one pass over the
population: personal-best fold, the two U[0, 1) draws, velocity/position
update and bound clamps.  On a CUDA tensor it launches the hand-written
kernel ``csrc/pso_move.cu`` (it replaces the TPU kernel
``_pso_move_kernel``); on a CPU tensor it runs :func:`fused_pso_move_plain`,
the same math in plain PyTorch, operator by operator.  There is no other
path: a CUDA tensor reaches the kernel or the call raises.

Draw modes, as in the JAX package:

* ``rand="hw"`` — the draws are made inside the kernel by Philox4x32-10
  keyed by ``seed`` (:mod:`evox_tpu_torch.utils.rng` computes the same
  stream in PyTorch, so the plain version gives the same bits).  The
  kernel reads a :class:`~evox_tpu_torch.utils.rng.Seed`'s key from device
  memory and derives the child seed itself, so a replayed CUDA graph of a
  generation draws anew from the key the previous generation advanced;
* ``rand="input"`` — caller-supplied ``rand_draws=(rp, rg)``; the parity
  tests use it to feed both frameworks the same numbers.

The JAX wrapper's lane padding and its refusal of widths that are not
multiples of 128 are Mosaic constraints and are not carried over: the CUDA
kernel masks its own ragged edge.

Instances: :func:`fused_pso_move_batched` moves B swarms, (B, N, D), in one
launch of the same kernel, each as a solo call with its own operands and
key moves it.  Both entry points call one ``torch.library`` operator (a
solo move is an instance axis of 1) whose batching rule
(:mod:`evox_tpu_torch.utils.vmap_ops`) merges the instances of a
``torch.func.vmap`` into that axis.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build
from .philox import philox_draws_batched_plain, seed_operands

__all__ = ["fused_pso_move", "fused_pso_move_plain", "fused_pso_move_batched", "fused_pso_move_batched_plain"]

# Names of the JAX module that have another form here: reaching one raises
# ImportError naming the port's stand-in.
_STAND_INS = {
    name: "the TPU kernel's 128-lane padding has no counterpart; the CUDA kernel takes any (n, d) "
    "(its launch plan is _launch_plan)"
    for name in ("pad_dim", "supports_shape")
}


def __getattr__(name: str):
    if name in _STAND_INS:
        raise ImportError(f"evox_tpu_torch.ops.pso_step has no {name}: {_STAND_INS[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    (ctypes.c_int,)
    + (ctypes.c_void_p,) * 15
    + (ctypes.c_longlong,) * 4
    + (ctypes.c_void_p,)
    + (ctypes.c_int,) * 7
    + (ctypes.c_ulonglong, ctypes.c_int) * 2
    + (ctypes.c_void_p,)
)
# The kernel's block, and the widest vector a thread loads (bytes).
_THREADS = 256
_VECTOR_BYTES = 16


class LaunchPlan(NamedTuple):
    """How ``csrc/pso_move.cu`` covers B*N*D elements: ``vec`` elements a
    vector, ``blocks`` blocks of the grid-stride loop, 64-bit indices when
    ``wide``, and ``x // d`` and ``x // n`` as multiply-high constants
    (:func:`_div`); or, with ``rows``, a block a row of B*N, an element a
    thread."""

    vec: int
    blocks: int
    wide: bool
    rows: bool
    d_magic: int
    d_shift: int
    n_magic: int
    n_shift: int


def _divisor(d: int, bits: int) -> tuple[int, int]:
    """``(m, l)`` with ``x // d == _div(x, m, l, bits)`` for every ``0 <= x
    < 2**bits``: ``l = ceil(log2 d)``, ``m = ceil(2**(bits + l) / d)``, which
    fits in ``bits + 1`` bits.  The rounding error of ``m / 2**(bits + l)``
    is below ``2**l / (d * 2**(bits + l))``, too small to move any quotient."""
    shift = (d - 1).bit_length()
    return -(-(1 << (bits + shift)) // d), shift


def _div(x: int, magic: int, shift: int, bits: int) -> int:
    """The kernel's division: the high word of ``(2x) * magic`` in a
    (bits + 1)-bit word, shifted right by ``shift``."""
    return (((x << 1) * magic) >> (bits + 1)) >> shift


def _launch_plan(batch, n, d, dtype, ptrs, sms, blocks_per_sm, rand_input=False) -> LaunchPlan:
    """The launch of B = ``batch`` instances of (``n``, ``d``) in ``dtype``.

    The vector is the widest of 8, 4, 2, 1 elements that fits 16 bytes,
    divides ``d`` (a vector never crosses a row) and to whose bytes every
    pointer of ``ptrs`` (the operands read or written a vector at a time) is
    aligned.  Where the kernel draws, the grid is ``sms`` times
    ``blocks_per_sm(vec, wide)`` (the blocks of that route an SM holds), so
    a thread derives its instance's key once for many vectors; with
    ``rand_input`` there is no key, and the grid has a thread a vector (the
    card's block scheduler then keeps more loads in flight: PERF.md, float32
    1.01 ms against 1.08 on the H100).  Either is fewer where there are
    fewer vectors, and at most what keeps the grid-stride loop's 32-bit
    stride below 2^31.  Where :func:`_rows_layout` takes the row layout, a
    block a row.  Indices are 32-bit below 2^31 elements."""
    size = torch.tensor([], dtype=dtype).element_size()
    vec = next(v for v in (8, 4, 2, 1)
               if v * size <= _VECTOR_BYTES and d % v == 0 and all(p % (v * size) == 0 for p in ptrs))
    total = batch * n * d
    wide = total >= 2**31
    if total == 0:
        return LaunchPlan(vec, 0, wide, False, 0, 0, 0, 0)
    if _rows_layout(dtype, vec, d):
        return LaunchPlan(vec, batch * n, wide, True, 0, 0, 0, 0)
    bits = 63 if wide else 31
    vectors = total // vec
    limit = 2**31 - 1 if wide else 2**31 // (_THREADS * vec)
    blocks = min(-(-vectors // _THREADS), limit if rand_input else sms * blocks_per_sm(vec, wide))
    return LaunchPlan(vec, blocks, wide, False, *_divisor(d, bits), *_divisor(n, bits))


def _rows_layout(dtype, vec: int, d: int) -> bool:
    """Whether the kernel takes its row layout (a block a row, an element a
    thread) over vectors of ``vec``: for rows of a block's width or more
    whose vectors hold fewer than 4 float32 or 2 bfloat16 elements.  There
    a row's fitness, instance and key, read once a block, cost less than
    once a vector, and the vectors are too narrow to keep enough bytes in
    flight (PERF.md: at D = 1001 float32 0.91 ms against 1.20 on
    the H100; at D = 101, 1.68 against 1.22)."""
    return d >= _THREADS and vec < (4 if dtype == torch.float32 else 2)


@functools.cache
def _blocks_per_sm(device_index: int, dtype_code: int, vec: int, wide: bool) -> int:
    """Blocks of one in-kernel-draw route of the kernel an SM of the card
    holds."""
    fn = _build.entry("pso_move", "pso_move_blocks_per_sm", (ctypes.c_int,) * 3)
    with torch.cuda.device(device_index):
        blocks = fn(dtype_code, vec, int(wide))
    if blocks < 1:
        raise RuntimeError(f"fused_pso_move: no resident block for the route {dtype_code, vec, wide}")
    return blocks


def _scalars(w, phi_p, phi_g, device) -> torch.Tensor:
    """``(w, phi_p, phi_g)`` as a float32 (3,) tensor on ``device``.  The
    scalars are usually 0-dim Parameter leaves already on the device, so
    nothing is read back to the host; a Python number is filled in on the
    device (no host-to-device copy, which a captured CUDA graph refuses)."""

    def one(s):
        if isinstance(s, torch.Tensor):
            return s.to(device=device, dtype=torch.float32)
        return torch.full((), float(s), dtype=torch.float32, device=device)

    return torch.stack([one(s) for s in (w, phi_p, phi_g)])


def fused_pso_move_batched_plain(
    pop, velocity, local_best_location, fit, local_best_fit,
    global_best_location, lb, ub, scal, keys, index: int = 0, derive: int = 1,
    rand_draws=None,
):
    """The kernel's math in plain PyTorch, operator by operator (same dtype,
    same order, same rounding): instance ``b`` of the (B, N, D) swarm moved
    with the scalars ``scal[b]`` (float32 (B, 3): ``w, phi_p, phi_g``), the
    global best ``global_best_location[b]``, the bounds ``lb``/``ub`` ((D,)
    shared or (B, D)) and the draws of child ``index`` of ``keys[b]`` (or
    ``rand_draws`` (rp, rg) of ``pop``'s shape).  The CPU path of both
    entry points, and the version the kernel is held against on the card."""
    b, n, d = pop.shape
    dtype = pop.dtype
    w, phi_p, phi_g = (s.to(dtype)[:, None, None] for s in scal.to(torch.float32).unbind(1))
    fit = fit.to(dtype)
    lbf = local_best_fit.to(dtype)
    # The fold compares in float32, like the TPU kernel.
    improved = fit.to(torch.float32) < lbf.to(torch.float32)
    new_lbl = torch.where(improved[..., None], pop, local_best_location)
    new_lbf = torch.where(improved, fit, lbf)
    if rand_draws is not None:
        rp, rg = (r.to(dtype) for r in rand_draws)
    else:
        rp, rg = (r.reshape(b, n, d) for r in philox_draws_batched_plain(keys, index, n * d, [dtype] * 2, derive))
    gbl = global_best_location.to(dtype)[:, None, :]
    vel = w * velocity + phi_p * rp * (new_lbl - pop) + phi_g * rg * (gbl - pop)
    lb = lb.to(dtype).reshape(-1, 1, d)
    ub = ub.to(dtype).reshape(-1, 1, d)
    new_pop = torch.minimum(torch.maximum(pop + vel, lb), ub)
    new_vel = torch.minimum(torch.maximum(vel, lb), ub)
    return new_pop, new_vel, new_lbl, new_lbf


def _check_dtype(dtype) -> None:
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"fused_pso_move: the CUDA kernel takes float32 or bfloat16, got {dtype}")


def _launch(pop, vel, lbl, fit, lbf, gbl, lb, ub, scal, key, index, derive, rp, rg):
    """One launch of ``csrc/pso_move.cu`` over the ``B`` instances of the
    (B, N, D) operands (:func:`fused_pso_move_batched_plain`'s layout).
    Returns the new ``(pop, velocity, local best, local best fitness)``."""
    device = pop.device
    if device.type != "cuda":
        raise ValueError(f"fused_pso_move: no kernel for device {device}")
    dtype = pop.dtype
    _check_dtype(dtype)
    batch, n, d = pop.shape
    if batch * n >= 2**31:
        raise ValueError(f"fused_pso_move: the kernel takes batch * N < 2^31 rows, got {batch} x {n}")
    big = [("pop", pop), ("velocity", vel), ("local_best_location", lbl)]
    if rp is not None:
        big += [("rp", rp), ("rg", rg)]
    for name, t in big:
        if t.shape != pop.shape or t.dtype != dtype or t.device != device:
            raise ValueError(
                f"fused_pso_move: {name} is {t.dtype}{list(t.shape)} on {t.device}; "
                f"expected {dtype}{list(pop.shape)} on {device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_pso_move: {name} must be contiguous")
    big = [t for _, t in big]
    # The kernel indexes the small operands by instance: check their sizes.
    sizes = {"fit": (fit, batch * n), "local_best_fit": (lbf, batch * n), "scal": (scal, 3 * batch),
             "global_best_location": (gbl, batch * d), "key": (key, 2 * batch)}
    per_instance_bounds = lb.ndim == 2
    for name, t in (("lb", lb), ("ub", ub)):
        sizes[name] = (t, batch * d if per_instance_bounds else d)
    for name, (t, numel) in sizes.items():
        if t is not None and t.numel() != numel:
            raise ValueError(f"fused_pso_move: {name} has {t.numel()} elements, expected {numel}")
    small = [t.to(device=device, dtype=dtype).contiguous() for t in (fit, lbf, gbl, lb, ub)]
    scal = scal.to(device=device, dtype=torch.float32).contiguous()
    key = None if key is None else key.to(device).contiguous()
    bound_stride = d if per_instance_bounds else 0
    outs = [torch.empty_like(big[0]) for _ in range(3)] + [torch.empty_like(small[0])]
    code, rand_input = _KERNEL_DTYPES[dtype], rp is not None
    index_of = device.index if device.index is not None else torch.cuda.current_device()
    plan = _launch_plan(
        batch, n, d, dtype, [t.data_ptr() for t in big + outs[:3] + small[2:]], _build.sm_count(index_of),
        lambda vec, wide: _blocks_per_sm(index_of, code, vec, wide), rand_input,
    )
    fn = _build.entry("pso_move", "pso_move", _ARGTYPES)
    ptr = _build.pointer
    _build.launch(
        "fused_pso_move", fn, device, code,
        *(t.data_ptr() for t in big[:3]), *(t.data_ptr() for t in small[:3]),
        small[3].data_ptr(), small[4].data_ptr(), scal.data_ptr(),
        ptr(big[3] if rand_input else None), ptr(big[4] if rand_input else None),
        *(t.data_ptr() for t in outs), batch, n, d, bound_stride, ptr(key), index, derive,
        int(rand_input), plan.vec, plan.blocks, int(plan.wide), int(plan.rows), plan.d_magic, plan.d_shift,
        plan.n_magic, plan.n_shift,
    )
    return tuple(outs)


_ARGS = ("pop", "vel", "lbl", "fit", "lbf", "gbl", "lb", "ub", "scal", "key", "index", "derive", "rp", "rg", "solo")
# Operands with a leading instance axis; ``lb``/``ub`` may also be one
# shared row.
_PER_INSTANCE = ("pop", "vel", "lbl", "fit", "lbf", "gbl", "scal", "key", "rp", "rg")


def _merge_rule(info, in_dims, *args):
    """Batching rule of the operator: the vmap level's V instances of B
    each become V * B instances of one launch (a vmap of the solo entry
    point, whose B is 1, included)."""
    a = dict(zip(_ARGS, args))
    dims = dict(zip(_ARGS, in_dims))
    v = info.batch_size
    b = a["pop"].shape[1 if dims["pop"] is not None else 0]

    def merged(name, t):
        if t is None:
            return None
        d = dims[name]
        t = t.movedim(d, 0) if d is not None else t.expand(v, *t.shape)
        if t.ndim == 2 and name in ("lb", "ub"):  # a shared row batched at this level
            t = t[:, None, :].expand(v, b, t.shape[-1])
        return t.reshape(v * b, *t.shape[2:]).contiguous()

    for name in ("lb", "ub"):
        if dims[name] is None and a[name].ndim == 1:
            continue  # shared by every instance of every level
        a[name] = merged(name, a[name])
    for name in _PER_INSTANCE:
        a[name] = merged(name, a[name])
    a["solo"] = 0
    outs = _op(*(a[k] for k in _ARGS))
    return tuple(o.reshape(v, b, *o.shape[1:]) for o in outs), (0, 0, 0, 0)


@register_vmap_op(vmap_fn=_merge_rule, name="fused_pso_move")
def _op(
    pop: torch.Tensor, vel: torch.Tensor, lbl: torch.Tensor, fit: torch.Tensor, lbf: torch.Tensor,
    gbl: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor, scal: torch.Tensor, key: torch.Tensor | None,
    index: int, derive: int, rp: torch.Tensor | None, rg: torch.Tensor | None, solo: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if pop.device.type == "cpu":
        draws = None if rp is None else (rp, rg)
        return fused_pso_move_batched_plain(pop, vel, lbl, fit, lbf, gbl, lb, ub, scal, key, index, derive, draws)
    outs = _launch(pop, vel, lbl, fit, lbf, gbl, lb, ub, scal, key, index, derive, rp, rg)
    # A solo call is a launch of one instance; a vmap merges into a batch.
    if solo:
        fused_pso_move.launches += 1
        fused_pso_move.routes[str(pop.dtype).split(".")[-1]] += 1
    else:
        fused_pso_move_batched.launches += 1
    return outs


def _small(t, dtype, shape, device, name):
    """A (n,) or (d,) operand as a tensor of the working dtype and shape on
    the population's device (cheap: these are O(N) or O(D))."""
    t = torch.as_tensor(t)
    if t.device != device:
        raise ValueError(f"fused_pso_move: {name} is on {t.device}, pop on {device}")
    return torch.broadcast_to(t.to(dtype), shape)


def _solo_operands(
    pop, velocity, local_best_location, fit, local_best_fit, global_best_location,
    lb, ub, w, phi_p, phi_g, seed, rand_draws, rand,
):
    """The operands of one move in the batched layout, as one instance
    (``_ARGS`` order, without ``solo``)."""
    if rand not in ("hw", "input"):
        raise ValueError(f"rand must be 'hw' or 'input', got {rand!r}")
    if rand == "input" and rand_draws is None:
        raise ValueError("rand='input' requires rand_draws=(rp, rg)")
    if pop.ndim != 2:
        raise ValueError(f"fused_pso_move: pop must be (N, D), got {list(pop.shape)}")
    n, d = pop.shape
    device = pop.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_pso_move: no kernel for device {device}")
    dtype = pop.dtype
    fit = _small(fit, dtype, (n,), device, "fit")
    lbf = _small(local_best_fit, dtype, (n,), device, "local_best_fit")
    gbl = _small(global_best_location, dtype, (d,), device, "global_best_location")
    lb = _small(lb, dtype, (d,), device, "lb")
    ub = _small(ub, dtype, (d,), device, "ub")
    scal = _scalars(w, phi_p, phi_g, device)
    rp, rg = (r.to(dtype)[None] for r in rand_draws) if rand == "input" else (None, None)
    key, index, derive = seed_operands(seed, device) if rand == "hw" else (None, 0, 0)
    return (pop[None], velocity[None], local_best_location[None], fit[None], lbf[None], gbl[None], lb, ub,
            scal[None], None if key is None else key[None], index, derive, rp, rg)


def fused_pso_move_plain(
    pop, velocity, local_best_location, fit, local_best_fit,
    global_best_location, lb, ub, w, phi_p, phi_g, seed,
    rand_draws=None, rand: str = "hw",
):
    """:func:`fused_pso_move`'s result computed by
    :func:`fused_pso_move_batched_plain` on one instance: the version the
    kernel's solo launch is held against on the card."""
    a = _solo_operands(pop, velocity, local_best_location, fit, local_best_fit, global_best_location,
                       lb, ub, w, phi_p, phi_g, seed, rand_draws, rand)
    outs = fused_pso_move_batched_plain(*a[:12], rand_draws=None if a[12] is None else a[12:])
    return tuple(o[0] for o in outs)


def fused_pso_move(
    pop: torch.Tensor,
    velocity: torch.Tensor,
    local_best_location: torch.Tensor,
    fit: torch.Tensor,
    local_best_fit: torch.Tensor,
    global_best_location: torch.Tensor,
    lb: torch.Tensor,
    ub: torch.Tensor,
    w,
    phi_p,
    phi_g,
    seed,
    rand_draws: tuple[torch.Tensor, torch.Tensor] | None = None,
    rand: str = "hw",
):
    """One fused PSO move: personal-best fold + random draws + velocity /
    position update + bound clamps, one pass over the (N, D) arrays.

    :param pop: (N, D) positions.  ``velocity`` / ``local_best_location``
        same shape and dtype.
    :param fit: (N,) fitness of ``pop``; ``local_best_fit`` same shape.
    :param global_best_location: (D,) — fold the global best *before*
        calling.
    :param lb, ub: (D,) bounds (a scalar broadcasts).
    :param w, phi_p, phi_g: scalar hyperparameters (0-dim tensors on the
        population's device, or Python numbers).
    :param seed: for ``rand="hw"``, a :class:`~evox_tpu_torch.utils.rng.
        Seed` (child of a key tensor, derived on the device) or a 64-bit
        integer Philox key.
    :param rand_draws: ``rand="input"`` only — (rp, rg) uniforms of
        ``pop``'s shape, used instead of the in-kernel draws.
    :returns: ``(pop', velocity', local_best_location', local_best_fit')``,
        new tensors (the inputs are not modified).

    The call is the batched operator on one instance.  Under
    ``torch.func.vmap`` its rule merges the instances: one launch moves
    them all, each as a solo call with its own operands and key moves it.
    """
    a = _solo_operands(pop, velocity, local_best_location, fit, local_best_fit, global_best_location,
                       lb, ub, w, phi_p, phi_g, seed, rand_draws, rand)
    return tuple(o[0] for o in _op(*a, 1))


def fused_pso_move_batched(
    pop, velocity, local_best_location, fit, local_best_fit, global_best_location,
    lb, ub, scal, keys, index: int = 0, derive: int = 1, rand_draws=None,
):
    """The batched route: B independent PSO moves in one launch.

    :param pop, velocity, local_best_location: (B, N, D).
    :param fit, local_best_fit: (B, N).
    :param global_best_location: (B, D).
    :param lb, ub: (D,) shared by every instance, or (B, D).
    :param scal: (B, 3) float32 ``(w, phi_p, phi_g)`` of each instance.
    :param keys: (B, 2) int64 keys; instance ``b`` draws from child
        ``index`` of ``keys[b]`` (``derive`` 1) or from its seed word.
    :param rand_draws: optional (rp, rg) of ``pop``'s shape instead of the
        in-kernel draws.

    Instance ``b`` of the result equals :func:`fused_pso_move` of instance
    ``b``'s operands bit for bit.  On a CPU tensor,
    :func:`fused_pso_move_batched_plain`."""
    if pop.ndim != 3:
        raise ValueError(f"fused_pso_move_batched: pop must be (B, N, D), got {list(pop.shape)}")
    rp, rg = (None, None) if rand_draws is None else rand_draws
    if rand_draws is None and keys is None:
        raise ValueError("fused_pso_move_batched: needs keys or rand_draws")
    return _op(pop, velocity, local_best_location, fit, local_best_fit, global_best_location,
               lb, ub, scal, None if rand_draws is not None else keys, int(index), int(derive), rp, rg, 0)


# Launches of the CUDA kernel by each entry point: a solo call, and a
# batched call or a vmap of either (never bumped by the CPU path); reset
# them to 0 to count the launches of one run.  ``fused_pso_move.routes``
# splits the solo launches by the kernel's dtype route.
fused_pso_move.launches = 0
fused_pso_move_batched.launches = 0
fused_pso_move.routes = {"float32": 0, "bfloat16": 0}
