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

import torch

from ..utils.vmap_ops import register_vmap_op
from . import _build
from .philox import philox_draws_batched_plain, seed_operands

__all__ = ["fused_pso_move", "fused_pso_move_plain", "fused_pso_move_batched", "fused_pso_move_batched_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    (ctypes.c_int,)
    + (ctypes.c_void_p,) * 15
    + (ctypes.c_longlong,) * 4
    + (ctypes.c_void_p,)
    + (ctypes.c_int,) * 3
    + (ctypes.c_void_p,)
)


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
    fn = _build.entry("pso_move", "pso_move", _ARGTYPES)
    ptr = _build.pointer
    _build.launch(
        "fused_pso_move", fn, device, _KERNEL_DTYPES[dtype],
        *(t.data_ptr() for t in big[:3]), *(t.data_ptr() for t in small[:3]),
        small[3].data_ptr(), small[4].data_ptr(), scal.data_ptr(),
        ptr(big[3] if rp is not None else None), ptr(big[4] if rp is not None else None),
        *(t.data_ptr() for t in outs), batch, n, d, bound_stride, ptr(key), index, derive,
        int(rp is not None),
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
