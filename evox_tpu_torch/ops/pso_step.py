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
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import rng
from . import _build
from .philox import seed_operands

__all__ = ["fused_pso_move", "fused_pso_move_plain"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    (ctypes.c_int,)
    + (ctypes.c_void_p,) * 15
    + (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)
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


def fused_pso_move_plain(
    pop, velocity, local_best_location, fit, local_best_fit,
    global_best_location, lb, ub, w, phi_p, phi_g, seed,
    rand_draws=None, rand: str = "hw",
):
    """The kernel's math in plain PyTorch, operator by operator (same dtype,
    same order, same rounding).  The CPU path of :func:`fused_pso_move`, and
    the version the kernel is held against on the card."""
    n, d = pop.shape
    dtype = pop.dtype
    w, phi_p, phi_g = _scalars(w, phi_p, phi_g, pop.device).to(dtype).unbind()
    fit = fit.to(dtype)
    lbf = local_best_fit.to(dtype)
    # The fold compares in float32, like the TPU kernel.
    improved = fit.to(torch.float32) < lbf.to(torch.float32)
    new_lbl = torch.where(improved[:, None], pop, local_best_location)
    new_lbf = torch.where(improved, fit, lbf)
    if rand == "input":
        rp, rg = (r.to(dtype) for r in rand_draws)
    else:
        words = rng.philox_words(seed, n * d, pop.device)
        rp = rng.uniform_bits(words[0], dtype).reshape(n, d)
        rg = rng.uniform_bits(words[1], dtype).reshape(n, d)
    gbl = global_best_location.to(dtype)[None, :]
    vel = w * velocity + phi_p * rp * (new_lbl - pop) + phi_g * rg * (gbl - pop)
    lb = torch.broadcast_to(lb.to(dtype), (d,))[None, :]
    ub = torch.broadcast_to(ub.to(dtype), (d,))[None, :]
    new_pop = torch.minimum(torch.maximum(pop + vel, lb), ub)
    new_vel = torch.minimum(torch.maximum(vel, lb), ub)
    return new_pop, new_vel, new_lbl, new_lbf


def _check_cuda_operands(pop, velocity, local_best_location, rand_draws, rand):
    if pop.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"fused_pso_move: the CUDA kernel takes float32 or bfloat16, "
            f"got {pop.dtype}"
        )
    big = [("velocity", velocity), ("local_best_location", local_best_location)]
    if rand == "input":
        big += [("rp", rand_draws[0]), ("rg", rand_draws[1])]
    for name, t in [("pop", pop)] + big:
        if t.shape != pop.shape or t.dtype != pop.dtype or t.device != pop.device:
            raise ValueError(
                f"fused_pso_move: {name} is {t.dtype}{list(t.shape)} on "
                f"{t.device}; expected {pop.dtype}{list(pop.shape)} on {pop.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"fused_pso_move: {name} must be contiguous")


def _small(t, dtype, shape, device, name):
    """A (n,) or (d,) operand as a contiguous tensor of the working dtype on
    the population's device (cheap: these are O(N) or O(D))."""
    t = torch.as_tensor(t)
    if t.device != device:
        raise ValueError(f"fused_pso_move: {name} is on {t.device}, pop on {device}")
    return torch.broadcast_to(t.to(dtype), shape).contiguous()


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
    """
    if rand not in ("hw", "input"):
        raise ValueError(f"rand must be 'hw' or 'input', got {rand!r}")
    if rand == "input" and rand_draws is None:
        raise ValueError("rand='input' requires rand_draws=(rp, rg)")
    if pop.ndim != 2:
        raise ValueError(f"fused_pso_move: pop must be (N, D), got {list(pop.shape)}")
    n, d = pop.shape
    device = pop.device
    if device.type == "cpu":
        return fused_pso_move_plain(
            pop, velocity, local_best_location, fit, local_best_fit,
            global_best_location, lb, ub, w, phi_p, phi_g, seed,
            rand_draws=rand_draws, rand=rand,
        )
    if device.type != "cuda":
        raise ValueError(f"fused_pso_move: no kernel for device {device}")
    if n >= 2**31:
        raise ValueError(f"fused_pso_move: the kernel takes N < 2^31 rows, got {n}")

    dtype = pop.dtype
    if rand == "input":
        rand_draws = tuple(r.to(dtype) for r in rand_draws)
    _check_cuda_operands(pop, velocity, local_best_location, rand_draws, rand)
    fit = _small(fit, dtype, (n,), device, "fit")
    lbf = _small(local_best_fit, dtype, (n,), device, "local_best_fit")
    gbl = _small(global_best_location, dtype, (d,), device, "global_best_location")
    lb = _small(lb, dtype, (d,), device, "lb")
    ub = _small(ub, dtype, (d,), device, "ub")
    scal = _scalars(w, phi_p, phi_g, device)
    rp, rg = rand_draws if rand == "input" else (None, None)
    key, index, derive = seed_operands(seed, device) if rand == "hw" else (None, 0, 0)

    pop_out = torch.empty_like(pop)
    vel_out = torch.empty_like(pop)
    lbl_out = torch.empty_like(pop)
    lbf_out = torch.empty((n,), dtype=dtype, device=device)

    fn = _build.entry("pso_move", "pso_move", _ARGTYPES)
    _build.launch(
        "fused_pso_move", fn, device,
        _KERNEL_DTYPES[dtype],
        pop.data_ptr(), velocity.data_ptr(), local_best_location.data_ptr(),
        fit.data_ptr(), lbf.data_ptr(), gbl.data_ptr(),
        lb.data_ptr(), ub.data_ptr(), scal.data_ptr(),
        None if rp is None else rp.data_ptr(),
        None if rg is None else rg.data_ptr(),
        pop_out.data_ptr(), vel_out.data_ptr(), lbl_out.data_ptr(),
        lbf_out.data_ptr(),
        n, d, _build.pointer(key), index, derive, int(rand == "input"),
    )
    fused_pso_move.launches += 1
    return pop_out, vel_out, lbl_out, lbf_out


# Launches of the CUDA kernel (never bumped by the CPU path); reset it to 0
# to count the launches of one run.
fused_pso_move.launches = 0
