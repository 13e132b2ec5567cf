"""The port's fused PSO move (``evox_tpu_torch/ops/pso_step.py``) against the
JAX package's ``fused_pso_move`` run in Pallas interpret mode with
caller-supplied draws, as ``tests/test_pso_pallas_kernel.py`` runs it.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel is held against that version on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.ops.pso_step import fused_pso_move as jax_move  # noqa: E402
from evox_tpu_torch.ops.pso_step import (  # noqa: E402
    fused_pso_move,
    fused_pso_move_plain,
)
from evox_tpu_torch.utils import rng  # noqa: E402

W, PHI_P, PHI_G = 0.6, 2.5, 0.8
NAMES = ("pop", "velocity", "local_best_location", "local_best_fit")


def _inputs(n, d, seed, nan=False):
    r = np.random.default_rng(seed)
    f = lambda *s: r.uniform(0, 1, s).astype(np.float32)  # noqa: E731
    x = dict(
        pop=f(n, d) * 8 - 4,  # beyond the bounds ±2
        vel=f(n, d) - 0.5,
        lbl=f(n, d),
        fit=f(n),
        lbf=f(n),
        gbl=f(d),
        rp=f(n, d),
        rg=f(n, d),
        lb=np.full(d, -2.0, np.float32),
        ub=np.full(d, 2.0, np.float32),
    )
    if nan:
        x["fit"][::3] = np.nan
        x["lbf"][1::4] = np.inf
        x["lbf"][2::5] = np.nan
        x["pop"][1, :2] = np.nan
        x["vel"][2, 1] = np.nan
    return x


def _jax(x, dtype):
    j = {k: jnp.asarray(v).astype(dtype) for k, v in x.items()}
    return jax_move(
        j["pop"], j["vel"], j["lbl"], j["fit"], j["lbf"], j["gbl"], j["lb"], j["ub"],
        W, PHI_P, PHI_G, seed=jnp.zeros((1,), jnp.int32),
        rand_draws=(j["rp"], j["rg"]), rand="input", interpret=True,
    )


def _torch(x, dtype, fn=fused_pso_move):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in x.items()}
    return fn(
        t["pop"], t["vel"], t["lbl"], t["fit"], t["lbf"], t["gbl"], t["lb"], t["ub"],
        W, PHI_P, PHI_G, seed=0, rand_draws=(t["rp"], t["rg"]), rand="input",
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(100, 37), (64, 128), (30, 5), (64, 384)])
def test_plain_move_matches_jax_kernel(dtype, n, d):
    x = _inputs(n, d, seed=n + d)
    want = _jax(x, getattr(jnp, dtype))
    got = _torch(x, getattr(torch, dtype))
    # The JAX test's own tolerance: a few ulps of the working dtype, since
    # XLA may fuse and contract the interpreter's arithmetic differently.
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip(NAMES, got, want):
        assert str(g.dtype).split(".")[-1] == dtype, name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), rtol=tol, atol=tol, err_msg=name
        )


def test_nan_fold_and_clip_keep_jax_semantics():
    """NaN fitness never counts as an improvement (the fold compares
    ``fit < lbf``), and a NaN position or velocity stays NaN through the
    clamps (``jnp.clip`` propagates NaN; ``fminf``/``fmaxf`` would not)."""
    x = _inputs(30, 5, seed=3, nan=True)
    want = [np.asarray(w, np.float32) for w in _jax(x, jnp.float32)]
    got = [g.numpy() for g in _torch(x, torch.float32)]
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, equal_nan=True, err_msg=name)
    improved = x["fit"] < x["lbf"]
    assert not improved[::3].any()
    np.testing.assert_array_equal(got[3][improved], x["fit"][improved])
    assert np.isnan(got[0][1, :2]).all() and np.isnan(got[1][1, :2]).all()
    finite = np.isfinite(got[0])
    assert (got[0][finite] >= -2).all() and (got[0][finite] <= 2).all()


def test_bad_rand_modes_raise():
    x = _inputs(8, 3, seed=0)
    t = [torch.from_numpy(x[k]) for k in ("pop", "vel", "lbl", "fit", "lbf", "gbl", "lb", "ub")]
    with pytest.raises(ValueError, match="rand must be"):
        fused_pso_move(*t, W, PHI_P, PHI_G, seed=0, rand="tpu")
    with pytest.raises(ValueError, match="requires rand_draws"):
        fused_pso_move(*t, W, PHI_P, PHI_G, seed=0, rand="input")
    with pytest.raises(ValueError, match="must be"):
        fused_pso_move(t[0][0], *t[1:], W, PHI_P, PHI_G, seed=0)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = _inputs(20, 6, seed=1)
    before = fused_pso_move.launches
    got = _torch(x, torch.float32)
    want = _torch(x, torch.float32, fn=fused_pso_move_plain)
    assert fused_pso_move.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hw_draws_are_the_rng_philox_stream(dtype):
    """``rand="hw"`` on the CPU draws rp/rg from the same Philox stream the
    kernel computes: with w=0, phi_p=1, phi_g=0, x=0 and lbl=1 the new
    velocity is exactly rp, the uniform of Philox word 0."""
    n, d, seed = 12, 9, 2024
    z = torch.zeros((n, d), dtype=dtype)
    inf = torch.full((n,), float("inf"), dtype=dtype)
    _, vel, lbl, lbf = fused_pso_move(
        z, z, torch.ones_like(z), inf, torch.zeros(n, dtype=dtype), torch.zeros(d, dtype=dtype),
        torch.full((d,), -10.0, dtype=dtype), torch.full((d,), 10.0, dtype=dtype),
        0.0, 1.0, 0.0, seed=seed,
    )
    assert torch.equal(vel, rng.uniform(seed, (n, d), dtype, device="cpu"))
    assert torch.equal(lbl, torch.ones_like(z)) and torch.equal(lbf, torch.zeros(n, dtype=dtype))


# ---------------------------------------------------------------------------
# The kernel's launch plan (``_launch_plan``), computed on the host.
# ---------------------------------------------------------------------------

from evox_tpu_torch.ops.pso_step import _div, _divisor, _launch_plan, _rows_layout  # noqa: E402

PLAN_DIMS = [1, 2, 3, 4, 5, 8, 37, 100, 128, 1000, 1001, 1024]
SMS, PER_SM = 132, 3


def _plan(batch, n, d, dtype, ptrs, per_sm=PER_SM):
    return _launch_plan(batch, n, d, dtype, ptrs, SMS, lambda vec, wide: per_sm)


def _widest(d, size, offset):
    """The widest vector of at most 16 bytes dividing ``d`` whose bytes
    divide the pointers' ``offset`` from an aligned base."""
    v = 16 // size
    while d % v or offset % (v * size):
        v //= 2
    return v


@pytest.mark.parametrize("base", ["aligned", "row_of_odd_d", "row_of_d_2"])
@pytest.mark.parametrize("d", PLAN_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan_vector_width(dtype, d, base):
    """16-byte vectors (4 float32, 8 bfloat16) where D and every base allow
    it, else the widest of 8, 4, 2, 1 that they allow: a vector never
    crosses a row, and a row of a buffer with odd D (or D = 2) is aligned
    only to its element (to 2 elements)."""
    size = torch.tensor([], dtype=dtype).element_size()
    n = 6
    fresh = [torch.empty((n, d), dtype=dtype) for _ in range(3)]
    ptrs = [t.data_ptr() for t in fresh]
    assert all(p % 16 == 0 for p in ptrs)
    offset = 0
    if base != "aligned":
        width = 37 if base == "row_of_odd_d" else 2
        buf = torch.empty((n * d + 1, width), dtype=dtype)
        view = buf.view(-1)[width : width + n * d].view(n, d)  # row 1 onwards of the buffer
        assert view.is_contiguous()
        offset = view.data_ptr() - buf.data_ptr()
        ptrs.append(view.data_ptr())
    plan = _plan(1, n, d, dtype, ptrs)
    assert plan.vec == _widest(d, size, offset)
    assert d % plan.vec == 0 and plan.vec * size <= 16
    if base == "aligned" and d % (16 // size) == 0:
        assert plan.vec * size == 16
    if base == "row_of_odd_d":
        assert plan.vec == 1


@pytest.mark.parametrize("batch,n,d,dtype,per_sm,blocks", [
    (1, 100_000, 1000, torch.float32, 3, SMS * 3),  # the headline: every SM full
    (1, 100_000, 1000, torch.bfloat16, 2, SMS * 2),
    (8, 1024, 100, torch.float32, 3, SMS * 3),  # 204,800 vectors of 4
    (8, 1024, 100, torch.float32, 8, 800),  # fewer vectors than the card holds
    (8, 1024, 100, torch.bfloat16, 8, 800),  # width 4 at D = 100
    (1, 30, 5, torch.float32, 3, 1),
    (16, 30, 8, torch.float32, 3, 4),  # 960 vectors of 4
    (0, 30, 8, torch.float32, 3, 0),  # nothing to launch
])
def test_launch_plan_grid(batch, n, d, dtype, per_sm, blocks):
    """The grid is the SMs times the blocks an SM holds, or one block per
    256 vectors where that is fewer."""
    plan = _plan(batch, n, d, dtype, [0], per_sm)
    assert plan.blocks == blocks
    assert not plan.wide and not plan.rows


@pytest.mark.parametrize("batch,n,d,dtype,blocks", [
    (1, 100_000, 1000, torch.float32, 97_657),  # the headline: 25,000,000 vectors of 4
    (1, 100_000, 1000, torch.bfloat16, 48_829),  # 12,500,000 vectors of 8
    (8, 1024, 100, torch.float32, 800),
    (1, 30, 5, torch.float32, 1),
    (1, 2**31 - 1, 1, torch.float32, 2**23),  # the largest 32-bit route: its stride is 2^31
    (1, 2**28 - 1, 8, torch.bfloat16, 2**20),
    (1, 2**20, 2**12, torch.float32, 2**22),  # 2^32 elements: 64-bit indices
    (0, 30, 8, torch.float32, 0),
])
def test_launch_plan_grid_of_the_input_routes(batch, n, d, dtype, blocks):
    """With the draws read from tensors there is no key to derive, and the
    grid has a thread a vector, whatever the blocks an SM holds; on the
    32-bit route its stride stays at or below 2^31, so an index plus the
    stride cannot wrap."""
    plan = _launch_plan(batch, n, d, dtype, [0], SMS, lambda vec, wide: PER_SM, rand_input=True)
    assert plan.blocks == blocks and not plan.rows
    if batch:
        assert plan.blocks * 256 * plan.vec >= batch * n * d or plan.blocks == 2**31 // (256 * plan.vec)
    if not plan.wide:
        assert plan.blocks * 256 * plan.vec <= 2**31


@pytest.mark.parametrize("d,dtype,rows", [
    (1001, torch.float32, True), (998, torch.float32, True), (1000, torch.float32, False),
    (258, torch.float32, True), (254, torch.float32, False), (101, torch.float32, False),
    (1001, torch.bfloat16, True), (998, torch.bfloat16, False), (1004, torch.bfloat16, False),
    (1000, torch.bfloat16, False), (37, torch.bfloat16, False),
])
def test_launch_plan_row_layout(d, dtype, rows):
    """Rows of a block's width or more whose vectors hold fewer than 4
    float32 or 2 bfloat16 elements take the row layout: a block a row of
    the batch, whatever the blocks an SM holds."""
    batch, n = 3, 50
    plan = _plan(batch, n, d, dtype, [0])
    assert plan.rows == rows == _rows_layout(dtype, plan.vec, d)
    if rows:
        assert plan.blocks == batch * n
    misaligned = _plan(batch, n, 1024, dtype, [0, 4])  # a base 4 bytes off
    assert misaligned.vec == (1 if dtype == torch.float32 else 2) and misaligned.rows == (dtype == torch.float32)


@pytest.mark.parametrize("batch,n,d,wide", [
    (1, 100_000, 1000, False), (8, 1024, 100, False), (1, 2**31 - 1, 1, False), (1, 1, 2**31 - 1, False),
    (2, 2**30, 1, True), (3, 2**29, 5, True), (1, 3, 2**40 + 1, True),
])
def test_launch_plan_index_width(batch, n, d, wide):
    """32-bit indices below 2^31 elements, 64-bit from there."""
    plan = _plan(batch, n, d, torch.float32, [0])
    assert plan.wide == wide == (batch * n * d >= 2**31)
    bits = 63 if wide else 31
    if plan.rows:
        assert d >= 256 and plan.vec < 4 and plan.blocks == batch * n
    else:
        assert (plan.d_magic, plan.d_shift) == _divisor(d, bits)
        assert (plan.n_magic, plan.n_shift) == _divisor(n, bits)


def _edges(divisor, count, bits):
    """0, the divisor's neighbours, multiples of it and their neighbours,
    the last of ``count`` and the largest numerator the route admits."""
    xs = {0, 1, divisor - 1, divisor, divisor + 1, count - 1, 2**bits - 1}
    for k in (2, 3, 7, 1000, (count - 1) // divisor, (2**bits - 1) // divisor):
        xs |= {k * divisor - 1, k * divisor, k * divisor + 1}
    return sorted(x for x in xs if 0 <= x < 2**bits)


@pytest.mark.parametrize("batch,n,d", [(1, 100_000, 1000), (8, 1024, 100), (3, 100, 37), (2, 64, 1000),
                                       (1, 1, 1), (3, 2**29, 5)])
def test_fast_division_is_floor_division_at_the_edges(batch, n, d):
    """The kernel's row (x // D) and instance (row // N), as multiply-high
    and shift, equal ``//`` at 0, D - 1, D, multiples of D, B·N·D - 1 and
    the largest index the route admits (2^31 - 1 on the 32-bit one); the
    constants fit the kernel's 32- or 64-bit words."""
    plan = _plan(batch, n, d, torch.float32, [0])
    assert not plan.rows
    bits = 63 if plan.wide else 31
    assert plan.d_magic < 2 ** (bits + 1) and plan.n_magic < 2 ** (bits + 1)
    for x in _edges(d, batch * n * d, bits):
        assert _div(x, plan.d_magic, plan.d_shift, bits) == x // d, x
    for row in _edges(n, batch * n, bits):
        assert _div(row, plan.n_magic, plan.n_shift, bits) == row // n, row


@pytest.mark.parametrize("divisor", [1, 2, 3, 5, 7, 37, 100, 1000, 1001, 1024, 100_000, 2**31 - 1])
def test_fast_division_on_random_numerators(divisor):
    r = np.random.default_rng(divisor)
    for bits in (31, 63):
        m, s = _divisor(divisor, bits)
        for x in r.integers(0, 2**bits, 2000, dtype=np.uint64).tolist():
            assert _div(x, m, s, bits) == x // divisor
