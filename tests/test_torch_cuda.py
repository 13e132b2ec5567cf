"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no CUDA card.  On a machine with
one (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from evox_tpu_torch.ops.pso_step import (  # noqa: E402
    fused_pso_move,
    fused_pso_move_batched,
    fused_pso_move_batched_plain,
    fused_pso_move_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(n * 31 + d)
    u = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    fit = u(n)
    fit[::5] = float("nan")
    args = [
        (u(n, d) * 8 - 4).to(dtype), (u(n, d) - 0.5).to(dtype), u(n, d).to(dtype),
        fit.to(dtype), u(n).to(dtype), u(d).to(dtype),
        torch.full((d,), -2.0, dtype=dtype, device=device),
        torch.full((d,), 2.0, dtype=dtype, device=device),
    ]
    scal = [torch.tensor(v, dtype=dtype, device=device) for v in (0.6, 2.5, 0.8)]
    return args + scal, (u(n, d).to(dtype), u(n, d).to(dtype))


def _same_bits(got, want):
    """Equal values with equal signs (signed zeros included), NaN at the
    same places."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
        nan = torch.isnan(w)
        assert torch.equal(torch.signbit(g[~nan]), torch.signbit(w[~nan]))


# The kernel's vector widths: float32 4 (D = 128, 384, 100, 1000), 2 (D =
# 2, 6), 1 (D = 37, 5); bfloat16 8 (D = 128, 384, 1000), 4 (D = 100, 4), 2
# (D = 2, 6, 998), 1; and its row layout (float32 D = 998, 1001; bfloat16
# D = 1001).
@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(100, 37), (64, 128), (30, 5), (64, 384), (64, 1000), (64, 1001), (1024, 100),
                                 (33, 2), (17, 4), (9, 6), (40, 998)])
def test_kernel_matches_plain_version(cuda, n, d, dtype, rand):
    """Exact agreement (values equal, NaN at the same places): the kernel
    rounds like the plain version, operator by operator, without FMA."""
    args, draws = _inputs(n, d, getattr(torch, dtype), cuda)
    kw = dict(seed=77, rand=rand, rand_draws=draws if rand == "input" else None)
    before = fused_pso_move.launches
    got = fused_pso_move(*args, **kw)
    want = fused_pso_move_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fused_pso_move.launches == before + 1
    _same_bits(got, want)


@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_a_misaligned_view(cuda, dtype, rand):
    """Contiguous (N, 37) views one row into (N + 1, 37) buffers: their
    bases are not aligned to a vector, and the kernel takes width 1."""
    n, d = 100, 37
    args, draws = _inputs(n, d, getattr(torch, dtype), cuda)

    def shifted(t):
        buf = torch.empty((n + 1, d), dtype=t.dtype, device=cuda)
        buf[1:] = t
        return buf[1:]

    args[:3] = [shifted(t) for t in args[:3]]
    draws = tuple(shifted(t) for t in draws)
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 != 0
    kw = dict(seed=78, rand=rand, rand_draws=draws if rand == "input" else None)
    _same_bits(fused_pso_move(*args, **kw), fused_pso_move_plain(*args, **kw))


@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(4096, 64), (300, 1001)])
def test_kernel_matches_plain_version_on_any_bits(cuda, n, d, dtype, rand):
    """Operands of random bit patterns (subnormals, infinities, NaN,
    signed zeros, overflowing products) and local bests a few units in the
    last place from the positions (cancelling differences), on the vector
    and the row layouts: the packed bfloat16 arithmetic and the clamps give
    the plain version's bits."""
    dt = getattr(torch, dtype)
    itype, bits = (torch.int32, 32) if dt == torch.float32 else (torch.int16, 16)
    g = torch.Generator(device=cuda).manual_seed(5)

    def any_bits(*shape):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        return torch.randint(lo, hi, shape, generator=g, device=cuda, dtype=torch.int64).to(itype).view(dt)

    x = any_bits(n, d)
    near = (x.view(itype).to(torch.int64) + torch.randint(-3, 4, (n, d), generator=g, device=cuda)).to(itype).view(dt)
    l = torch.where(torch.rand((n, d), generator=g, device=cuda) < 0.5, near, any_bits(n, d))
    v = any_bits(n, d)
    v[::7] = torch.tensor([0.0, -0.0], dtype=dt, device=cuda)[torch.randint(0, 2, (d,), generator=g, device=cuda)]
    fit, lbf = any_bits(n), any_bits(n)

    def pick(*values):
        return torch.tensor(values, dtype=dt, device=cuda)[torch.randint(0, len(values), (d,), generator=g,
                                                                          device=cuda)]

    lb, ub = pick(-1.0, -0.0, 0.0, -float("inf")), pick(2.0, -0.0, 0.0, float("inf"))
    args = [x, v, l, fit, lbf, any_bits(d), lb, ub]
    draws = tuple(torch.rand((n, d), generator=g, device=cuda).to(dt) for _ in range(2))
    for w, phi_p, phi_g in ((0.6, 2.5, 0.8), (-1e30, 3e38, 1e-40)):
        kw = dict(seed=79, rand=rand, rand_draws=draws if rand == "input" else None)
        got = fused_pso_move(*args, w, phi_p, phi_g, **kw)
        want = fused_pso_move_plain(*args, w, phi_p, phi_g, **kw)
        _same_bits(got, want)


@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d", [(2, 64, 1000), (3, 50, 37), (2, 40, 1001)])
def test_kernel_64_bit_index_route_matches_plain(cuda, monkeypatch, b, n, d, dtype, rand):
    """The kernel's 64-bit index route, which the plan takes from 2^31
    elements, on small operands: the plan forced wide (its divisions by D
    and N for 63-bit numerators) on the ring, register and row routes."""
    from evox_tpu_torch.ops import pso_step

    plan = pso_step._launch_plan

    def wide(batch, n_, d_, dt, ptrs, sms, blocks_per_sm, rand_input=False):
        p = plan(batch, n_, d_, dt, ptrs, sms, lambda vec, _: blocks_per_sm(vec, True), rand_input)
        if p.rows:
            return p._replace(wide=True)
        (dm, ds), (nm, ns) = pso_step._divisor(d_, 63), pso_step._divisor(n_, 63)
        return p._replace(wide=True, d_magic=dm, d_shift=ds, n_magic=nm, n_shift=ns)

    monkeypatch.setattr(pso_step, "_launch_plan", wide)
    dt = getattr(torch, dtype)
    arrays, scal, keys, draws = _batched_move_inputs(b, n, d, dt, cuda)
    lb, ub = torch.full((d,), -2.0, dtype=dt, device=cuda), torch.full((d,), 2.0, dtype=dt, device=cuda)
    kw = dict(index=1, rand_draws=draws if rand == "input" else None)
    got = fused_pso_move_batched(*arrays, lb, ub, scal, keys, **kw)
    want = fused_pso_move_batched_plain(*arrays, lb, ub, scal, keys, **kw)
    _same_bits(got, want)


def test_kernel_refuses_what_it_does_not_take(cuda):
    args, _ = _inputs(8, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        fused_pso_move(*[a.double() for a in args], seed=0)
    bad = list(args)
    bad[1] = torch.empty(4, 8, device=cuda).t()  # (8, 4), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_pso_move(*bad, seed=0)


# ---------------------------------------------------------------------------
# The multi-objective kernels: exact agreement with their plain versions.
# ---------------------------------------------------------------------------

from evox_tpu_torch.ops import crowding, dominance, probe, topk  # noqa: E402


def _costs(n, m, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed + n * 7 + m)
    f = torch.round(torch.rand((n, m), generator=g, device=device) * 8) / 8
    if n > 8:
        f[3, 0] = float("inf")
        f[5, m - 1] = float("-inf")
        f[7] = float("nan")
    return f


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n,m", [(1, 2), (33, 3), (1000, 2), (2049, 3)])
def test_dominance_kernels_match_plain_versions(cuda, n, m):
    f = _costs(n, m, cuda)
    before = dominance.dominance_packed.launches
    words = dominance.dominance_packed(f)
    assert dominance.dominance_packed.launches == before + 1
    _same(words, dominance.dominance_packed_plain(f))
    _same(dominance.dominance_matrix(f), dominance.dominance_matrix_plain(f))
    _same(dominance.dominance_matrix(f.double()), dominance.dominance_matrix_plain(f.double()))
    _same(dominance.peel_fronts(words), dominance.peel_fronts_plain(words))
    _same(dominance.peel_fronts(words, n // 2), dominance.peel_fronts_plain(words, n // 2))


# The packed words: the kernel of fixed m (2, 3, 4) and the generic one
# (any other m), float32 and float64, sizes around the word and block edges
# (32 rows a word, 128 / 256 columns a block) and the path's 20,000.
WORD_SIZES = [1, 31, 32, 33, 255, 256, 257, 2049, 20_000]


@pytest.mark.parametrize("n", WORD_SIZES)
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dominance_packed_matches_plain_version(cuda, n, m, dtype):
    f = _costs(n, m, cuda, seed=5).to(getattr(torch, dtype))
    before = dominance.dominance_packed.launches
    words = dominance.dominance_packed(f)
    assert dominance.dominance_packed.launches == before + 1
    _same(words, dominance.dominance_packed_plain(f))


@pytest.mark.parametrize("n", [33, 2049])
@pytest.mark.parametrize("m", [2, 3, 5])
@pytest.mark.parametrize("kind", ["equal", "nan", "zeros"])
def test_dominance_packed_on_all_equal_all_nan_and_signed_zero_rows(cuda, n, m, kind):
    """All-equal rows dominate nothing, all-NaN rows nothing, and -0.0 ties
    +0.0 (a row of zeros of either sign dominates no other)."""
    if kind == "equal":
        f = torch.full((n, m), 0.375, device=cuda)
    elif kind == "nan":
        f = torch.full((n, m), float("nan"), device=cuda)
    else:
        f = torch.where(torch.rand((n, m), device=cuda) > 0.5, -0.0, 0.0)
    for g in (f, f.double()):
        words = dominance.dominance_packed(g)
        _same(words, dominance.dominance_packed_plain(g))
        assert not bool(words.any())
        _same(dominance.peel_fronts(words), torch.zeros(n, dtype=torch.int32, device=cuda))


def _dtlz_like(n, m, device, seed=0):
    """Objectives of a DTLZ2-like population: points near the unit sphere's
    positive orthant (the front) pushed outward by a random distance."""
    g = torch.Generator(device=device).manual_seed(seed + n)
    x = torch.rand((n, m), generator=g, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    return (x * (1 + torch.rand((n, 1), generator=g, device=device))).contiguous()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 200, 2049, 20_000])
@pytest.mark.parametrize("until", ["none", "one", "half", "all"])
@pytest.mark.parametrize("data", ["random", "dtlz"])
def test_peel_fronts_matches_plain_version(cuda, n, until, data):
    f = _costs(n, 3, cuda, seed=9) if data == "random" else _dtlz_like(n, 3, cuda)
    u = {"none": None, "one": 1, "half": n // 2, "all": n}[until]
    words = dominance.dominance_packed(f)
    before = dominance.peel_fronts.launches
    got = dominance.peel_fronts(words, u)
    assert dominance.peel_fronts.launches == before + 1
    _same(got, dominance.peel_fronts_plain(words, u))


@pytest.mark.parametrize("n", [20_000, 100_000])
def test_peel_fronts_makes_no_host_sync(cuda, n):
    """The whole ranking (words, then the peel) reads nothing back to the
    host, at the path's size and at 3,125 tiles (blocks own several)."""
    f = _dtlz_like(n, 3, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words = dominance.dominance_packed(f)
        rank = dominance.peel_fronts(words, n // 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(rank, dominance.peel_fronts_plain(words, n // 2))


# The radix kernels' routes (csrc/radix_sort.cuh): one thread-block cluster
# up to radix_capacity() rows (1 block at 33, 4 at 1000, 8 from 1793 on),
# many blocks beyond (131,073: 26 tiles of 5,120; 200,003: 40).
SORT_SIZES = [1, 33, 1000, 2049, 20_000, 50_000, 131_073, 200_003]
# Offsets from the crossover: the last one-block size and the first
# multi-block size.
CROSSOVER = [-1, 0, 1]


def _sort_values(n, kind, device):
    """Inputs for the sort kernels: quantized values with ±inf and NaN
    rows, all equal, all NaN, a mix of -0.0 and +0.0 (equal keys), and
    int32 ranks in 0..6 (the path's ties)."""
    if kind == "int32":
        return torch.randint(0, 7, (n,), device=device, dtype=torch.int32)
    if kind == "equal":
        return torch.full((n,), 0.25, device=device)
    if kind == "nan":
        return torch.full((n,), float("nan"), device=device)
    if kind == "zeros":
        v = torch.zeros(n, device=device)
        v[torch.rand(n, device=device) > 0.5] = -0.0
        return v
    return _costs(n, 1, device)[:, 0].contiguous()


def _check_lex_rank(v, device):
    n = v.shape[0]
    before = topk.lex_rank.launches
    _same(topk.lex_rank(v), topk.lex_rank_plain(v))
    assert topk.lex_rank.launches == before + 1
    mask = torch.rand(n, device=device) > 0.3
    for k in sorted({1, max(1, n // 2), n}):
        for got, want in zip(topk.masked_top_k(v, k, mask), topk.masked_top_k_plain(v, k, mask)):
            _same(got, want)


@pytest.mark.parametrize("n", SORT_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "int32", "equal", "nan", "zeros"])
def test_lex_rank_kernel_matches_plain_version(cuda, n, dtype):
    _check_lex_rank(_sort_values(n, dtype, cuda), cuda)


@pytest.mark.parametrize("offset", CROSSOVER)
@pytest.mark.parametrize("dtype", ["float32", "int32", "zeros"])
def test_lex_rank_kernel_at_the_route_crossover(cuda, offset, dtype):
    _check_lex_rank(_sort_values(topk.radix_capacity() + offset, dtype, cuda), cuda)


def _mask(n, kind, device):
    return {
        "all": torch.ones(n, dtype=torch.bool, device=device),
        "none": torch.zeros(n, dtype=torch.bool, device=device),
        "one": torch.arange(n, device=device) == n // 2,
        "random": torch.rand(n, device=device) > 0.3,
    }[kind]


def _check_crowding(f, mask):
    before = crowding.crowding_neighbors.launches
    for got, want in zip(crowding.crowding_neighbors(f, mask), crowding.crowding_neighbors_plain(f, mask)):
        _same(got, want)
    assert crowding.crowding_neighbors.launches == before + 1
    _same(crowding.crowding_distance_kernel(f, mask), crowding.crowding_distance_plain(f, mask))


@pytest.mark.parametrize(
    "n,m", [(1, 2), (33, 3), (1000, 2), (2049, 3), (20_000, 3), (50_000, 3), (131_073, 2), (200_003, 2)]
)
@pytest.mark.parametrize("mask_kind", ["all", "random", "one", "none"])
def test_crowding_kernel_matches_plain_versions(cuda, n, m, mask_kind):
    _check_crowding(_costs(n, m, cuda), _mask(n, mask_kind, cuda))


@pytest.mark.parametrize("offset", CROSSOVER)
@pytest.mark.parametrize("kind", ["costs", "equal", "nan", "zeros"])
def test_crowding_kernel_at_the_route_crossover(cuda, offset, kind):
    n = topk.radix_capacity() + offset
    if kind == "costs":
        f = _costs(n, 3, cuda)
    else:
        f = torch.stack([_sort_values(n, kind, cuda), _costs(n, 1, cuda)[:, 0]], 1).contiguous()
    _check_crowding(f, _mask(n, "random", cuda))


@pytest.mark.parametrize("n", [20_000, 200_003])
def test_sort_kernels_make_no_host_sync(cuda, n):
    """Neither wrapper reads anything back to the host, on either route."""
    v = _sort_values(n, "int32", cuda)
    f = _costs(n, 3, cuda)
    mask = torch.rand(n, device=cuda) > 0.3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rank = topk.lex_rank(v)
        out = crowding.crowding_neighbors(f, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(rank, topk.lex_rank_plain(v))
    _same(out[0], crowding.crowding_neighbors_plain(f, mask)[0])


def test_mo_kernels_refuse_what_they_do_not_take(cuda):
    f = _costs(64, 3, cuda)
    with pytest.raises(TypeError):
        dominance.dominance_packed(f.half())
    with pytest.raises(ValueError, match="contiguous"):
        dominance.dominance_packed(f.t().contiguous().t())
    with pytest.raises(TypeError):
        topk.lex_rank(f[:, 0].double())
    with pytest.raises(ValueError, match="contiguous"):
        topk.lex_rank(f[::2, 0])
    with pytest.raises(TypeError):
        crowding.crowding_neighbors(f.double(), torch.ones(64, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        crowding.crowding_neighbors(f, torch.ones(64, dtype=torch.bool))  # mask on the CPU
    words = dominance.dominance_packed(f)
    with pytest.raises(ValueError, match="contiguous"):
        dominance.peel_fronts(words.t().contiguous().t())
    with pytest.raises(ValueError, match="words"):
        dominance.peel_fronts(words[:, :32])  # two words for 32 columns
    with pytest.raises(ValueError, match="int32"):
        dominance.peel_fronts(words.to(torch.int64))
    with pytest.raises(TypeError):
        probe.scale_by_two(torch.ones(4, device=cuda, dtype=torch.float64))
    # 120 float32 objectives overflow a block's shared memory: the C entry
    # point refuses them.
    with pytest.raises(RuntimeError, match="launch failed"):
        dominance.dominance_packed(_costs(64, 120, cuda))


def test_capability_probe(cuda):
    before = probe.scale_by_two.launches
    result = probe.run_capability_probe()
    assert result["ok"] is True and result["device_kind"] == torch.cuda.get_device_name(0)
    assert result["elapsed_s"] > 0 and probe.scale_by_two.launches == before + 1


# ---------------------------------------------------------------------------
# The Philox draw kernel and device-resident keys
# ---------------------------------------------------------------------------

from evox_tpu_torch.ops import philox  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402

PHILOX_KINDS = [
    [torch.float32], [torch.bfloat16], [torch.float64], [torch.float16], [(0, 2)], [(-9, 2**31 - 9)],
    [torch.float32, (0, 2), torch.float32, torch.float32], [torch.bfloat16, torch.float32],
]


@pytest.mark.parametrize("numel", [1, 3, 4, 5, 1001, 65_537])
@pytest.mark.parametrize("seed", [0, 2**63, 2**64 - 1])
@pytest.mark.parametrize("counter", [0, 7, 2**40])
def test_philox_kernel_matches_plain_version(cuda, numel, seed, counter):
    k = torch.tensor([rng.signed64(seed), counter], dtype=torch.int64, device=cuda)
    for s in (rng.child(k, 0), rng.child(k, 3), seed):
        for kinds in PHILOX_KINDS:
            before = philox.philox_draws.launches
            got = philox.philox_draws(s, numel, kinds, cuda)
            assert philox.philox_draws.launches == before + 1
            for g, w in zip(got, philox.philox_draws_plain(s, numel, kinds, cuda)):
                assert g.dtype == w.dtype and g.device == w.device and torch.equal(g, w)


def test_philox_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        philox.philox_draws(1, 8, [torch.int32], cuda)
    with pytest.raises(ValueError):
        philox.philox_draws(1, 8, [torch.float32] * 5, cuda)
    with pytest.raises(ValueError):
        philox.philox_draws(rng.Seed(torch.zeros(3, dtype=torch.int64, device=cuda), 0), 8, [torch.float32], cuda)


def test_draws_and_moves_on_the_card_never_run_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(philox, "philox_draws_plain", refuse)
    monkeypatch.setattr(rng, "philox_words", refuse)
    k = rng.key(5, cuda)
    rng.uniform(rng.child(k), (10, 3), device=cuda)
    rng.randint(rng.child(k), (10,), 0, 4, cuda)
    args, _ = _inputs(8, 4, torch.float32, cuda)
    fused_pso_move(*args, seed=rng.child(k))
    torch.cuda.synchronize()


def test_randint_with_number_bounds_draws_where_the_key_lies_without_host_syncs(cuda):
    from evox_tpu_torch.utils import ops as tops

    k = rng.key(11, cuda)
    low = torch.tensor(-3, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tops.randint(k, (300, 4), -3, 40)
        by_tensor = tops.randint(k, (300, 4), low, 40)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda" and got.dtype == torch.int64 and by_tensor.device.type == "cuda"
    assert torch.equal(got, by_tensor)
    assert torch.equal(got.cpu(), tops.randint(k.cpu(), (300, 4), -3, 40))


def test_keys_and_draws_stay_on_the_card_without_host_syncs(cuda):
    k = rng.key(2**63 + 1, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k2, (a, b) = rng.split(k, 2)
        keys = rng.split_keys(k2, 4)
        u = rng.uniform(a, (100, 7), device=cuda)
        v = rng.randint(b, (50,), 0, 9, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(x.device.type == "cuda" for x in (k2, *keys, u, v))
    assert torch.equal(u.cpu(), rng.uniform(rng.Seed(k.cpu(), 0), (100, 7), device="cpu"))
    assert [c.cpu().tolist() for c in keys] == [c.tolist() for c in rng.split_keys(k2.cpu(), 4)]


# ---------------------------------------------------------------------------
# Fused segments: replayed CUDA graphs against eager steps
# ---------------------------------------------------------------------------

from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402


def _segment_workflow(kind, device, **kw):
    from evox_tpu_torch.algorithms import NSGA2, PSO
    from evox_tpu_torch.problems.numerical import DTLZ2, Ackley
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    if kind == "nsga2":
        algo = NSGA2(256, 3, torch.zeros(12), torch.ones(12), device=device)
        return StdWorkflow(algo, DTLZ2(d=12, m=3, device=device), monitor=EvalMonitor(multi_obj=True), **kw)
    algo = PSO(512, torch.full((20,), -32.0), torch.full((20,), 32.0), device=device)
    return StdWorkflow(algo, kw.pop("problem", None) or Ackley(), monitor=EvalMonitor(topk=2), **kw)


def _equal_states(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["pso", "nsga2"])
def test_segment_and_run_replay_eager_steps_bit_for_bit(cuda, kind):
    wf = _segment_workflow(kind, cuda)
    s0 = wf.step(wf.init_step(wf.init(0)))
    ref = s0
    for _ in range(12):
        ref = wf.step(ref)
    stepped = wf.monitor._history[0][-12:]
    for _ in range(2):  # the capture, then a replay
        seg, tel = wf.run_segment(s0, 12)
        _equal_states(seg, ref)
    wf.flush_telemetry(tel)
    # Entries are (generation, instance, slot, data).
    for (gx, ix, sx, x), (gy, iy, sy, y) in zip(wf.monitor._history[0][-12:], stepped):
        assert (int(gx), int(ix), sx) == (int(gy), int(iy), sy)
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    for unroll in (1, 5, 12):
        _equal_states(wf.run(s0, 12, init=False, unroll=unroll), ref)
    # The caller's state is never aliased by the graph's buffers.
    leaves = {t.data_ptr() for t in graph.flatten(seg)[0] if t.numel()}
    assert not leaves & {t.data_ptr() for b in wf._graphs.inputs.values() for t in b if t.numel()}
    # run and run_segment of the same length share one capture.
    assert len(wf._graphs) == 1


def test_capture_memory_does_not_grow_with_the_segment(cuda):
    """A capture reuses the blocks its earlier generations freed, and a
    workflow keeps at most MAX_GRAPHS captures."""
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    wf = StdWorkflow(PSO(4096, torch.full((256,), -5.0), torch.full((256,), 5.0), device=cuda), Sphere())
    s0 = wf.step(wf.init_step(wf.init(0)))
    state_bytes = sum(t.numel() * t.element_size() for t in graph.flatten(s0)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    wf.run_segment(s0, 24, metrics=False)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - before < 8 * state_bytes
    for n in range(1, graph.MAX_GRAPHS + 3):
        wf.run_segment(s0, n, metrics=False)
    assert len(wf._graphs) == graph.MAX_GRAPHS


def test_replayed_segment_makes_no_host_sync(cuda):
    wf = _segment_workflow("nsga2", cuda)
    s0 = wf.step(wf.init_step(wf.init(0)))
    wf.run_segment(s0, 6)  # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, tel = wf.run_segment(s0, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(tel.executed) == 6


class _Synchronizing(Problem):
    """Reads the population on the host while it evaluates: a capture
    cannot record that."""

    def evaluate(self, state, pop):
        return torch.sum(pop * pop, dim=1) + float(pop.sum()) * 0.0, state


def test_a_failed_capture_raises(cuda):
    wf = _segment_workflow("pso", cuda, problem=_Synchronizing())
    s0 = wf.step(wf.init_step(wf.init(0)))
    with pytest.raises(RuntimeError):
        wf.run_segment(s0, 3)


# ---------------------------------------------------------------------------
# The multi-objective family on the card
# ---------------------------------------------------------------------------


def _mo_workflow(kind, device):
    from evox_tpu_torch.algorithms import NSGA3, RVEA
    from evox_tpu_torch.problems.numerical import DTLZ2
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    cls = {"rvea": RVEA, "nsga3": NSGA3}[kind]
    algo = cls(300, 3, torch.zeros(12), torch.ones(12), device=device)
    return StdWorkflow(algo, DTLZ2(d=12, m=3, device=device), monitor=EvalMonitor(multi_obj=True))


@pytest.mark.parametrize("kind", ["rvea", "nsga3"])
def test_mo_run_replays_20_eager_steps_bit_for_bit(cuda, kind):
    wf = _mo_workflow(kind, cuda)
    s0 = wf.step(wf.init_step(wf.init(0)))
    ref = s0
    for _ in range(20):
        ref = wf.step(ref)
    _equal_states(wf.run(s0, 20, init=False), ref)
    seg, _ = wf.run_segment(s0, 20)
    _equal_states(seg, ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wf.run_segment(s0, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("shape", [1, 1000, 65_537, (990, 99)])
def test_permutation_and_bounded_draws_on_the_card_equal_their_cpu_bits(cuda, shape):
    from evox_tpu_torch.utils import rng

    key = rng.key(5)
    got = rng.permutation(rng.child(key.to(cuda)), shape, cuda)
    want = rng.permutation(rng.child(key), shape, "cpu")
    assert torch.equal(got.cpu(), want)
    n = got.numel()
    span = torch.tensor(n // 3 + 1)
    assert torch.equal(rng.randint_below(rng.child(key.to(cuda)), (n,), span.to(cuda), cuda).cpu(),
                       rng.randint_below(rng.child(key), (n,), span, "cpu"))


# ---------------------------------------------------------------------------
# CEC2022 and the DE family on the card
# ---------------------------------------------------------------------------

DE_FAMILY = ["DE", "ODE", "JaDE", "SHADE", "SaDE", "CoDE"]


def _de_workflow(name, device, pop=500, **kw):
    from evox_tpu_torch import algorithms
    from evox_tpu_torch.problems.numerical import CEC2022
    from evox_tpu_torch.workflows import StdWorkflow

    algo = getattr(algorithms, name)(pop, torch.full((20,), -100.0), torch.full((20,), 100.0), device=device, **kw)
    return StdWorkflow(algo, CEC2022(5, 20, device=device))


@pytest.mark.parametrize("name", DE_FAMILY + ["DE-best"])
def test_de_family_run_replays_20_eager_steps_bit_for_bit(cuda, name):
    kw = dict(base_vector="best", num_difference_vectors=2, differential_weight=[0.5, 0.3]) if name == "DE-best" else {}
    wf = _de_workflow(name.split("-")[0], cuda, **kw)
    s0 = wf.step(wf.init_step(wf.init(0)))
    ref = s0
    for _ in range(20):
        ref = wf.step(ref)
    _equal_states(wf.run(s0, 20, init=False), ref)
    seg, _ = wf.run_segment(s0, 20)
    _equal_states(seg, ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wf.run_segment(s0, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(ref.algorithm.fit.min()) < float(s0.algorithm.fit.min())


def test_de_steps_on_the_card_never_run_the_plain_draws(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(philox, "philox_draws_plain", refuse)
    for name in DE_FAMILY:
        wf = _de_workflow(name, cuda, pop=64)
        wf.step(wf.init_step(wf.init(1)))
    torch.cuda.synchronize()


def _cec_pairs():
    return [(fn, d) for d in (2, 10, 20) for fn in range(1, 13) if not (fn in (6, 7, 8) and d == 2)]


@pytest.mark.parametrize("fn,d", _cec_pairs())
def test_cec2022_on_the_card_matches_the_cpu_and_the_oracle(cuda, fn, d):
    import json
    import os

    from evox_tpu_torch.problems.numerical import CEC2022

    with open(os.path.join(os.path.dirname(__file__), "cec2022_golden.json")) as f:
        data = json.load(f)
    x64 = torch.tensor(data["inputs"][str(d)], dtype=torch.float64, device=cuda)
    got64, _ = CEC2022(fn, d, dtype=torch.float64, device=cuda).evaluate(None, x64)
    torch.testing.assert_close(got64.cpu(), torch.tensor(data["golden"][f"{fn}_{d}"], dtype=torch.float64),
                               rtol=1e-8, atol=0)
    g = torch.Generator(device=cuda).manual_seed(fn * 100 + d)
    on_card = CEC2022(fn, d, device=cuda)
    x = torch.cat([torch.rand((2000, d), generator=g, device=cuda) * 200 - 100,
                   on_card.shift.reshape(-1, d)])
    got, _ = on_card.evaluate(None, x)
    want, _ = CEC2022(fn, d, device="cpu").evaluate(None, x.cpu())
    # The CEC2022 float32 tolerance of tests/test_torch_cec2022.py.
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=0)


def test_normal_and_categorical_draws_on_the_card_match_the_cpu(cuda):
    from evox_tpu_torch.utils import rng

    key = rng.key(11)
    got = rng.normal(rng.child(key.to(cuda)), (100_000,), device=cuda).cpu()
    want = rng.normal(rng.child(key), (100_000,), device="cpu")
    # The same uniforms; the two devices' erfinv differ in the last places.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    logits = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    c_card = rng.categorical(rng.child(key.to(cuda), 1), logits.to(cuda), (50_000,), cuda).cpu()
    c_cpu = rng.categorical(rng.child(key, 1), logits, (50_000,), "cpu")
    assert int((c_card != c_cpu).sum()) <= 2


# ---------------------------------------------------------------------------
# The ES family and its factorisations on the card
# ---------------------------------------------------------------------------

ES_FAMILY = ["CMAES", "OpenES", "XNES", "SeparableNES", "SNES", "DES", "ARS", "ASEBO", "GuidedES",
             "PersistentES", "NoiseReuseES", "ESMC"]


def _es_algo(name, device, d=20, pop=256):
    from evox_tpu_torch import algorithms

    c = torch.zeros(d) + 1.0
    if name == "CMAES":
        return algorithms.CMAES(c, 5.0, pop_size=64, device=device)
    if name == "OpenES":
        return algorithms.OpenES(pop, c, 0.05, 1.0, optimizer="adam", device=device)
    if name == "XNES":
        return algorithms.XNES(c, torch.eye(d), pop_size=64, device=device)
    if name == "SeparableNES":
        return algorithms.SeparableNES(c, torch.ones(d), pop_size=64, device=device)
    if name == "ESMC":
        return algorithms.ESMC(pop + 1, c, device=device)
    return getattr(algorithms, name)(pop, c, device=device)


@pytest.mark.parametrize("name", ES_FAMILY)
def test_es_family_run_replays_20_eager_steps_bit_for_bit(cuda, name):
    from evox_tpu_torch.problems.numerical import CEC2022
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    wf = StdWorkflow(_es_algo(name, cuda), CEC2022(1, 20, device=cuda), monitor=EvalMonitor(full_pop_history=True))
    s0 = wf.step(wf.init_step(wf.init(0)))
    ref = s0
    for _ in range(20):
        ref = wf.step(ref)
    _equal_states(wf.run(s0, 20, init=False), ref)
    seg, _ = wf.run_segment(s0, 20)
    _equal_states(seg, ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wf.run_segment(s0, 20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(wf.monitor.get_best_fitness(ref.monitor)) < float(s0.algorithm.fit.min()) or name == "ESMC"


def test_es_steps_on_the_card_never_run_the_plain_draws(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(philox, "philox_draws_plain", refuse)
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    for name in ES_FAMILY:
        wf = StdWorkflow(_es_algo(name, cuda, pop=16), Sphere())
        wf.step(wf.init_step(wf.init(1)))
    torch.cuda.synchronize()


def _spd64(n, seed):
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    return (q * torch.logspace(0, 3, n, dtype=torch.float64)) @ q.T


@pytest.mark.parametrize("n", [1, 2, 8, 20, 32])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_card_eigh_matches_a_float64_cpu_eigh(cuda, n, dtype):
    from evox_tpu_torch.ops import linalg

    C64 = _spd64(n, n)
    C = C64.to(getattr(torch, dtype))
    before = linalg.eigh.launches
    w, v = linalg.eigh(C.to(cuda))
    assert linalg.eigh.launches == before + 1
    w64 = torch.linalg.eigvalsh(C.double())
    tol = 1e-5 if dtype == "float32" else 1e-12
    assert float((w.cpu().double() - w64).abs().max() / w64.abs().max()) <= tol
    V = v.cpu().double()
    assert float(((V * w.cpu().double()) @ V.T - C.double()).norm() / C.double().norm()) <= tol
    assert float((V.T @ V - torch.eye(n, dtype=torch.float64)).abs().max()) <= tol


def test_card_eigh_captures_without_a_host_sync_and_replays_its_bits(cuda):
    from evox_tpu_torch.ops import linalg

    C = _spd64(20, 3).float().to(cuda)
    w, v = linalg.eigh(C)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w2, v2 = linalg.eigh(C)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        wg, vg = linalg.eigh(C)
    g.replay()
    torch.cuda.synchronize()
    for a, b in ((w, w2), (v, v2), (w, wg), (v, vg)):
        assert torch.equal(a, b)
    nan = C.clone()
    nan[3, 4] = float("nan")
    assert bool(torch.isnan(linalg.eigh(nan)[1]).all())


@pytest.mark.parametrize("n", [33, 1000])
def test_card_eigh_beyond_the_batched_route_is_eager_only(cuda, n):
    from evox_tpu_torch.ops import linalg

    C = _spd64(n, n).float().to(cuda)
    w, _ = linalg.eigh(C)
    assert float((w.cpu().double() - torch.linalg.eigvalsh(C.cpu().double())).abs().max()) <= 1e-5 * 1e3
    g = torch.cuda.CUDAGraph()
    with pytest.raises(NotImplementedError, match="cannot run inside a CUDA graph"):
        with torch.cuda.graph(g):
            linalg.eigh(C)


def test_cmaes_run_beyond_the_batched_route_raises(cuda):
    from evox_tpu_torch.algorithms import CMAES
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    wf = StdWorkflow(CMAES(torch.zeros(40), 1.0, device=cuda), Sphere())
    s = wf.step(wf.init_step(wf.init(0)))
    with pytest.raises(NotImplementedError):
        wf.run(s, 4, init=False)


@pytest.mark.parametrize("m,n,k", [(20, 20, 5), (8, 20, 3), (20, 8, 8)])
def test_card_svd_projectors_match_the_cpu(cuda, m, n, k):
    from evox_tpu_torch.ops import linalg

    g = torch.Generator().manual_seed(m * n)
    U, _ = torch.linalg.qr(torch.randn(m, m, generator=g, dtype=torch.float64))
    V, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    s = torch.logspace(1, -0.3, min(m, n), dtype=torch.float64)
    X = ((U[:, : len(s)] * s) @ V[:, : len(s)].T).float()
    vt = linalg.svd_vh(X.to(cuda)).cpu().double()
    want = torch.linalg.svd(X.double(), full_matrices=False).Vh
    assert vt.shape == want.shape
    P, Pw = vt[:k].T @ vt[:k], want[:k].T @ want[:k]
    assert float((P - Pw).abs().max()) <= 1e-4


@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0])
def test_card_expm_matches_the_cpu_and_captures(cuda, scale):
    from evox_tpu_torch.ops import linalg

    A = torch.randn(20, 20, generator=torch.Generator().manual_seed(int(scale * 10))) * scale / 20
    want = linalg.expm(A.double()).float()
    Ac = A.to(cuda)
    got = linalg.expm(Ac)
    assert float((got.cpu() - want).abs().max() / want.abs().max()) <= 1e-5
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cap = linalg.expm(Ac)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap, got)


# ---------------------------------------------------------------------------
# Batched routes: vmapped instances in one launch
# ---------------------------------------------------------------------------


def _batched_move_inputs(b, n, d, dtype, device):
    g = torch.Generator(device=device).manual_seed(b * 131 + n)
    u = lambda *s: torch.rand(s, generator=g, device=device)  # noqa: E731
    fit = u(b, n)
    fit[:, ::5] = float("nan")
    arrays = [(u(b, n, d) * 8 - 4).to(dtype), (u(b, n, d) - 0.5).to(dtype), u(b, n, d).to(dtype),
              fit.to(dtype), u(b, n).to(dtype), u(b, d).to(dtype)]
    scal = torch.stack([u(b) * 0.9, u(b) * 2.5, u(b)], 1)
    keys = torch.stack([torch.tensor([rng.signed64(s * 0x9E3779B97F4A7C15 + 1), 3 * s], device=device)
                        for s in range(b)])
    return arrays, scal, keys, (u(b, n, d).to(dtype), u(b, n, d).to(dtype))


@pytest.mark.parametrize("rand", ["hw", "input"])
@pytest.mark.parametrize("per_instance_bounds", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,d", [(1, 30, 5), (3, 100, 37), (8, 1024, 100), (2, 64, 1000), (3, 33, 1001)])
def test_batched_pso_move_kernel_matches_plain_and_solo_launches(cuda, b, n, d, dtype, per_instance_bounds, rand):
    """One batched launch equals the plain batched version and B solo
    launches, 0 ulp, NaN at the same places."""
    dt = getattr(torch, dtype)
    arrays, scal, keys, draws = _batched_move_inputs(b, n, d, dt, cuda)
    if per_instance_bounds:
        lb = (-torch.rand(b, d, device=cuda) - 1).to(dt)
        ub = (torch.rand(b, d, device=cuda) + 1).to(dt)
    else:
        lb, ub = torch.full((d,), -2.0, dtype=dt, device=cuda), torch.full((d,), 2.0, dtype=dt, device=cuda)
    kw = dict(index=2, rand_draws=draws if rand == "input" else None)
    before = fused_pso_move_batched.launches
    got = fused_pso_move_batched(*arrays, lb, ub, scal, keys, **kw)
    assert fused_pso_move_batched.launches == before + 1
    want = fused_pso_move_batched_plain(*arrays, lb, ub, scal, keys, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    for i in range(b):
        solo = fused_pso_move(
            *(a[i] for a in arrays), lb[i] if per_instance_bounds else lb, ub[i] if per_instance_bounds else ub,
            *scal[i], seed=rng.Seed(keys[i], 2), rand=rand,
            rand_draws=tuple(r[i] for r in draws) if rand == "input" else None)
        for g, s in zip(got, solo):
            torch.testing.assert_close(g[i], s, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("numel", [1, 5, 1001, 65_537, 102_400])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_batched_philox_kernel_matches_plain_and_solo_launches(cuda, b, numel):
    keys = torch.stack([torch.tensor([rng.signed64(2**64 - 1 - 7 * s), 2**40 + s], device=cuda)
                        for s in range(b)])
    for derive in (1, 0):
        for kinds in PHILOX_KINDS:
            before = philox.philox_draws_batched.launches
            got = philox.philox_draws_batched(keys, 3, numel, kinds, derive=derive)
            assert philox.philox_draws_batched.launches == before + 1
            want = philox.philox_draws_batched_plain(keys, 3, numel, kinds, derive=derive)
            for g, w in zip(got, want):
                assert g.shape == (b, numel) and g.dtype == w.dtype and torch.equal(g, w)
            for i in range(b):
                seed = rng.Seed(keys[i], 3) if derive else int(keys[i, 0]) & (2**64 - 1)
                for g, s in zip(got, philox.philox_draws(seed, numel, kinds, cuda)):
                    assert torch.equal(g[i], s)


def test_vmapped_pso_generation_is_one_batched_launch_equal_to_solo_runs(cuda):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import StdWorkflow

    wf = StdWorkflow(PSO(256, torch.full((20,), -32.0), torch.full((20,), 32.0), device=cuda), Ackley())
    keys = torch.stack(rng.split_keys(rng.key(4, cuda), 3))
    vmap = torch.func.vmap
    before = (fused_pso_move.launches, fused_pso_move_batched.launches, philox.philox_draws_batched.launches)
    states = vmap(wf.init_step)(vmap(wf.init)(keys))
    step = vmap(wf.step)
    for _ in range(4):
        states = step(states)
    after = (fused_pso_move.launches, fused_pso_move_batched.launches, philox.philox_draws_batched.launches)
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (0, 4, 2)
    for i in range(3):
        solo = wf.init_step(wf.init(keys[i]))
        for _ in range(4):
            solo = wf.step(solo)
        for k in solo.algorithm:
            torch.testing.assert_close(states.algorithm[k][i], solo.algorithm[k], rtol=0, atol=0, equal_nan=True)


def test_vmapped_eigh_is_one_cusolver_call(cuda):
    from evox_tpu_torch.ops import linalg

    C = torch.stack([_spd64(20, s) for s in range(4)]).float().to(cuda)
    before = (linalg.eigh.launches, linalg.eigh_batched.launches)
    w, v = torch.func.vmap(linalg.eigh)(C)
    assert (linalg.eigh.launches - before[0], linalg.eigh_batched.launches - before[1]) == (0, 1)
    for i in range(4):
        ws, _ = linalg.eigh(C[i])
        w64 = torch.linalg.eigvalsh(C[i].cpu().double())
        assert float((w[i].cpu().double() - w64).abs().max() / w64.abs().max()) <= 1e-5
        assert float((w[i] - ws).abs().max() / ws.abs().max()) <= 1e-5
        V = v[i].cpu().double()
        rec = (V * w[i].cpu().double()) @ V.T - C[i].cpu().double()
        assert float(rec.norm() / C[i].cpu().double().norm()) <= 1e-5


def test_batched_pso_move_refuses_operands_of_other_instance_counts(cuda):
    arrays, scal, keys, _ = _batched_move_inputs(3, 16, 8, torch.float32, cuda)
    lb, ub = torch.full((8,), -2.0, device=cuda), torch.full((8,), 2.0, device=cuda)
    with pytest.raises(ValueError, match="global_best_location"):
        fused_pso_move_batched(*arrays[:5], arrays[5][0], lb, ub, scal, keys)
    with pytest.raises(ValueError, match="key"):
        fused_pso_move_batched(*arrays, lb, ub, scal, keys[:2])
    with pytest.raises(ValueError, match="contiguous"):
        fused_pso_move_batched(arrays[0].transpose(1, 2).contiguous().transpose(1, 2), *arrays[1:], lb, ub,
                               scal, keys)


# ---------------------------------------------------------------------------
# Neuroevolution: the captured rollout
# ---------------------------------------------------------------------------


def _fixed_rollout(env_name, sizes, steps, resets, **kw):
    """A RolloutProblem whose episodes start from ``resets`` (CPU tensors,
    copied to the card once), on the device of the keys it is given."""
    import torch.utils._pytree as pytree
    from evox_tpu_torch.problems import neuroevolution as ne

    by_device = {"cpu": resets, "cuda": pytree.tree_map(lambda x: x.cuda(), resets)}

    class Fixed(ne.RolloutProblem):
        def _resets(self, episode_keys):
            return by_device[episode_keys.device.type]

    return Fixed(ne.MLPPolicy(sizes), getattr(ne, env_name)(), steps, **kw)


@pytest.mark.parametrize("env_name,sizes", [("cartpole", (4, 8, 1)), ("pendulum", (3, 8, 1))])
def test_rollout_replays_one_captured_loop_and_matches_the_cpu(cuda, env_name, sizes):
    """Evaluations on the card replay one captured graph of the loop (no
    host sync once captured) and give the CPU's fitness from the same
    initial states and parameters: cart-pole's returns equal on 95 % of
    the individuals (an episode that passes within an ulp of a threshold
    may end a step apart), pendulum's within 1e-4."""
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import rng

    env = getattr(ne, env_name)()
    resets = torch.func.vmap(env.reset)(torch.stack(rng.split_keys(rng.key(3), 2)))
    prob = _fixed_rollout(env_name, sizes, 50, resets, num_episodes=2)
    pop = ne.stack_model_params(ne.MLPPolicy(sizes).init, rng.key(4), 64)
    card_pop = {k: v.to(cuda) for k, v in pop.items()}
    state = prob.setup(rng.key(5, cuda))
    first, _ = prob.evaluate(state, card_pop)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again, _ = prob.evaluate(state, card_pop)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(prob._graphs) == 1
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    cpu, _ = prob.evaluate(prob.setup(rng.key(5)), pop)
    if env_name == "cartpole":
        assert float((first.cpu() == cpu).float().mean()) >= 0.95
    else:
        assert float(((first.cpu() - cpu).abs() / cpu.abs().max()).max()) <= 1e-4


def _ne_workflow(device, problem=None, monitor=True):
    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import ParamsAndVector, rng
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    policy = ne.MLPPolicy((4, 8, 1))
    params0 = policy.init(rng.key(1))
    adapter = ParamsAndVector(params0)
    problem = problem or ne.RolloutProblem(policy, ne.cartpole(), 50, maximize_reward=False)
    return StdWorkflow(OpenES(64, adapter.to_vector(params0), 0.02, 0.05, optimizer="adam", device=device),
                       problem, monitor=EvalMonitor() if monitor else None, opt_direction="max",
                       solution_transform=adapter.batched_to_params)


def test_neuroevolution_run_replays_eager_steps_bit_for_bit(cuda):
    """OpenES on cart-pole: 5 eager steps (each rollout a replay of the
    problem's graph) equal run(5) and run_segment(5) (the rollouts captured
    inline with the generations) bit for bit, and neither an eager step nor
    a segment syncs the host."""
    wf = _ne_workflow(cuda)
    s0 = wf.init_step(wf.init(0))
    ref = s0
    for _ in range(5):
        ref = wf.step(ref)
    _equal_states(wf.run(s0, 5, init=False), ref)
    seg, _ = wf.run_segment(s0, 5)
    _equal_states(seg, ref)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wf.step(s0)
        wf.run_segment(s0, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_neuroevolution_steps_on_the_card_never_run_the_plain_draws(cuda, monkeypatch):
    """OpenES's normals and the episodes' resets on the card launch the
    kernel (the policy's first weights are drawn on the CPU, from a CPU
    key)."""
    real = philox.philox_draws_batched_plain

    def refuse_on_the_card(keys, *a, **k):
        if keys.is_cuda:
            raise AssertionError("the plain version ran on a CUDA tensor")
        return real(keys, *a, **k)

    monkeypatch.setattr(philox, "philox_draws_batched_plain", refuse_on_the_card)
    wf = _ne_workflow(cuda)
    wf.step(wf.init_step(wf.init(1)))
    torch.cuda.synchronize()


def test_rollout_under_vmap_on_the_card_matches_solo_evaluations(cuda):
    """Under ``torch.func.vmap`` over problem instances the loop runs
    eagerly on the card (no capture of batched tensors): each instance's
    fitness within 1e-5 of its solo evaluation (the products of another
    batch shape may be summed in another order)."""
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import rng

    policy = ne.MLPPolicy((3, 8, 1))
    prob = ne.RolloutProblem(policy, ne.pendulum(), 30, num_episodes=2)
    pop = ne.stack_model_params(policy.init, rng.key(8, cuda), 6)
    pop2 = {k: v.reshape((2, 3) + v.shape[1:]) for k, v in pop.items()}
    keys = torch.stack(rng.split_keys(rng.key(9, cuda), 2))
    fit, _ = torch.func.vmap(prob.evaluate)(torch.func.vmap(prob.setup)(keys), pop2)
    assert len(prob._graphs) == 0
    for i in range(2):
        solo, _ = prob.evaluate(prob.setup(keys[i]), {k: v[i] for k, v in pop2.items()})
        assert float(((fit[i] - solo).abs() / solo.abs().max()).max()) <= 1e-5


def test_supervised_device_resident_run_equals_eager_steps_on_the_card(cuda):
    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import ParamsAndVector
    from evox_tpu_torch.workflows import StdWorkflow

    g = torch.Generator().manual_seed(0)
    x = torch.randn(512, 8, generator=g)
    y = x @ torch.randn(8, 1, generator=g)
    prob = ne.SupervisedLearningProblem(lambda p, v: v @ p["w"], x, y, criterion=lambda p, t: ((p - t) ** 2).mean(),
                                        batch_size=64, n_batch_per_eval=3, device=cuda)
    adapter = ParamsAndVector({"w": torch.zeros(8, 1)})
    wf = StdWorkflow(OpenES(32, torch.zeros(8), 0.1, 0.1, device=cuda), prob,
                     solution_transform=adapter.batched_to_params)
    s0 = wf.init_step(wf.init(0))
    ref = s0
    for _ in range(6):
        ref = wf.step(ref)
    _equal_states(wf.run(s0, 6, init=False), ref)
    assert int(ref.problem.batch_cursor) == (3 * 7) % 8
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wf.run_segment(s0, 6)
        wf.step(s0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(ref.algorithm.fit.min()) < float(s0.algorithm.fit.min())


def test_streaming_supervised_refuses_a_segment_on_the_card_before_pulling(cuda):
    """A streaming problem steps eagerly on the card; ``run``/``run_segment``
    raise NotImplementedError before any batch is pulled, so the next
    eager evaluation gets the next batch in source order."""
    import numpy as np
    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import ParamsAndVector
    from evox_tpu_torch.workflows import StdWorkflow

    batches = [(np.ones((4, 1), np.float32), np.full((4, 1), float(k), np.float32)) for k in range(3)]
    prob = ne.SupervisedLearningProblem(lambda p, v: v @ p["w"], criterion=lambda p, t: ((p - t) ** 2).mean(),
                                        data_source=batches, device=cuda)
    adapter = ParamsAndVector({"w": torch.zeros(1, 1)})
    wf = StdWorkflow(OpenES(4, torch.zeros(1), 0.1, 1e-6, device=cuda), prob,
                     solution_transform=adapter.batched_to_params)
    s = wf.init_step(wf.init(0))  # batch 0
    for run in (lambda: wf.run(s, 3, init=False), lambda: wf.run_segment(s, 3)):
        with pytest.raises(NotImplementedError, match="host"):
            run()
    s = wf.step(s)  # batch 1: loss ~1 (w ~ 0)
    assert 0.9 < float(s.algorithm.fit.min()) < 1.1


def test_brax_and_mujoco_problems_run_fused_on_the_card(cuda, monkeypatch):
    """The adapters over the port's engines on the card (their default
    device): 3 eager steps of OpenES equal run(3) bit for bit."""
    import sys

    from evox_tpu_torch.algorithms import OpenES
    from evox_tpu_torch.problems import neuroevolution as ne
    from evox_tpu_torch.utils import ParamsAndVector, rng
    from evox_tpu_torch.workflows import StdWorkflow

    mb, mp = ne.minibrax, ne.miniplayground
    for name, mod in (("brax", mb), ("brax.envs", mb.envs), ("brax.io", mb.io), ("brax.io.html", mb.io.html),
                      ("brax.io.image", mb.io.image), ("mujoco_playground", mp),
                      ("mujoco_playground.registry", mp.registry)):
        monkeypatch.setitem(sys.modules, name, mod)
    cases = [(ne.BraxProblem(ne.MLPPolicy((5, 8, 1)), "hopper", 30, maximize_reward=False), (5, 8, 1)),
             (ne.MujocoProblem(ne.MLPPolicy((4, 8, 2)), "PointMass", 30, maximize_reward=False), (4, 8, 2))]
    for prob, sizes in cases:
        engine = prob._brax_env if isinstance(prob, ne.BraxProblem) else prob._mjx_env._env
        assert engine.sys.mass.device.type == "cuda"
        params0 = ne.MLPPolicy(sizes).init(rng.key(1))
        adapter = ParamsAndVector(params0)
        wf = StdWorkflow(OpenES(32, adapter.to_vector(params0), 0.02, 0.05, optimizer="adam", device=cuda), prob,
                         opt_direction="max", solution_transform=adapter.batched_to_params)
        s0 = wf.init_step(wf.init(0))
        ref = s0
        for _ in range(3):
            ref = wf.step(ref)
        _equal_states(wf.run(s0, 3, init=False), ref)
        assert bool(torch.isfinite(ref.algorithm.fit).all())


# ---------------------------------------------------------------------------
# The precision plane on the card
# ---------------------------------------------------------------------------


def test_bf16_pso_step_takes_the_bf16_route_equal_to_its_plain_version(cuda):
    """A ``PSO(dtype=bfloat16)`` step launches the kernel's bfloat16 route,
    and that move equals ``fused_pso_move_plain`` on the same operands bit
    for bit."""
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.algorithms.so.pso_variants.utils import min_by
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    lb = torch.full((96,), -10.0, dtype=torch.bfloat16)
    wf = StdWorkflow(PSO(3000, lb, -lb, dtype=torch.bfloat16, device=cuda), Sphere())
    ws = wf.step(wf.init_step(wf.init(0)))
    st = ws.algorithm
    gbl, _ = min_by([st.global_best_location[None, :], st.pop], [st.global_best_fit[None], st.fit])
    _, (seed,) = rng.split(st.key)
    ops = (st.pop, st.velocity, st.local_best_location, st.fit, st.local_best_fit, gbl, wf.algorithm.lb,
           wf.algorithm.ub, st.w, st.phi_p, st.phi_g, seed)
    routes = dict(fused_pso_move.routes)
    got = fused_pso_move(*ops)
    assert fused_pso_move.routes["bfloat16"] == routes["bfloat16"] + 1
    assert fused_pso_move.routes["float32"] == routes["float32"]
    for g, w in zip(got, fused_pso_move_plain(*ops)):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    stepped = wf.step(ws).algorithm
    for g, name in zip(got, ("pop", "velocity", "local_best_location", "local_best_fit")):
        assert torch.equal(g.view(torch.int16), stepped[name].view(torch.int16)), name


def test_run_under_the_policy_replays_eager_steps_bit_for_bit(cuda):
    """``run(3)`` under ``PrecisionPolicy()`` and ``rbg`` on the card equals
    3 eager steps bit for bit, carries the storage dtype, and its replay
    (``run_segment``) makes no host sync; the move runs on the float32
    route."""
    from evox_tpu_torch.precision import PrecisionPolicy

    wf = _segment_workflow("pso", cuda, precision=PrecisionPolicy(), key_impl="rbg")
    s0 = wf.step(wf.init_step(wf.init(0)))
    assert s0.algorithm.pop.dtype == torch.bfloat16
    routes = dict(fused_pso_move.routes)
    ref = s0
    for _ in range(3):
        ref = wf.step(ref)
    assert fused_pso_move.routes["float32"] == routes["float32"] + 3
    assert fused_pso_move.routes["bfloat16"] == routes["bfloat16"]
    _equal_states(wf.run(s0, 3, init=False), ref)  # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replayed, _ = wf.run_segment(s0, 3)  # a replay of run's capture
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _equal_states(replayed, ref)
    assert replayed.algorithm.velocity.dtype == torch.bfloat16


def test_setup_under_key_impl_makes_no_host_sync(cuda):
    """The key path of ``setup`` (re-seeding a key of another family, or
    passing one of the workflow's) and the storage form's casts run on the
    card without a host sync."""
    from evox_tpu_torch.precision import PrecisionPolicy, coerce_key, key_impl_name, make_key

    wf = _segment_workflow("pso", cuda, precision=PrecisionPolicy(), key_impl="rbg")
    wide = wf.init(0)
    wide = wide.replace(algorithm=PrecisionPolicy().promote(wide.algorithm, wf._precision_leaf_map))
    keys = [rng.key(3, cuda), make_key(3, "rbg", cuda), make_key(3, "unsafe_rbg", cuda)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [wf._setup_key(k) for k in keys]
        low = wf.apply_precision(wide)
        children = rng.split_keys(got[0], 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(k.device.type == "cuda" and key_impl_name(k) == "rbg" for k in got + children)
    assert torch.equal(got[1], keys[1])
    assert [k.cpu().tolist() for k in got] == [coerce_key(k.cpu(), "rbg").tolist() for k in keys]
    assert low.algorithm.pop.dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg", "unsafe_rbg"])
def test_tagged_keys_draw_on_the_card_what_the_cpu_plain_version_draws(cuda, impl):
    """A key of each stream family (its tag in the counter word's top byte)
    and its children (``split_keys`` carries the tag) draw on the card, by
    the solo and the batched kernel, the bits that the plain version draws
    from the same keys on the CPU."""
    from evox_tpu_torch.precision import make_key

    key = make_key(7, impl)
    kids = torch.stack(rng.split_keys(key, 3))
    kids_card = torch.stack(rng.split_keys(key.to(cuda), 3))
    assert torch.equal(kids_card.cpu(), kids)
    for kinds in PHILOX_KINDS:
        for k, numel in ((key, 5), (key, 65_537), (kids[1], 1001)):
            got = philox.philox_draws(rng.child(k.to(cuda), 2), numel, kinds, cuda)
            want = philox.philox_draws_plain(rng.child(k, 2), numel, kinds, "cpu")
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
        got = philox.philox_draws_batched(kids_card, 2, 4099, kinds, derive=1)
        want = philox.philox_draws_batched_plain(kids, 2, 4099, kinds, derive=1)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g.cpu(), w)


# ---------------------------------------------------------------------------
# The HPO nest on the card, and the float64 refusal
# ---------------------------------------------------------------------------


def _hpo_ladder(device, candidates=8, inner_pop=64, dim=8, iterations=6, **kw):
    """bench.py's hpo_ladder at a small width: PSO over OpenES candidates."""
    from evox_tpu_torch.algorithms import PSO, OpenES
    from evox_tpu_torch.hpo import HPOFitnessMonitor, NestedProblem
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    dev = {} if device is None else {"device": device}
    inner = StdWorkflow(OpenES(inner_pop, torch.zeros(dim), learning_rate=0.05, noise_stdev=0.1, **dev), Sphere(),
                        monitor=HPOFitnessMonitor())
    nested = NestedProblem(inner, iterations=iterations, num_candidates=candidates, **kw)
    outer = StdWorkflow(PSO(candidates, lb=1e-3 * torch.ones(2), ub=0.5 * torch.ones(2), **dev), nested,
                        solution_transform=lambda x: {"algorithm.lr": x[:, 0].clamp(1e-3, 0.5),
                                                      "algorithm.noise_stdev": x[:, 1].clamp(1e-3, 0.5)})
    return outer, nested, inner


def test_hpo_entry_points_run_on_the_card_by_default(cuda):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.hpo_wrapper import HPOFitnessMonitor, HPOProblemWrapper
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    outer, nested, _ = _hpo_ladder(None)
    state = outer.init_step(outer.init(0))
    leaves = graph.flatten(state)[0]
    assert all(x.device.type == "cuda" for x in leaves)
    assert state.problem.uids.dtype == torch.int64
    inner = StdWorkflow(PSO(10, -torch.ones(3), torch.ones(3)), Sphere(), monitor=HPOFitnessMonitor())
    hpo = HPOProblemWrapper(iterations=4, num_instances=3, workflow=inner)
    s = hpo.setup(rng.key(0, cuda))
    fit, _ = hpo.evaluate(s, hpo.get_init_params(s))
    assert fit.device.type == "cuda" and torch.isfinite(fit).all()


@pytest.mark.parametrize("repeats,aggregation", [(1, "per_generation"), (3, "per_generation"), (3, "final")])
def test_replayed_nest_equals_the_eager_nest_and_makes_no_host_sync(cuda, repeats, aggregation):
    """An evaluation replays its captured batch: equal bit for bit to the
    same batch run eagerly (uncaptured), and a replay makes no host sync."""
    _, nested, _ = _hpo_ladder(cuda, num_repeats=repeats, aggregation=aggregation)
    state = nested.setup(rng.key(2, cuda))
    hp = {"algorithm.lr": torch.linspace(0.01, 0.4, 8, device=cuda),
          "algorithm.noise_stdev": torch.linspace(0.3, 0.02, 8, device=cuda)}
    fit, s1 = nested.evaluate(state, hp)  # the capture
    assert len(nested._graphs) == 1
    real = graph.replays
    graph.replays = lambda device: False
    try:
        eager_fit, eager = nested.evaluate(state, hp)
    finally:
        graph.replays = real
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay_fit, s2 = nested.evaluate(state, hp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got in (fit, replay_fit):
        assert torch.equal(got, eager_fit)
    _equal_states(s1.telemetry, eager.telemetry)
    _equal_states(s2.telemetry, eager.telemetry)
    assert len(nested._graphs) == 1


def test_outer_run_equals_eager_outer_steps_with_replayed_nests(cuda):
    """Eager outer steps (each nest a replayed graph) equal the outer
    ``run(n)`` (the nests captured inline), bit for bit; a candidate equals
    its solo inner run from ``fold_in(key, uid)``."""
    from evox_tpu_torch.core import set_params

    outer, nested, inner = _hpo_ladder(cuda)
    s1 = outer.step(outer.init_step(outer.init(0)))
    ref = s1
    for _ in range(3):
        ref = outer.step(ref)
    _equal_states(outer.run(s1, 3, init=False), ref)
    # Candidate 5 of the last evaluation, solo.
    hp = outer.solution_transform(ref.algorithm.pop)
    fit, _ = nested.evaluate(ref.problem, hp)
    # The outer setup hands the nest the second of three keys.
    prob_key = rng.split_keys(outer._setup_key(0), 3)[1]
    uid = ref.problem.uids[5]
    ws = set_params(inner.setup(rng.fold_in(prob_key, uid)), {k: v[5] for k, v in hp.items()})
    ws = inner.init_step(ws)
    for _ in range(nested.iterations - 2):
        ws = inner.step(ws)
    ws = inner.final_step(ws)
    assert torch.equal(fit[5], ws.monitor.best_fitness)


def test_batched_move_with_per_candidate_scalars_equals_the_cpu_plain_version(cuda):
    """The README quick start's inner PSO under a vmapped nest: the batched
    move launched with a different (w, phi_p, phi_g) row per candidate
    equals fused_pso_move_batched_plain on the CPU on the same operands, bit
    for bit."""
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.ops import pso_step
    from evox_tpu_torch.problems.hpo_wrapper import HPOFitnessMonitor, HPOProblemWrapper
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    inner = StdWorkflow(PSO(30, -10 * torch.ones(8), 10 * torch.ones(8), device=cuda), Sphere(),
                        monitor=HPOFitnessMonitor())
    hpo = HPOProblemWrapper(iterations=5, num_instances=16, workflow=inner)
    state = hpo.setup(rng.key(1, cuda))
    g = torch.Generator().manual_seed(0)
    scal = (torch.rand(16, 3, generator=g) * torch.tensor([1.0, 4.0, 4.0])).to(cuda)
    hp = {"algorithm.w": scal[:, 0], "algorithm.phi_p": scal[:, 1], "algorithm.phi_g": scal[:, 2]}
    seen = []
    launch = pso_step._launch

    def recording(*args):
        out = launch(*args)
        seen.append(([a.clone() if isinstance(a, torch.Tensor) else a for a in args], [o.clone() for o in out]))
        return out

    pso_step._launch, real = recording, graph.replays
    graph.replays = lambda device: False
    before = pso_step.fused_pso_move_batched.launches
    try:
        hpo.evaluate(state, hp)
    finally:
        pso_step._launch, graph.replays = launch, real
    # One a middle generation (3) and one for the final step.
    assert len(seen) == 4 == pso_step.fused_pso_move_batched.launches - before
    for args, out in seen:
        pop, vel, lbl, fit, lbf, gbl, lb, ub, s, key, index, derive, rp, rg = args
        assert s.shape == (16, 3) and len({tuple(r) for r in s.tolist()}) == 16
        assert torch.equal(s, scal)
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args[:12]]
        want = pso_step.fused_pso_move_batched_plain(*cpu)
        for got, w in zip(out, want):
            assert torch.equal(got.cpu(), w)


@pytest.mark.parametrize("kind", ["pso", "nsga2"])
def test_float64_compute_is_refused_at_setup_before_any_launch(cuda, kind):
    from evox_tpu_torch.algorithms import NSGA2, PSO
    from evox_tpu_torch.ops import crowding
    from evox_tpu_torch.precision import PrecisionPolicy
    from evox_tpu_torch.problems.numerical import DTLZ2, Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    if kind == "pso":
        wf = StdWorkflow(PSO(64, -torch.ones(4), torch.ones(4), device=cuda), Sphere(),
                         precision=PrecisionPolicy(compute="float64"))
        message = r"PSO on cuda(:0)? computes in float64.*fused_pso_move takes float32 or bfloat16"
    else:
        wf = StdWorkflow(NSGA2(64, 3, torch.zeros(6), torch.ones(6), device=cuda), DTLZ2(d=6, m=3, device=cuda),
                         precision=PrecisionPolicy(compute="float64"))
        message = r"NSGA2 on cuda(:0)? computes in float64.*crowding_neighbors takes float32"
    counters = (philox.philox_draws, philox.philox_draws_batched, fused_pso_move, fused_pso_move_batched,
                crowding.crowding_neighbors)
    before = [c.launches for c in counters]
    with pytest.raises(TypeError, match=message):
        wf.init(0)
    assert [c.launches for c in counters] == before
    # A PSO of dtype float64 without a policy: the same refusal.
    if kind == "pso":
        with pytest.raises(TypeError, match="fused_pso_move takes float32 or bfloat16"):
            StdWorkflow(PSO(64, -torch.ones(4), torch.ones(4), dtype=torch.float64, device=cuda), Sphere()).init(0)


# ---------------------------------------------------------------------------
# The front peel and the Philox draws as redesigned for Hopper: the cases
# their designs make (load widths and partial tiles, the early stops, one
# front a row, one barrier a front, whole passes, vectors at the streams'
# ends, the 32- and 64-bit index routes).
# ---------------------------------------------------------------------------

from evox_tpu_torch.ops import _build  # noqa: E402

# n not a multiple of 32 (a partial last tile) nor of 4 (loads of 2 words:
# 130, 20,002; of one: 31, 33, 127, 129, 4095, 4097, 20,001), a multiple of 4
# but not of 32 (132, 20,004).
PEEL_EDGE_SIZES = [31, 33, 127, 129, 130, 132, 4095, 4097, 20_001, 20_002, 20_004]


@pytest.mark.parametrize("n", PEEL_EDGE_SIZES)
@pytest.mark.parametrize("until", ["none", "zero", "half", "n", "n+1"])
def test_peel_fronts_at_every_load_width_and_stop(cuda, n, until):
    words = dominance.dominance_packed(_dtlz_like(n, 3, cuda, seed=3))
    u = {"none": None, "zero": 0, "half": n // 2, "n": n, "n+1": n + 1}[until]
    before = dominance.peel_fronts.launches
    got = dominance.peel_fronts(words, u)
    assert dominance.peel_fronts.launches == before + 1
    _same(got, dominance.peel_fronts_plain(words, u))


@pytest.mark.parametrize("n", [33, 2048, 20_000])
def test_peel_fronts_with_every_column_in_front_0(cuda, n):
    x = torch.linspace(0, 1, n, device=cuda)
    words = dominance.dominance_packed(torch.stack([x, 1 - x], 1))
    assert not bool(words.any())
    for u in (None, n // 2):
        got = dominance.peel_fronts(words, u)
        _same(got, torch.zeros(n, dtype=torch.int32, device=cuda))
        _same(got, dominance.peel_fronts_plain(words, u))


@pytest.mark.parametrize("until", [None, 2048])
def test_peel_fronts_peels_a_total_order_one_front_a_row(cuda, until):
    """4096 fronts of one row each: a barrier a front."""
    n = 4096
    g = torch.Generator(device=cuda).manual_seed(4)
    order = torch.randperm(n, generator=g, device=cuda)
    f = torch.stack([order.float(), 2 * order.float()], 1)
    words = dominance.dominance_packed(f)
    got = dominance.peel_fronts(words, until)
    _same(got, dominance.peel_fronts_plain(words, until))
    want = order.to(torch.int32) if until is None else torch.where(order < until, order, n).to(torch.int32)
    _same(got, want)


@pytest.mark.parametrize("n", [33, 2049, 20_000])
def test_peel_fronts_with_nan_rows(cuda, n):
    f = _dtlz_like(n, 3, cuda, seed=11)
    f[::7, 1] = float("nan")
    f[::13] = float("nan")
    words = dominance.dominance_packed(f)
    for u in (None, n // 2):
        _same(dominance.peel_fronts(words, u), dominance.peel_fronts_plain(words, u))


@pytest.mark.parametrize("until", [None, 10_000])
def test_peel_fronts_captured_and_replayed(cuda, until):
    """A captured peel replays on the words it reads at replay time."""
    n = 20_000
    words = dominance.dominance_packed(_dtlz_like(n, 3, cuda, seed=1))
    dominance.peel_fronts(words, until)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rank = dominance.peel_fronts(words, until)
    for seed in (1, 2):
        words.copy_(dominance.dominance_packed(_dtlz_like(n, 3, cuda, seed=seed)))
        graph.replay()
        torch.cuda.synchronize()
        _same(rank, dominance.peel_fronts_plain(words, until))


def _philox_keys(b, device, seed=0):
    g = torch.Generator().manual_seed(seed + b)
    k = torch.randint(-(2**63), 2**63 - 1, (b, 2), generator=g, dtype=torch.int64)
    return k.to(device)


@pytest.mark.parametrize("b", [1, 3])
def test_philox_kernel_at_every_size_up_to_two_vectors_and_one(cuda, b):
    keys = _philox_keys(b, cuda)
    for numel in range(1, 2 * philox._VEC + 2):
        for kinds in PHILOX_KINDS:
            got = philox.philox_draws_batched(keys, 1, numel, kinds)
            want = philox.philox_draws_batched_plain(keys, 1, numel, kinds)
            for g, w in zip(got, want):
                assert g.shape == (b, numel) and torch.equal(g, w)
            if b == 1:
                for g, w in zip(philox.philox_draws(rng.Seed(keys[0], 1), numel, kinds, cuda), want):
                    assert torch.equal(g, w[0])


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("kinds", [[torch.float32], [torch.float32, (0, 2), torch.bfloat16, torch.float64]],
                         ids=["one", "four"])
def test_philox_kernel_around_each_pass_boundary(cuda, b, kinds):
    """Sizes around the first three multiples of what a stream's share of
    the resident blocks draws in one pass (where the plan's passes a thread
    or its grid change), each held against the plain version."""
    index = torch.cuda.current_device()
    sms = _build.sm_count(index)
    share = max(1, sms * philox._blocks_per_sm(index, len(kinds), False, philox._VEC) // b)
    per_pass = share * philox._THREADS * philox._VEC
    keys = _philox_keys(b, cuda, seed=1)
    for numel in (per_pass - 1, per_pass, per_pass + 1, 2 * per_pass + 3, 3 * per_pass - 1, 3 * per_pass + 1):
        got = philox.philox_draws_batched(keys, 2, numel, kinds)
        for g, w in zip(got, philox.philox_draws_batched_plain(keys, 2, numel, kinds)):
            assert torch.equal(g, w)


def test_philox_draws_of_no_element_launch_nothing(cuda):
    kinds = [torch.float32, (0, 2)]
    before = philox.philox_draws.launches, philox.philox_draws_batched.launches
    for g in philox.philox_draws(rng.child(rng.key(1, cuda)), 0, kinds, cuda):
        assert g.shape == (0,) and g.device.type == "cuda"
    for g in philox.philox_draws_batched(_philox_keys(3, cuda), 0, 0, kinds):
        assert g.shape == (3, 0)
    assert (philox.philox_draws.launches, philox.philox_draws_batched.launches) == before


@pytest.mark.parametrize("b", [1, 4096])
@pytest.mark.parametrize("numel", [1, 7, 1000])
def test_batched_philox_kernel_at_one_and_4096_streams(cuda, b, numel):
    keys = _philox_keys(b, cuda, seed=2)
    kinds = [torch.float32, (0, 2), torch.bfloat16, torch.float64]
    got = philox.philox_draws_batched(keys, 0, numel, kinds)
    for g, w in zip(got, philox.philox_draws_batched_plain(keys, 0, numel, kinds)):
        assert g.shape == (b, numel) and torch.equal(g, w)


@pytest.mark.parametrize("b", [4095, 4097])
def test_batched_philox_kernel_on_each_side_of_2_31_elements(cuda, b):
    """4095 and 4097 streams of 2^19 + 1 bfloat16 draws (~4.3 GB): the
    32-bit index route below 2^31 elements in all, the 64-bit one above;
    the rows around flat element 2^31 against the plain version."""
    numel = 2**19 + 1
    index = torch.cuda.current_device()
    plan = philox._launch_plan(b, numel, _build.sm_count(index),
                               lambda wide, vec: philox._blocks_per_sm(index, 1, wide, vec))
    assert plan.wide == (b > 4096)
    keys = _philox_keys(b, cuda, seed=3)
    (got,) = philox.philox_draws_batched(keys, 0, numel, [torch.bfloat16])
    rows = [0, 1, b // 2, 4094, b - 2, b - 1]
    (want,) = philox.philox_draws_batched_plain(keys[rows], 0, numel, [torch.bfloat16])
    assert torch.equal(got[rows], want)
    del got
    torch.cuda.empty_cache()


# -- sharded evaluation and the checkpoint store on the card ------------------


def _same_state(a, b):
    from evox_tpu_torch.utils import graph

    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)


def _dist_pso(cuda, **kw):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    algo = PSO(1024, torch.full((64,), -10.0), torch.full((64,), 10.0), device=cuda)
    return StdWorkflow(algo, Sphere(), monitor=EvalMonitor(), **kw)


def test_distributed_workflow_on_a_one_rank_nccl_mesh(cuda):
    """enable_distributed on one card (a one-rank NCCL group): eager steps
    and run(5), whose captured graph holds the all-gather, equal the
    unsharded workflow's bit for bit."""
    from evox_tpu_torch.parallel import ShardedProblem

    wf, ref = _dist_pso(cuda, enable_distributed=True), _dist_pso(cuda)
    assert isinstance(wf.problem, ShardedProblem) and wf.mesh.device.type == "cuda"
    s, r = wf.init_step(wf.init(0)), ref.init_step(ref.init(0))
    for _ in range(3):
        s, r = wf.step(s), ref.step(r)
    _same_state(s, r)
    _same_state(wf.run(s, 5, init=False), ref.run(r, 5, init=False))
    seg, _ = wf.run_segment(s, 5)
    _same_state(seg, ref.run(r, 5, init=False))


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """save_state copies each card leaf to the host; load_state puts it back
    on its template leaf's device; the async writer's copy runs on a side
    stream after the submitting stream's work."""
    from evox_tpu_torch.utils import AsyncCheckpointWriter, load_state, save_state, verify_checkpoint

    wf = _dist_pso(cuda)
    s = wf.step(wf.init_step(wf.init(1)))
    path = save_state(tmp_path / "s.npz", s, durable=True)
    verify_checkpoint(path)
    _same_state(load_state(path, wf.init(2)), s)
    writer = AsyncCheckpointWriter()
    writer.submit(tmp_path / "a.npz", s)
    s2 = wf.step(s)
    assert writer.close(timeout=120) and not writer.pop_errors()
    _same_state(load_state(tmp_path / "a.npz", wf.init(2)), s)
    assert s2.algorithm.pop.device.type == "cuda"


def _runner_pso(cuda, problem=None, pop=1024, dim=100):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    algo = PSO(pop, torch.full((dim,), -32.0), torch.full((dim,), 32.0), device=cuda)
    return StdWorkflow(algo, problem if problem is not None else Ackley(), monitor=EvalMonitor())


def test_resilient_runner_equals_run_on_the_card(cuda, tmp_path):
    """pso_small_resilient's shape: the runner's fused segments (captured
    graphs) end where run(n) and n eager steps end, bit for bit, with one
    copy to the host a segment; a second call resumes and does nothing."""
    from evox_tpu_torch.resilience import ResilientRunner

    wf = _runner_pso(cuda)
    runner = ResilientRunner(wf, tmp_path, checkpoint_every=25)
    out = runner.run(wf.init(0), 60, fresh=True)
    assert runner.stats.chunk_sizes == [25, 25, 9] and runner.stats.cpu_fallbacks == 0
    assert [t.compile_seconds > 0 for t in runner.stats.segment_timings] == [False, True, False, True]
    ref = _runner_pso(cuda)
    _same_state(out, ref.run(ref.init(0), 60))
    eager = ref.init_step(ref.init(0))
    for _ in range(59):
        eager = ref.step(eager)
    _same_state(out, eager)
    again = ResilientRunner(_runner_pso(cuda), tmp_path, checkpoint_every=25)
    _same_state(again.run(_runner_pso(cuda).init(0), 60), out)
    assert again.stats.segments_run == 0


def test_host_faults_step_eagerly_on_the_card(cuda, tmp_path):
    """A FaultyProblem with host faults is not capturable: the runner steps
    its segments eagerly, on the card (never the CPU), and a retried error
    ends where the clean run does; device faults stay in the graph."""
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import FaultyProblem, ResilientRunner, RetryPolicy

    prob = FaultyProblem(Ackley(), error_generations=(7,), nan_generations=(3,), nan_rows=4)
    assert not prob.capturable
    wf = _runner_pso(cuda, prob, pop=64, dim=16)
    runner = ResilientRunner(wf, tmp_path / "f", checkpoint_every=5, retry=RetryPolicy(backoff_base=0.001))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(wf.init(0), 16)
    assert out.algorithm.pop.device.type == "cuda" and len(wf._graphs) == 0
    assert runner.stats.retries == 1 and runner.stats.cpu_fallbacks == 0 and int(out.monitor.num_nonfinite) == 4
    clean = _runner_pso(cuda, FaultyProblem(Ackley(), nan_generations=(3,), nan_rows=4), pop=64, dim=16)
    assert clean.problem.capturable
    ref = ResilientRunner(clean, tmp_path / "c", checkpoint_every=5).run(clean.init(0), 16)
    assert len(clean._graphs) > 0
    _same_state(out, ref)


def test_retry_waits_for_an_abandoned_replay(cuda, tmp_path):
    """A replay still running when the watchdog abandons it: the retry
    waits for its event before it writes the graph's static buffers or
    replays it, and the run ends where the clean run does."""
    from evox_tpu_torch.resilience import ResilientRunner, RetryPolicy, WatchdogTimeout

    wf = _runner_pso(cuda, pop=256, dim=32)
    runner = ResilientRunner(wf, tmp_path / "w", checkpoint_every=5, watchdog_timeout=0.5,
                             retry=RetryPolicy(backoff_base=0.001))
    real = wf._run_segment
    slowed = []

    def slow_once(state, n, cfg):
        if not slowed:
            slowed.append(1)
            torch.cuda._sleep(2_400_000_000)  # ~1.2 s of a ~2 GHz SM clock on the stream
        return real(state, n, cfg)

    wf._run_segment = slow_once
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = runner.run(wf.init(0), 16)
    assert runner.stats.watchdog_timeouts >= 1 and runner._abandoned is None
    ref = _runner_pso(cuda, pop=256, dim=32)
    _same_state(out, ref.run(ref.init(0), 16))
    assert issubclass(WatchdogTimeout, RuntimeError)


def test_cpu_fallback_is_refused_on_the_card(cuda, tmp_path):
    from evox_tpu_torch.resilience import ResilientRunner

    wf = _runner_pso(cuda, pop=64, dim=16)
    with pytest.raises(NotImplementedError, match="cpu_fallback"):
        ResilientRunner(wf, tmp_path, cpu_fallback=True).run(wf.init(0), 5)


def test_a_dead_graph_in_a_cycle_does_not_break_a_capture(cuda):
    """A workflow whose captured graph is reachable only from a reference
    cycle (as a finished runner's workflow is) is destroyed when the cycle
    collector runs, and a graph destroyed while a capture is open
    invalidates the capture.  Here the cycle becomes garbage inside a
    capture, with the collector at its most eager: the capture still
    succeeds, and the dead graph goes afterwards."""
    import gc

    from evox_tpu_torch.utils import graph

    dead = _runner_pso(cuda, pop=64, dim=16)
    dead.run(dead.init(0), 5)
    assert len(dead._graphs) == 1
    holder = [dead]
    del dead

    def program(carry, n):
        if torch.cuda.is_current_stream_capturing() and holder:
            cycle = [holder.pop()]
            cycle.append(cycle)
            del cycle
            [[i] for i in range(1000)]  # allocations: the collector's chances to run
        return (carry[0] * 2,), {}, None

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        x = torch.arange(4.0, device=cuda)
        (y,), _, _ = graph.run(graph.Cache(), "double", program, (x,), 1)
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    torch.cuda.synchronize()
    assert not holder and torch.equal(y, x * 2)


def test_scrapes_during_a_capture_never_touch_the_card(cuda, tmp_path):
    """An IntrospectionEndpoint over a runner's registry, health and
    flight ring, scraped in a loop by another thread across the runner's
    first captures: every scrape answers 200, no capture fails, and the run
    equals run(n) bit for bit."""
    import threading
    import urllib.request

    from evox_tpu_torch.obs import FlightRecorder, IntrospectionEndpoint, MetricsRegistry, Observability
    from evox_tpu_torch.resilience import HealthProbe, ResilientRunner

    wf = _runner_pso(cuda, pop=256, dim=32)
    plane = Observability(registry=MetricsRegistry(), flight=FlightRecorder(tmp_path / "pm", window=64), run_id="r")
    runner = ResilientRunner(wf, tmp_path / "run", checkpoint_every=7, health=HealthProbe(), obs=plane)

    def healthz():
        report = runner.stats.last_report
        return (True, {}) if report is None else (report.healthy, {"generation": report.generation})

    ep = IntrospectionEndpoint(registry=plane.registry, healthz=healthz,
                               flight=lambda rid: plane.flight.rows() if rid == "r" else None).start()
    stop, statuses = threading.Event(), []

    def scrape():
        while not stop.is_set():
            for path in ("/metrics", "/healthz", "/flightz/r"):
                with urllib.request.urlopen(ep.url + path, timeout=10) as resp:
                    statuses.append(resp.status)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    try:
        out = runner.run(wf.init(0), 31, fresh=True)
    finally:
        stop.set()
        scraper.join(timeout=30)
        ep.stop()
    assert not scraper.is_alive() and statuses and set(statuses) == {200}
    assert sum(t.compile_seconds > 0 for t in runner.stats.segment_timings) == 2  # the segments of 7 and 2
    ref = _runner_pso(cuda, pop=256, dim=32)
    _same_state(out, ref.run(ref.init(0), 31))


def test_cadence_captures_each_segment_length_once(cuda, tmp_path):
    """Under a self-tuning cadence (here a scripted one: 16, 2, 4, 8 in
    turn, and a tail of 5 — more lengths than the default cache keeps) the
    workflow's graph cache keeps every length the cadence can pick, so a
    run captures each distinct segment length once and a second run
    captures nothing; the state equals the controller-off run bit for
    bit."""
    import itertools

    from evox_tpu_torch.control import Controller
    from evox_tpu_torch.resilience import ResilientRunner
    from evox_tpu_torch.utils import graph

    def scripted():
        ctl = Controller(target_seconds=1.0)
        script = itertools.cycle([16, 2, 4, 8])
        ctl.next_chunk = lambda timings, **kw: next(script)
        return ctl

    wf = _runner_pso(cuda, pop=256, dim=32)
    runner = ResilientRunner(wf, tmp_path / "on", checkpoint_every=16, controller=scripted())
    out = runner.run(wf.init(0), 66, fresh=True)
    lengths = {c for c in runner.stats.chunk_sizes if c > 1}
    assert runner.stats.chunk_sizes == [16, 2, 4, 8, 16, 2, 4, 8, 5] and len(lengths) > graph.MAX_GRAPHS
    assert wf._graphs.captures == len(lengths) and wf._graphs.max_graphs == runner._cadence_lengths()
    ResilientRunner(wf, tmp_path / "again", checkpoint_every=16, controller=scripted()).run(wf.init(0), 66, fresh=True)
    assert wf._graphs.captures == len(lengths)
    ref = _runner_pso(cuda, pop=256, dim=32)
    _same_state(out, ResilientRunner(ref, tmp_path / "off", checkpoint_every=16).run(ref.init(0), 66))


# ---------------------------------------------------------------------------
# the service core: TenantPack's captured program, the packed service
# ---------------------------------------------------------------------------


def _pack_workflow(cuda, problem=None, pop=256, dim=32):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.workflows import StdWorkflow

    return StdWorkflow(PSO(pop, torch.full((dim,), -32.0), torch.full((dim,), 32.0), device=cuda),
                       problem if problem is not None else Ackley())


def _tenant(wf, uid, cuda):
    from evox_tpu_torch.service import assign_fault_lane
    from evox_tpu_torch.utils import rng

    return assign_fault_lane(wf.setup(rng.fold_in(rng.key(0, cuda), uid), instance_id=uid), uid)


def _syncs(fn):
    """``fn()`` and the synchronizing CUDA calls it made (the sync debug
    mode's warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message)[:120] for w in caught if "synchronizing CUDA operation" in str(w.message)]


def test_pack_one_capture_across_freeze_thaw_admit_and_evict(cuda):
    """One capture of the segment program (and one of the init program)
    serves freezes, thaws, an admission and an eviction; a segment reads
    the card once; every lane equals the same tenant's eager steps."""
    from evox_tpu_torch.service import TenantPack

    wf = _pack_workflow(cuda)
    pack = TenantPack(wf, 4, early_stop=False)
    for uid in (0, 1):
        s, _, _ = pack.init_tenant(_tenant(wf, uid, cuda))
        pack.admit(s, uid)
    gens = {0: 0, 1: 0}
    pack.run_segment(5)
    gens[0] += 5
    gens[1] += 5
    pack.set_frozen(1, True)
    tel, syncs = _syncs(lambda: pack.run_segment(5))
    assert len(syncs) == 1, syncs
    assert tel.executed.tolist() == [5, 0, 0, 0]
    gens[0] += 5
    pack.set_frozen(1, False)
    s, _, _ = pack.init_tenant(_tenant(wf, 2, cuda))
    assert pack.admit(s, 2) == 2
    gens[2] = 0
    pack.run_segment(5)
    for uid in gens:
        gens[uid] += 5
    evicted = pack.lane_state(0)
    pack.release(0)
    pack.run_segment(5)
    for uid in (1, 2):
        gens[uid] += 5
    assert pack.captures == {"init": 1, "segment": 1} and pack._graphs.captures == 2
    for lane, uid in [(1, 1), (2, 2)]:
        want = wf.init_step(_tenant(wf, uid, cuda))
        for _ in range(gens[uid]):
            want = wf.step(want)
        _same_state(pack.lane_state(lane), want)
    want = wf.init_step(_tenant(wf, 0, cuda))
    for _ in range(gens[0]):
        want = wf.step(want)
    _same_state(evicted, want)


def test_vmapped_run_segment_on_the_card_equals_the_pack_and_solo_segments(cuda):
    from evox_tpu_torch.service import TenantPack

    wf = _pack_workflow(cuda)
    states = [wf.init_step(_tenant(wf, uid, cuda)) for uid in range(4)]
    stacked = _stack_states(states)
    got, tel = torch.func.vmap(lambda s: wf.run_segment(s, 6))(stacked)
    pack = TenantPack(wf, 4, early_stop=False)
    for uid, s in enumerate(states):
        pack.admit(s, uid)
    pack.run_segment(6)
    assert tel.executed.tolist() == [6] * 4
    for i, s in enumerate(states):
        want = wf.run_segment(s, 6)[0]
        _same_state(_lane_of(got, i), want)
        _same_state(pack.lane_state(i), want)


def _stack_states(states):
    from evox_tpu_torch.utils import graph

    cols = [graph.flatten(s)[0] for s in states]
    return graph.unflatten(graph.flatten(states[0])[1], [torch.stack(c) for c in zip(*cols)])


def _lane_of(state, i):
    from evox_tpu_torch.utils import graph

    leaves, spec = graph.flatten(state)
    return graph.unflatten(spec, [x[i] for x in leaves])


def test_packed_service_on_the_card_keeps_the_bulkhead(cuda, tmp_path):
    """A tenant packed beside a NaN-bursting and a stagnating cotenant ends
    on the bits, history and checkpoint digests of the same tenant alone,
    on the card; a lane-delay bucket steps eagerly there and says so."""
    import os
    import warnings

    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.resilience import FaultyProblem, HealthProbe
    from evox_tpu_torch.service import OptimizationService, TenantSpec, TenantStatus
    from evox_tpu_torch.utils import read_manifest

    faults = {1: {"nan_generations": tuple(range(3, 40)), "nan_rows": 64}, 2: {"plateau_from": 2, "plateau_floor": 50.0}}

    def spec(name, uid):
        wf = _pack_workflow(cuda, pop=64, dim=8)
        return TenantSpec(name, wf.algorithm, FaultyProblem(Ackley(), lane_faults=faults), n_steps=21, uid=uid)

    def service(root):
        return OptimizationService(root, lanes_per_pack=4, segment_steps=4,
                                   health=HealthProbe(stagnation_window=2, stagnation_tol=0.0))

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solo = service(tmp_path / "solo")
        solo.submit(spec("t", 0))
        solo.run()
        packed = service(tmp_path / "packed")
        for name, uid in (("t", 0), ("nan", 1), ("stag", 2)):
            packed.submit(spec(name, uid))
        packed.run()
    assert packed.tenant("nan").status is TenantStatus.QUARANTINED
    assert solo.tenant("t").status is packed.tenant("t").status is TenantStatus.COMPLETED
    _same_state(packed.result("t"), solo.result("t"))
    for a, b in zip(packed.tenant("t").monitor.fitness_history, solo.tenant("t").monitor.fitness_history):
        assert torch.equal(a, b)
    digests = []
    for root in ("solo", "packed"):
        ns = tmp_path / root / "tenants" / "t"
        digests.append(read_manifest(ns / sorted(os.listdir(ns))[-1])["leaf_digests"])
    assert digests[0] == digests[1]
    bucket = packed._buckets[packed.tenant("t").bucket]
    assert bucket.pack.captures["segment"] == 1 and bucket.pack.captures["init"] == 1

    delay = FaultyProblem(Ackley(), lane_faults={1: {"delay_generations": (2,), "delay_seconds": 0.001}})
    svc = service(tmp_path / "delay")
    svc.submit(TenantSpec("d", _pack_workflow(cuda, pop=64, dim=8).algorithm, delay, n_steps=9, uid=1))
    with pytest.warns(UserWarning, match="eagerly on the card"):
        svc.run()
    pack = svc._buckets[svc.tenant("d").bucket].pack
    assert pack.captures == {"init": 0, "segment": 0} and svc.result("d").algorithm.pop.is_cuda


def test_prewarm_captures_the_pack_before_its_first_admission(cuda):
    """``prewarm`` captures the init program and each segment length before
    any tenant is admitted; the admissions and segments then replay them
    (no further capture), and the lanes equal eager steps."""
    from evox_tpu_torch.service import TenantPack

    wf = _pack_workflow(cuda, pop=128, dim=16)
    pack = TenantPack(wf, 2, early_stop=False)
    labels = pack.prewarm(_tenant(wf, 7, cuda), [3, 6])
    assert len(labels) == 3 and not any(labels.values())
    assert pack.captures == {"init": 1, "segment": 2}
    for uid in (0, 1):
        s, _, _ = pack.init_tenant(_tenant(wf, uid, cuda))
        pack.admit(s, uid)
    pack.run_segment(3)
    pack.run_segment(6)
    assert pack.captures == {"init": 1, "segment": 2}
    for uid in (0, 1):
        want = wf.init_step(_tenant(wf, uid, cuda))
        for _ in range(9):
            want = wf.step(want)
        _same_state(pack.lane_state(uid), want)


def test_two_worker_fleet_on_one_card(cuda, tmp_path):
    """A 2-worker FleetSupervisor run on ``cuda:0`` (a gloo group: NCCL
    refuses two ranks on one card) through ``tests/test_torch_fleet_worker.py``:
    each worker's rows and moves stay on the card (its launch counters
    moved, its first boundary's move equals the plain version bit for
    bit), no copy between host and card in a profiled segment is larger
    than the gathered fitness (the row blocks never leave the card; gloo
    copies the fitness through the host, and the generation reads a few
    scalars), and the final state equals the same run in this process."""
    import json
    import os
    import sys
    from pathlib import Path

    import numpy as np
    import torch.distributed as dist

    from evox_tpu_torch.parallel import make_pop_mesh
    from evox_tpu_torch.resilience import FleetSupervisor, ResilientRunner, RetryPolicy

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import test_torch_fleet_worker as worker

    cfg = {"n_steps": 8, "pop": 1024, "dim": 32, "bound": 10.0, "checkpoint_every": 2, "seed": 0,
           "problem": "sphere", "device": "cuda", "profile_segment": 1}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    sup = FleetSupervisor(
        lambda spec: [sys.executable, worker.__file__, spec.checkpoint_dir, str(tmp_path / "cfg.json")], 2,
        checkpoint_dir=tmp_path / "fleet", env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1])),
        poll_interval=0.1, dead_after=30.0, start_grace=180.0, attempt_timeout=300.0, obs=False,
    )
    stats = sup.run()
    assert stats.completed and stats.world_sizes == [2], [e.kind for e in stats.events]
    for rank in (0, 1):
        rec = json.loads((tmp_path / "fleet" / f"worker_a00_p{rank:02d}.json").read_text())
        assert rec["group_backend"] == "gloo" and rec["rows_device"] == rec["final_rows_device"] == "cuda:0"
        assert rec["launches"]["fused_pso_move"] == cfg["n_steps"] - 1 and rec["launches"]["philox_draws"] >= 1
        assert rec["move_vs_plain"]["bits_differ"] == 0
        ex = rec["exchange"]
        assert ex["calls"] == cfg["n_steps"] and ex["devices"] == ["cuda:0"]
        # Segment 1 is generations 2-3; its copies, read from the profiler's trace.
        tr = rec["transfers"]
        assert (tr["segment"], tr["generations"]) == (1, 2), tr
        copies = tr["copies"]
        assert copies.get("DtoH") and copies.get("HtoD"), copies
        fitness_bytes = cfg["pop"] * 4
        for direction in ("DtoH", "HtoD"):
            assert max(int(b) for b in copies[direction]) <= fitness_bytes, copies
    fleet = dict(np.load(tmp_path / "fleet" / "final_state.npz"))
    wf, _ = worker.build(cfg, make_pop_mesh(device="cuda"))
    try:
        final = ResilientRunner(wf, tmp_path / "inproc", checkpoint_every=2, retry=RetryPolicy(max_retries=0)).run(
            wf.init(0), n_steps=cfg["n_steps"])
        mine = worker.final_payload(final)
    finally:
        dist.destroy_process_group()
    assert mine.keys() == fleet.keys()
    for k in mine:
        assert np.array_equal(mine[k], fleet[k]), k


def test_capture_record_carries_the_libraries_of_the_capture(cuda, tmp_path):
    """A prewarmed pack's segment entry holds the bytes of the kernel
    libraries loaded for its capture (the batched move's and the setup
    draws'), each under its built name with its own SHA-256; a second pack
    of the bucket loads every program from the cache and still captures."""
    import hashlib

    from evox_tpu_torch.ops import _build
    from evox_tpu_torch.service import TenantPack
    from evox_tpu_torch.utils import ExecutableCache, abstract_signature

    cache = ExecutableCache(tmp_path / "exec")
    wf = _pack_workflow(cuda, pop=128, dim=16)
    pack = TenantPack(wf, 2, early_stop=False)
    labels = pack.prewarm(_tenant(wf, 7, cuda), [3], cache=cache, label="b")
    assert not any(labels.values()) and cache.stats.saves == 2
    built = _build.loaded()
    assert {"pso_move", "philox"} <= set(built)
    other = TenantPack(wf, 2, early_stop=False)
    assert all(other.prewarm(_tenant(wf, 7, cuda), [3], cache=cache, label="b").values())
    assert other.captures == {"init": 1, "segment": 1}
    seg = [k for k in labels if k.startswith("pack_segment")][0]
    post = wf.init_step(_tenant(wf, 7, cuda))
    carry = (_stack_states([post, post]), torch.ones(2, dtype=torch.bool, device=cuda),
             torch.zeros(2, dtype=torch.int32, device=cuda))
    record = cache.load(seg, abstract_signature(carry))
    for name in ("pso_move", "philox"):
        sha, data = record.libraries[built[name].name]
        assert data == built[name].read_bytes() and sha == hashlib.sha256(data).hexdigest()


def test_warm_process_with_an_empty_build_directory_builds_nothing(cuda, tmp_path):
    """A process importing a copy of the package whose ``build/`` is empty
    prewarms a pack from a cache another process filled: every program is
    a hit, the libraries are installed from the entries (no ``nvcc``), the
    capture runs, and its lanes step to the same bits as here."""
    import json
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from evox_tpu_torch.service import TenantPack
    from evox_tpu_torch.utils import ExecutableCache

    repo = Path(__file__).resolve().parents[1]
    cache = ExecutableCache(tmp_path / "exec")
    wf = _pack_workflow(cuda, pop=128, dim=16)
    pack = TenantPack(wf, 2, early_stop=False)
    pack.prewarm(_tenant(wf, 7, cuda), [3], cache=cache, label="b")
    s, _, _ = pack.init_tenant(_tenant(wf, 0, cuda))
    pack.admit(s, 0)
    pack.run_segment(3)
    want = float(pack.lane_state(0).algorithm.global_best_fit)
    shutil.copytree(repo / "evox_tpu_torch", tmp_path / "copy" / "evox_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = f"""
import json, sys, torch
sys.path.insert(0, {str(tmp_path / 'copy')!r}); sys.path.insert(1, {str(repo / 'tests')!r})
from test_torch_cuda import _pack_workflow, _tenant
from evox_tpu_torch.ops import _build
from evox_tpu_torch.service import TenantPack
from evox_tpu_torch.utils import ExecutableCache
cuda = torch.device("cuda")
cache = ExecutableCache({str(tmp_path / 'exec')!r})
wf = _pack_workflow(cuda, pop=128, dim=16)
pack = TenantPack(wf, 2, early_stop=False)
labels = pack.prewarm(_tenant(wf, 7, cuda), [3], cache=cache, label="b")
s, _, _ = pack.init_tenant(_tenant(wf, 0, cuda))
pack.admit(s, 0)
pack.run_segment(3)
print(json.dumps({{"labels": list(labels.values()), "counts": _build.counts, "misses": cache.stats.misses,
                  "captures": pack.captures, "best": float(pack.lane_state(0).algorithm.global_best_fit),
                  "build_dir": str(_build.BUILD_DIR)}}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["build_dir"].startswith(str(tmp_path / "copy"))
    assert all(got["labels"]) and got["misses"] == 0
    assert got["counts"]["builds"] == 0 and got["counts"]["installs"] >= 2, got
    assert got["captures"] == {"init": 1, "segment": 1} and got["best"] == want


# -- the service's HPO workload: packs of nests ---------------------------------------


def _nest_workflow(cuda, kind="es", inner_pop=64, candidates=8, iterations=6, dim=8):
    """A small HPO tenant's workflow: PSO(candidates) over OpenES(inner_pop)
    (``kind="es"``) or CMA-ES(candidates) over PSO(inner_pop), on Sphere."""
    from evox_tpu_torch.algorithms import CMAES, PSO, OpenES
    from evox_tpu_torch.hpo import HPOFitnessMonitor, NestedProblem
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    if kind == "es":
        inner = OpenES(inner_pop, torch.zeros(dim), learning_rate=0.05, noise_stdev=0.1, device=cuda)
        outer = PSO(candidates, lb=1e-3 * torch.ones(2), ub=0.5 * torch.ones(2), device=cuda)
    else:
        inner = PSO(inner_pop, -5.0 * torch.ones(dim), 5.0 * torch.ones(dim), device=cuda)
        outer = CMAES(torch.tensor([0.6, 2.0]), 0.3, pop_size=candidates, device=cuda)
    nested = NestedProblem(StdWorkflow(inner, Sphere(), monitor=HPOFitnessMonitor()), iterations=iterations,
                           num_candidates=candidates)
    return StdWorkflow(outer, nested, solution_transform=_es_transform if kind == "es" else _cma_transform)


# Module level: a daemon's journal pickles a spec's transform by name.
def _es_transform(x):
    return {"algorithm.lr": x[:, 0], "algorithm.noise_stdev": x[:, 1]}


def _cma_transform(x):
    return {"algorithm.w": x[:, 0].clamp(0.1, 1.0), "algorithm.phi_p": x[:, 1].clamp(0.5, 3.0)}


def _counts():
    from evox_tpu_torch.ops import philox, pso_step

    return {"move": pso_step.fused_pso_move_batched.launches, "draws": philox.philox_draws_batched.launches,
            "solo_move": pso_step.fused_pso_move.launches}


@pytest.mark.parametrize("kind", ["es", "cma"])
def test_pack_of_nests_is_one_graph_with_merged_launches(cuda, kind):
    """A pack of HPO tenants: one init and one segment capture, the nests
    inline (no graph of their own), a replay reads the card once and calls
    no wrapper, the capture calls each kernel once an inner generation for
    the whole pack (a warm-up generation and the captured ones), and every
    lane equals its tenant alone in a pack of the same width, bit for bit,
    and (PSO over OpenES) its eager steps outside any pack.  A vmapped
    CMA-ES step differs from a solo one in the last bits (its batched
    products and eigensolver; ``chip_smoke.py``'s ``vmapped_family``
    holds it at a tolerance), so CMA-ES's lanes are held against the same
    width only."""
    from evox_tpu_torch.service import TenantPack

    wf = _nest_workflow(cuda, kind)
    pack = TenantPack(wf, 4, early_stop=False)
    for uid in (0, 1):
        s, _, _ = pack.init_tenant(_tenant(wf, uid, cuda))
        pack.admit(s, uid)
    before = _counts()
    pack.run_segment(3)
    got = {k: v - before[k] for k, v in _counts().items()}
    it = wf.problem.iterations
    want = {"move": 4, "draws": 4 * it, "solo_move": 0} if kind == "es" else \
        {"move": 4 * (it - 1), "draws": 4, "solo_move": 0}
    assert got == want
    before = _counts()
    _, syncs = _syncs(lambda: pack.run_segment(3))
    assert len(syncs) == 1, syncs
    assert _counts() == before
    assert pack.captures == {"init": 1, "segment": 1} and len(wf.problem._graphs) == 0
    for uid in (0, 1):
        alone = TenantPack(wf, 4, early_stop=False)
        s, _, _ = alone.init_tenant(_tenant(wf, uid, cuda))
        alone.admit(s, uid)
        alone.run_segment(3)
        alone.run_segment(3)
        _same_state(pack.lane_state(uid), alone.lane_state(0))
        if kind == "es":
            state = wf.init_step(_tenant(wf, uid, cuda))
            for _ in range(6):
                state = wf.step(state)
            _same_state(pack.lane_state(uid), state)


def test_pack_of_nests_kernels_at_the_merged_shapes(cuda):
    """One generation of a pack's own segment program (4 lanes, 3 tenants
    and a padding lane), run eagerly on a copy of its carry: CMA-ES over PSO
    moves the inner PSO over lanes x candidates instances and draws its
    normals over the lanes; PSO over OpenES moves the outer PSO over the
    lanes and draws OpenES's normals over lanes x candidates streams.  Each
    launch against its plain version, 0 bits off; each tenant's candidate
    with its own scalars and key (the padding lane repeats lane 0)."""
    from evox_tpu_torch.ops import philox, pso_step
    from evox_tpu_torch.service import TenantPack

    moves, draws = [], []
    launch_move, launch_draws = pso_step._launch, philox._launch

    def rec_move(*a):
        out = launch_move(*a)
        moves.append(([x.clone() if hasattr(x, "clone") else x for x in a], [o.clone() for o in out]))
        return out

    def rec_draws(keys, index, derive, numel, codes, lows, spans, solo):
        out = launch_draws(keys, index, derive, numel, codes, lows, spans, solo)
        draws.append((keys.clone(), index, derive, numel, philox._kinds(codes, lows, spans), [o.clone() for o in out]))
        return out

    recorded = {}
    for kind in ("cma", "es"):
        wf = _nest_workflow(cuda, kind)
        pack = TenantPack(wf, 4, early_stop=False)
        for uid in (0, 1, 2):
            s, _, _ = pack.init_tenant(_tenant(wf, uid, cuda))
            pack.admit(s, uid)
        leaves, spec = graph.flatten(pack._states)
        carry = (graph.unflatten(spec, [t.clone() for t in leaves]), pack._frozen_dev.clone(),
                 torch.zeros((4,), dtype=torch.int32, device=cuda))
        moves.clear(), draws.clear()
        pso_step._launch, philox._launch = rec_move, rec_draws
        try:
            pack._segment_program(carry, 1)
        finally:
            pso_step._launch, philox._launch = launch_move, launch_draws
        recorded[kind] = (list(moves), list(draws))
    cma_moves, cma_draws = recorded["cma"]
    assert [tuple(a[0].shape) for a, _ in cma_moves] == [(32, 64, 8)] * 5
    assert [d[0].shape[0] for d in cma_draws] == [4]
    es_moves, es_draws = recorded["es"]
    assert [tuple(a[0].shape) for a, _ in es_moves] == [(4, 8, 2)]
    assert [(d[0].shape[0], d[3]) for d in es_draws] == [(32, 32 * 8)] * 6
    for args, out in cma_moves + es_moves:
        _same_bits(out, pso_step.fused_pso_move_batched_plain(*args[:12]))
    for args, _ in cma_moves:
        assert len({tuple(r) for r in args[8].tolist()}) == 24
    for keys, index, derive, numel, kinds, out in cma_draws + es_draws:
        for g, w in zip(out, philox.philox_draws_batched_plain(keys, index, numel, kinds, derive)):
            assert torch.equal(g, w)
    for keys, *_ in es_draws:
        assert len({tuple(k) for k in keys.tolist()}) == 24


def test_hpo_bucket_prewarm_records_the_move_and_philox(cuda, tmp_path):
    """A daemon prewarming an HPO bucket captures its programs with the nest
    inline, and the segment's record lists the move's and Philox's
    libraries; the tenant then runs to completion with no further
    capture."""
    from evox_tpu_torch.hpo import find_nested
    from evox_tpu_torch.resilience import HealthProbe
    from evox_tpu_torch.service import ServiceDaemon, TenantSpec, TenantStatus

    wf = _nest_workflow(cuda)
    d = ServiceDaemon(tmp_path / "d", lanes_per_pack=2, segment_steps=3, preemption=False, brownout_threshold=None,
                      health=HealthProbe(nonfinite_skip=("instances",)), device=cuda)
    d.start()
    saved = {}
    save = d.exec_cache.save

    def saving(label, signature, program):
        saved[label] = sorted(program.libraries)
        return save(label, signature, program)

    d.exec_cache.save = saving
    d.submit(TenantSpec("meta", wf.algorithm, wf.problem, n_steps=7, uid=3, workload="hpo",
                        solution_transform=wf.solution_transform))
    seg = [k for k in saved if k.startswith("pack_segment")]
    assert len(seg) == 1 and any("pso_move" in n for n in saved[seg[0]]) and any("philox" in n for n in saved[seg[0]])
    assert d.stats.captures == {"init": 1, "segment": 1}
    d.run()
    assert d.tenant("meta").status is TenantStatus.COMPLETED
    assert d.stats.captures == {"init": 1, "segment": 1}
    bucket = next(iter(d.service._buckets.values()))
    assert len(find_nested(bucket.workflow.problem)._graphs) == 0
    d.close()


def _gateway(cuda, root, **kw):
    from evox_tpu_torch.service import Gateway, ServiceDaemon

    daemon = ServiceDaemon(root, lanes_per_pack=2, segment_steps=4, preemption=False, brownout_threshold=None,
                           device=cuda, **kw)
    return daemon, Gateway(daemon, tokens={"tok": "alice"}).start()


def _pso_spec(name, uid, device, dim=8, n_steps=12):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Ackley
    from evox_tpu_torch.service import TenantSpec

    algo = PSO(64, torch.full((dim,), -32.0), torch.full((dim,), 32.0), device=device)
    return TenantSpec(name, algo, Ackley(), n_steps=n_steps, uid=uid)


def test_gateway_result_of_a_card_tenant_returns_its_history(cuda, tmp_path):
    """``GET .../result`` of a tenant on the card: its monitor's history
    rows leave the card under the gateway's lock and come back as JSON,
    equal to the history the daemon holds."""
    from evox_tpu_torch.service import GatewayClient

    daemon, gateway = _gateway(cuda, tmp_path / "svc")
    try:
        client = GatewayClient(gateway.url, "tok")
        client.submit(_pso_spec("t0", 0, cuda))
        gateway.pump()
        doc = client.result("t0", wait=30)
        assert doc["status"] == "completed"
        history = daemon.tenant("alice--t0").monitor.fitness_history
        assert len(doc["fitness_history"]) == doc["generations"] == len(history)
        for row, want in zip(doc["fitness_history"], history):
            assert torch.equal(torch.tensor(row, dtype=want.dtype), want.cpu())
        assert daemon.result("alice--t0").algorithm.pop.device.type == "cuda"
    finally:
        gateway.close()


def test_gateway_submit_decoded_during_a_capture_keeps_it_intact(cuda, tmp_path):
    """A new bucket's programs are captured under the gateway's lock (its
    first submit prewarms them) while another handler thread decodes a
    submit: the second decode is held to happen inside the open capture.
    The capture stays intact, both tenants complete, and each equals the
    same spec submitted through the Python API, bit for bit."""
    import threading

    from evox_tpu_torch.resilience.testing import assert_states_equal
    from evox_tpu_torch.service import Gateway, GatewayClient, ServiceDaemon

    daemon, gateway = _gateway(cuda, tmp_path / "svc")
    capturing, decoded = threading.Event(), threading.Event()
    begin = torch.cuda.CUDAGraph.capture_begin
    decode = Gateway._decode_submit_spec

    def held_capture(self, *a, **k):
        begin(self, *a, **k)
        if not capturing.is_set():
            capturing.set()
            assert decoded.wait(60), "no submit was decoded during the capture"

    def watched_decode(self, payload, device):
        spec = decode(self, payload, device)
        if capturing.is_set() and device.type == "cpu":
            decoded.set()
        return spec

    try:
        client = GatewayClient(gateway.url, "tok")
        client.submit(_pso_spec("a0", 0, "cpu"))  # bucket A: captured here, before the hold
        torch.cuda.CUDAGraph.capture_begin = held_capture
        Gateway._decode_submit_spec = watched_decode
        acks = {}
        new_bucket = threading.Thread(target=lambda: acks.update(b0=client.submit(_pso_spec("b0", 1, "cpu", dim=4))))
        new_bucket.start()
        assert capturing.wait(60)
        acks["a1"] = client.submit(_pso_spec("a1", 2, "cpu"))
        new_bucket.join(120)
        assert decoded.is_set() and set(acks) == {"b0", "a1"}
        gateway.pump()
        ref = ServiceDaemon(tmp_path / "ref", lanes_per_pack=2, segment_steps=4, preemption=False,
                            brownout_threshold=None, device=cuda)
        for name, uid, dim in (("a0", 0, 8), ("b0", 1, 4), ("a1", 2, 8)):
            ref.submit(_pso_spec(f"alice--{name}", uid, cuda, dim=dim))
        ref.run()
        for name in ("a0", "b0", "a1"):
            assert daemon.tenant(f"alice--{name}").status.value == "completed"
            assert_states_equal(ref.result(f"alice--{name}"), daemon.result(f"alice--{name}"), name)
        assert daemon.stats.captures == {"init": 2, "segment": 2}
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        Gateway._decode_submit_spec = decode
        gateway.close()


def test_gateway_cpu_built_spec_runs_on_the_card_like_a_card_built_one(cuda, tmp_path):
    """The same tenant built on the CPU and on the card, each submitted
    over HTTP to a daemon on the card: both run there (the CPU-built
    algorithm's device mapped to the daemon's), bit-equal in final state."""
    from evox_tpu_torch.resilience.testing import assert_states_equal
    from evox_tpu_torch.service import GatewayClient

    results = []
    for tag, device in (("cpu_built", "cpu"), ("card_built", cuda)):
        daemon, gateway = _gateway(cuda, tmp_path / tag)
        try:
            GatewayClient(gateway.url, "tok").submit(_pso_spec("t0", 0, device))
            gateway.pump()
            record = daemon.tenant("alice--t0")
            assert record.spec.algorithm.device.type == "cuda"
            assert record.spec.algorithm.lb.device.type == "cuda"
            results.append(daemon.result("alice--t0"))
        finally:
            gateway.close()
    assert results[0].algorithm.pop.device.type == "cuda"
    assert_states_equal(results[0], results[1], "CPU-built against card-built")


def _router(cuda, root):
    from evox_tpu_torch.service import ServiceMember, TenantRouter

    members = [ServiceMember(i, root / f"m{i}", heartbeat_dir=root / "beats", lanes_per_pack=2, segment_steps=4,
                             preemption=False, brownout_threshold=None, device=cuda) for i in range(2)]
    router = TenantRouter(root / "router", members, fleet_dead_after=300.0, fleet_start_grace=0.0,
                          on_event=lambda msg: None)
    return router, members


def test_router_providers_during_a_capture_keep_it_intact(cuda, tmp_path):
    """``capacity()`` and the router's ``/statusz``, ``/healthz`` and
    ``/metrics`` providers, called from another thread while the serving
    thread holds a capture open (member 1's first bucket, prewarmed by a
    submit), leave the capture valid: they read host state only.  Both
    tenants complete, bit-equal to a daemon's run of the same specs."""
    import threading

    from evox_tpu_torch.resilience.testing import assert_states_equal
    from evox_tpu_torch.service import ServiceDaemon

    router, members = _router(cuda, tmp_path / "fleet")
    begin = torch.cuda.CUDAGraph.capture_begin
    read = {}

    def provide():
        read["capacity"] = [m.capacity() for m in members]
        read["load"] = [m.load() for m in members]
        read["statusz"] = router._statusz()
        read["healthz"] = router._healthz()
        read["metrics"] = router._metrics_text()

    def held_capture(self, *a, **k):
        begin(self, *a, **k)
        if "statusz" not in read:
            reader = threading.Thread(target=provide)
            reader.start()
            reader.join(60)
            assert not reader.is_alive()

    try:
        router.start()
        router.submit(_pso_spec("a0", 0, cuda))  # member 0's bucket, captured before the hold
        router.step()
        torch.cuda.CUDAGraph.capture_begin = held_capture
        router.submit(_pso_spec("b0", 1, cuda, dim=4))  # another bucket: member 1 prewarms it
        torch.cuda.CUDAGraph.capture_begin = begin
        assert router._placements["b0"]["member"] == 1
        assert set(read) == {"capacity", "load", "statusz", "healthz", "metrics"}
        assert read["statusz"]["router"]["placements"] == 2
        router.run()
        ref = ServiceDaemon(tmp_path / "ref", lanes_per_pack=2, segment_steps=4, preemption=False,
                            brownout_threshold=None, device=cuda)
        for name, uid, dim in (("a0", 0, 8), ("b0", 1, 4)):
            ref.submit(_pso_spec(name, uid, cuda, dim=dim))
        ref.run()
        for name in ("a0", "b0"):
            assert router.tenant(name).status.value == "completed"
            assert_states_equal(ref.result(name), router.result(name), name)
        assert members[1].daemon.stats.captures == {"init": 1, "segment": 1}
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        router.close()


def test_router_card_built_and_host_built_specs_share_one_link_blob(cuda, tmp_path):
    """The placement record's spec blob is device-free: the same tenant
    built on the card and on the host gives the same bytes, so a retry
    built on the other side of the host/card line is an idempotent ack
    (one placement, one member submit), either way round; the tenants run
    on the card."""
    from evox_tpu_torch.service import RequestJournal, TenantRouter
    from evox_tpu_torch.service.router import _link_blob

    assert _link_blob(_pso_spec("t0", 0, cuda)) == _link_blob(_pso_spec("t0", 0, "cpu"))
    router, members = _router(cuda, tmp_path)
    try:
        for tid, uid, first, retry in (("t0", 0, cuda, "cpu"), ("t1", 1, "cpu", cuda)):
            acked = router.submit(_pso_spec(tid, uid, first))
            again = router.submit(_pso_spec(tid, uid, retry))
            assert int(acked.uid) == int(again.uid) == uid
        records, _ = RequestJournal(router.root / TenantRouter.JOURNAL_NAME).replay()
        assert [r.data["tenant_id"] for r in records if r.kind == "placement"] == ["t0", "t1"]
        for tid in ("t0", "t1"):
            owner = members[router._placements[tid]["member"]]
            submits = [r for r in RequestJournal(owner.root / "journal.jsonl").replay()[0]
                       if r.kind == "submit" and r.data["tenant_id"] == tid]
            assert len(submits) == 1
        router.run()
        for tid in ("t0", "t1"):
            record = router.tenant(tid)
            assert record.status.value == "completed"
            assert record.spec.algorithm.lb.device.type == "cuda"
    finally:
        router.close()


from pathlib import Path  # noqa: E402


def _chaos_plan():
    from evox_tpu_torch.resilience import ChaosPlan

    return ChaosPlan.from_seed(11, members=3, tenants=8, rounds=7, kills=2, wire=3, disk=2, lanes=1, partitions=1)


def _chaos_conductor(root, device):
    from evox_tpu_torch.resilience import ChaosConductor

    return ChaosConductor(root, _chaos_plan(), device=device, member_kwargs={"on_event": lambda msg: None},
                          router_kwargs={"on_event": lambda msg: None})


def _chaos_cpu_log(root):
    conductor = _chaos_conductor(root, "cpu")
    try:
        report = conductor.run()
    finally:
        conductor.close()
    assert report.violations == [] and report.completed == 8
    return Path(report.event_log).read_bytes()


def test_chaos_acceptance_plan_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    """The JAX chaos suite's acceptance plan with the built-in workload,
    conducted over three members on the card: every tenant completes with
    zero violations, and the event journal equals a CPU run's byte for
    byte."""
    conductor = _chaos_conductor(tmp_path / "card", cuda)
    try:
        report = conductor.run()
        assert {m.daemon.device.type for m in conductor.members.values()} == {"cuda"}
        assert conductor.router.result("c00000").algorithm.pop.device.type == "cuda"
    finally:
        conductor.close()
    assert report.violations == []
    assert (report.completed, report.pending, report.acks) == (8, 0, 8)
    assert Path(report.event_log).read_bytes() == _chaos_cpu_log(tmp_path / "cpu")


def test_chaos_abandoned_members_never_replay_nor_kill_the_rebuilt_ones(cuda, tmp_path):
    """A killed member is abandoned over the same root: none of its
    captured graphs is replayed after the kill, it never steps again, and
    its beat (published after the rebuild) does not make the router declare
    the rebuilt member dead."""
    conductor = _chaos_conductor(tmp_path, cuda)
    replayed, abandoned = [], []
    replay = torch.cuda.CUDAGraph.replay
    kill = conductor._kill_member

    def recording_replay(self):
        replayed.append(id(self))
        return replay(self)

    def abandoning(index):
        old = conductor.members[index]
        graphs = {id(c.graph) for b in old.daemon.service._buckets.values() for c in b.pack._graphs.graphs.values()}
        abandoned.append((old, graphs, len(replayed), old.daemon.service.stats.segments_run))
        kill(index)
        assert conductor.members[index] is not old
        old.beat()

    conductor._kill_member = abandoning
    torch.cuda.CUDAGraph.replay = recording_replay
    try:
        report = conductor.run()
        torch.cuda.CUDAGraph.replay = replay
        assert report.violations == [] and report.completed == 8
        assert len(abandoned) == 2 and all(graphs for _, graphs, _, _ in abandoned)
        for old, graphs, at, segments in abandoned:
            assert not graphs & set(replayed[at:])
            assert old.daemon.service.stats.segments_run == segments
            assert old.heartbeat is None or old.heartbeat._thread is None
            old.beat()
        conductor.router.poll_fleet()
        assert conductor.router._dead == set() and conductor.router._migrations == []
    finally:
        torch.cuda.CUDAGraph.replay = replay
        conductor.close()


def test_chaos_statusz_during_a_capture_keeps_it_intact(cuda, tmp_path):
    """The ``chaos`` section of the router's, a member daemon's and a
    gateway's ``/statusz``, read from another thread while the serving
    thread holds the run's first capture open, leaves the capture valid:
    the run completes with zero violations and the CPU run's event
    journal."""
    import threading

    from evox_tpu_torch.service import Gateway

    conductor = _chaos_conductor(tmp_path / "card", cuda)
    begin = torch.cuda.CUDAGraph.capture_begin
    read = {}

    def provide(gateway):
        read["router"] = conductor.router._statusz()["chaos"]
        read["daemon"] = conductor.members[0].daemon._statusz()["chaos"]
        read["gateway"] = gateway.statusz_payload()["chaos"]
        read["conductor"] = conductor.statusz_payload()

    def held_capture(self, *a, **k):
        if "router" in read:
            return begin(self, *a, **k)
        gateway = Gateway(conductor.members[0].daemon, tokens={"tok": "alice"})
        gateway.chaos = conductor
        begin(self, *a, **k)
        reader = threading.Thread(target=provide, args=(gateway,))
        reader.start()
        reader.join(60)
        assert not reader.is_alive()

    torch.cuda.CUDAGraph.capture_begin = held_capture
    try:
        report = conductor.run()
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        conductor.close()
    assert set(read) == {"router", "daemon", "gateway", "conductor"}
    for payload in read.values():
        assert payload["plan"] == conductor.plan.name and "error" not in payload
    assert report.violations == [] and report.completed == 8
    assert Path(report.event_log).read_bytes() == _chaos_cpu_log(tmp_path / "cpu")
