"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no CUDA card.  On a machine with
one (no JAX needed there, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from evox_tpu_torch.ops.pso_step import fused_pso_move, fused_pso_move_plain  # noqa: E402

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


@pytest.mark.parametrize("rand", ["input", "hw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(100, 37), (64, 128), (30, 5), (64, 384)])
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
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


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
    front = torch.rand(n, device=cuda) > 0.5
    _same(dominance.peel_count(words), dominance.peel_count_plain(words))
    _same(dominance.peel_count(words, front), dominance.peel_count_plain(words, front))


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
    with pytest.raises(ValueError):
        dominance.peel_count(words, torch.ones(64, dtype=torch.bool))  # front on the CPU
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
