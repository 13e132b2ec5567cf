"""The port's multi-objective kernels' wrappers (``evox_tpu_torch.ops.topk``,
``ops.crowding``, ``ops.dominance``, ``ops.probe``) against the JAX
package's Pallas kernels run in interpret mode, as
``tests/test_pallas_kernels.py`` runs them, on the same numpy inputs.

On the CPU each wrapper takes its plain PyTorch version; the CUDA kernels
are held against those versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  Every comparison here is exact: ranks,
indices, packed words and counts equal; floats equal bit for bit with NaN
at the same places (no arithmetic differs)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.operators.selection import non_dominate_rank as jrank  # noqa: E402
from evox_tpu.operators.selection.non_dominate import _non_dominate_rank_packed  # noqa: E402
from evox_tpu.operators.selection.non_dominate import _pack_bits  # noqa: E402
from evox_tpu.operators.selection.non_dominate import dominate_relation as jrelation  # noqa: E402
from evox_tpu.ops.crowding import crowding_distance_pallas as jcrowding  # noqa: E402
from evox_tpu.ops.crowding import crowding_neighbors as jneighbors  # noqa: E402
from evox_tpu.ops.dominance import dominance_matrix as jdominance  # noqa: E402
from evox_tpu.ops.topk import lex_rank as jlex_rank  # noqa: E402
from evox_tpu.ops.topk import masked_top_k as jtop_k  # noqa: E402
from evox_tpu_torch.ops import crowding, dominance, probe, topk  # noqa: E402


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.tobytes(), np.where(np.isnan(want), got, want).tobytes())


def _costs(seed, n, m, specials=True):
    """Quantized values (heavy ties), with ±inf and NaN rows when asked."""
    r = np.random.default_rng(seed)
    f = (np.round(r.uniform(0, 1, (n, m)) * 8) / 8).astype(np.float32)
    if specials and n > 8:
        f[3, 0] = np.inf
        f[5, m - 1] = -np.inf
        f[7] = np.nan
        f[n - 2, 0] = np.nan
    return f


def _mask(seed, n, kind):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        m = np.zeros(n, bool)
        m[n // 2] = True
        return m
    return np.random.default_rng(seed + 1).uniform(0, 1, n) > 0.35


# ---------------------------------------------------------------------------
# lex_rank / masked_top_k
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 33, 129, 256])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_lex_rank_matches_pallas(n, dtype):
    r = np.random.default_rng(n)
    if dtype == "int32":
        v = r.integers(0, 7, n).astype(np.int32)
    else:
        v = (np.round(r.uniform(-1, 1, n) * 4) / 4).astype(np.float32)
        v[::9] = np.nan
        v[1::10] = np.inf
        v[2::11] = -0.0
    got = topk.lex_rank(torch.from_numpy(v))
    want = jlex_rank(jnp.asarray(v), block_size=32, interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(topk.lex_rank_plain(torch.from_numpy(v)).numpy(), got.numpy())


@pytest.mark.parametrize("n", [17, 64, 129])
@pytest.mark.parametrize("mask_kind", ["all", "random", "one"])
def test_masked_top_k_matches_pallas(n, mask_kind):
    r = np.random.default_rng(n)
    v = (np.round(r.uniform(0, 1, n) * 8) / 8).astype(np.float32)
    v[::6] = np.nan
    v[1::9] = np.inf
    mask = _mask(n, n, mask_kind)
    for k in sorted({1, 5, n // 2, n}):
        gv, gi = topk.masked_top_k(torch.from_numpy(v), k, torch.from_numpy(mask))
        ev, ei = jtop_k(jnp.asarray(v), k, jnp.asarray(mask), block_size=32, interpret=True)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
        _bits_equal(gv.numpy(), ev)
        pv, pi = topk.masked_top_k_plain(torch.from_numpy(v), k, torch.from_numpy(mask))
        np.testing.assert_array_equal(pi.numpy(), gi.numpy())


def test_masked_top_k_of_int_ranks_and_refusals():
    ranks = np.random.default_rng(3).integers(0, 7, 200).astype(np.int32)
    for k in (1, 100, 200):
        gv, gi = topk.masked_top_k(torch.from_numpy(ranks), k)
        ev, ei = jtop_k(jnp.asarray(ranks), k, block_size=32, interpret=True)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ei))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(ev))
        assert int(gv[-1]) == int(-jax.lax.top_k(-jnp.asarray(ranks), k)[0][-1])
    with pytest.raises(ValueError, match="k must be"):
        topk.masked_top_k(torch.arange(8.0), 0)
    with pytest.raises(ValueError, match="k must be"):
        topk.masked_top_k(torch.arange(8.0), 9)
    with pytest.raises(ValueError):
        topk.lex_rank(torch.zeros((2, 2)))


# ---------------------------------------------------------------------------
# crowding neighbours and distance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m", [(1, 2), (2, 3), (33, 3), (130, 2), (256, 3)])
@pytest.mark.parametrize("mask_kind", ["all", "random", "one", "none"])
def test_crowding_neighbors_match_pallas(n, m, mask_kind):
    f = _costs(n * 10 + m, n, m)
    mask = _mask(n, n, mask_kind)
    got = crowding.crowding_neighbors(torch.from_numpy(f), torch.from_numpy(mask))
    want = jneighbors(jnp.asarray(f), jnp.asarray(mask), block_size=32, interpret=True)
    for g, w in zip(got, want):
        assert g.shape == (n, m) and g.dtype == torch.float32
        _bits_equal(g.numpy(), w)


@pytest.mark.parametrize("n,m", [(1, 2), (2, 3), (33, 3), (130, 2), (256, 3)])
@pytest.mark.parametrize("mask_kind", ["all", "random", "one", "none"])
def test_crowding_distance_kernel_route_matches_pallas_and_sort_route(n, m, mask_kind):
    f = _costs(n * 7 + m, n, m)
    mask = _mask(n, n, mask_kind)
    tf, tm = torch.from_numpy(f), torch.from_numpy(mask)
    got = crowding.crowding_distance_kernel(tf, tm)
    want = jcrowding(jnp.asarray(f), jnp.asarray(mask), block_size=32, interpret=True)
    _bits_equal(got.numpy(), want)
    _bits_equal(crowding.crowding_distance_plain(tf, tm).numpy(), got.numpy())


def test_crowding_real_inf_and_nan_cases():
    """The cases ``tests/test_pallas_kernels.py`` pins: real ±inf
    neighbours take the arithmetic path, NaN rows sort last."""
    cases = [
        [[1.0, 0.5], [2.0, np.inf], [np.inf, 0.25], [3.0, -np.inf]],
        [[0.0], [np.nan], [2.0], [1.0]],
        [[np.nan], [np.nan], [1.0], [0.0]],
        [[1.0, 0.5], [np.inf, np.nan], [np.nan, 0.25], [3.0, 2.0]],
    ]
    for c in cases:
        f = np.asarray(c, np.float32)
        got = crowding.crowding_distance_kernel(torch.from_numpy(f))
        _bits_equal(got.numpy(), jcrowding(jnp.asarray(f), block_size=2, interpret=True))
    f = np.asarray([[0.0], [np.nan], [2.0], [np.nan], [1.0]], np.float32)
    mask = np.asarray([True, False, True, True, True])
    got = crowding.crowding_distance_kernel(torch.from_numpy(f), torch.from_numpy(mask))
    _bits_equal(got.numpy(), jcrowding(jnp.asarray(f), jnp.asarray(mask), block_size=2, interpret=True))


def test_crowding_neighbors_refuses_other_dtypes():
    with pytest.raises(TypeError):
        crowding.crowding_neighbors(torch.zeros((4, 2), dtype=torch.float64), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError):
        crowding.crowding_neighbors(torch.zeros((4, 2)), torch.ones(3, dtype=torch.bool))


# ---------------------------------------------------------------------------
# The radix kernels' design (csrc/radix_sort.cuh), mirrored in PyTorch: the
# order keys, a stable LSD radix sort of them, and the valid-row scans
# reproduce the Pallas kernels (bit for bit but for the sign of a zero
# neighbour value, below).  The kernels rest on this.
# ---------------------------------------------------------------------------


def _radix_order(keys):
    """Stable order of int64 keys in ``[0, 2^32)`` as the kernels compute
    it: 8-bit digits from the least significant; a pass runs only where
    byte p of AND ^ OR over all keys is non-zero (else pass 0 alone); each
    pass places an item at its digit's exclusive histogram scan plus the
    number of earlier items (in the current order) with its digit."""
    n = keys.shape[0]
    order = torch.arange(n)
    bits = (keys[:, None] >> torch.arange(32)) & 1
    weight = 2 ** torch.arange(32, dtype=torch.int64)
    diff = int((bits.all(0).to(torch.int64) * weight).sum()) ^ int((bits.any(0).to(torch.int64) * weight).sum())
    passes = [p for p in range(4) if (diff >> (8 * p)) & 0xFF] or [0]
    for p in passes:
        d = (keys[order] >> (8 * p)) & 0xFF
        count = torch.bincount(d, minlength=256)
        base = torch.cumsum(count, 0) - count
        onehot = torch.nn.functional.one_hot(d, 256)
        earlier = (torch.cumsum(onehot, 0) - onehot).gather(1, d[:, None])[:, 0]
        place = base[d] + earlier
        new = torch.empty_like(order)
        new[place] = order
        order = new
    return order


def _scan_neighbors(order, valid):
    """Rows before and after each sorted place among the valid ones (-1:
    none): an exclusive forward scan carrying the last valid row seen, and
    the same scan backward."""
    n = order.shape[0]
    at = torch.arange(n)
    valid = valid[order]
    last = torch.cummax(torch.where(valid, at, -1), 0).values
    before = torch.cat([torch.tensor([-1]), last[:-1]])
    first = torch.flip(torch.cummin(torch.flip(torch.where(valid, at, n), [0]), 0).values, [0])
    after = torch.cat([first[1:], torch.tensor([n])])
    pred = torch.where(before >= 0, order[before.clamp(min=0)], -1)
    succ = torch.where(after < n, order[after.clamp(max=n - 1)], -1)
    return pred, succ


def _sort_values(seed, n, kind):
    r = np.random.default_rng(seed)
    if kind == "int_ties":
        return r.integers(0, 7, n).astype(np.int32)
    if kind == "int_wide":
        return r.integers(-(2**31), 2**31, n).astype(np.int32)
    if kind == "equal":
        return np.full(n, 0.375, np.float32)
    if kind == "nan":
        return np.full(n, np.nan, np.float32)
    if kind == "zeros":
        return np.where(r.uniform(0, 1, n) > 0.5, -0.0, 0.0).astype(np.float32)
    v = (np.round(r.uniform(-1, 1, n) * 4) / 4).astype(np.float32)
    v[::9] = np.nan
    v[1::10] = np.inf
    v[3::10] = -np.inf
    v[2::11] = -0.0
    return v


@pytest.mark.parametrize("n", [1, 2, 33, 130])
@pytest.mark.parametrize("kind", ["mixed", "zeros", "equal", "nan", "int_ties", "int_wide"])
def test_radix_order_reproduces_pallas_lex_rank(n, kind):
    v = _sort_values(n * 13 + len(kind), n, kind)
    order = _radix_order(crowding.order_key(torch.from_numpy(v)))
    rank = torch.empty(n, dtype=torch.int64)
    rank[order] = torch.arange(n)
    want = jlex_rank(jnp.asarray(v), block_size=32, interpret=True)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 33, 130])
@pytest.mark.parametrize("kind", ["mixed", "zeros", "equal", "nan"])
@pytest.mark.parametrize("mask_kind", ["all", "random", "one", "none"])
def test_radix_order_and_scans_reproduce_pallas_crowding_neighbors(n, kind, mask_kind):
    m = 2
    f = np.stack([_sort_values(n + len(kind), n, kind), _costs(n, n, 1)[:, 0]], 1)
    mask = _mask(n, n, mask_kind)
    tf = torch.from_numpy(f)
    keys = crowding.order_key(tf)
    below, above = torch.empty(n, m), torch.empty(n, m)
    has_below, has_above = torch.empty(n, m), torch.empty(n, m)
    for k in range(m):
        order = _radix_order(keys[:, k])
        pred, succ = _scan_neighbors(order, torch.from_numpy(mask))
        # pred/succ are per sorted place; the outputs are per row.
        below[order, k] = torch.where(pred >= 0, tf[pred.clamp(min=0), k], float("-inf"))
        above[order, k] = torch.where(succ >= 0, tf[succ.clamp(min=0), k], float("inf"))
        has_below[order, k] = (pred >= 0).float()
        has_above[order, k] = (succ >= 0).float()
    got = (below, above, has_below, has_above)
    # Bit for bit against the port's plain version, which reads each
    # neighbour's value by its row as the kernels do.
    for g, w in zip(got, crowding.crowding_neighbors_plain(tf, torch.from_numpy(mask))):
        _bits_equal(g.numpy(), w.numpy())
    # Against the Pallas kernel: flags bit for bit; values equal, NaN at the
    # same places.  Its value accumulators fold candidates with max / min,
    # so where -0.0 and +0.0 tie it may give the other zero; the sort route
    # of non_dominate.crowding_distance reads the neighbour's own value, as
    # the design does.
    want = [np.asarray(w) for w in jneighbors(jnp.asarray(f), jnp.asarray(mask), block_size=32, interpret=True)]
    for g, w in zip(got[2:], want[2:]):
        _bits_equal(g.numpy(), w)
    for g, w in zip(got[:2], want[:2]):
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g[~np.isnan(w)], w[~np.isnan(w)])


def test_order_key_map():
    """float32: NaN on top, -0.0 with +0.0, order kept; int32: the sign bit
    flipped; other dtypes refused."""
    f = torch.tensor([float("-inf"), -1.5, -0.0, 0.0, 1e-45, 2.0, float("inf"), float("nan")])
    k = crowding.order_key(f).tolist()
    assert k[2] == k[3] and k[-1] == 2**32 - 1 and k[:3] + k[4:] == sorted(k[:3] + k[4:])
    i = torch.tensor([-(2**31), -1, 0, 2**31 - 1], dtype=torch.int32)
    assert crowding.order_key(i).tolist() == [0, 2**31 - 1, 2**31, 2**32 - 1]
    with pytest.raises(TypeError):
        crowding.order_key(torch.zeros(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# dominance: matrix, packed words, peel counts
# ---------------------------------------------------------------------------


def _jax_words(f):
    """The packed words of ``non_dominate.py:141-156``, built with the JAX
    package's own ``dominate_relation`` and ``_pack_bits``."""
    n, _ = f.shape
    nw = -(-n // 32)
    fp = jnp.pad(jnp.asarray(f), ((0, nw * 32 - n), (0, 0)), constant_values=jnp.inf)
    words = [
        _pack_bits(jrelation(fp[w * 32 : w * 32 + 32], jnp.asarray(f))) for w in range(nw)
    ]
    return np.asarray(jnp.stack(words)).view(np.int32)


@pytest.mark.parametrize("n,m", [(1, 2), (2, 3), (33, 3), (100, 2), (256, 3)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dominance_matrix_and_words_match_jax(n, m, dtype):
    f = _costs(n + m, n, m).astype(dtype)
    tf = torch.from_numpy(f)
    want = np.asarray(jdominance(jnp.asarray(f), block_size=32, interpret=True))
    np.testing.assert_array_equal(dominance.dominance_matrix(tf).numpy(), want)
    if dtype == "float32":
        np.testing.assert_array_equal(dominance.dominance_packed(tf).numpy(), _jax_words(f))
    # The words unpack to the matrix.
    words = dominance.dominance_packed(tf).numpy().view(np.uint32)
    bits = (words[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    np.testing.assert_array_equal(bits.reshape(-1, n)[:n].astype(bool), want)


def test_nan_rows_dominate_nothing_and_are_dominated_by_nothing():
    f = np.asarray([[0.0, 0.0], [np.nan, 5.0], [1.0, 1.0], [5.0, np.nan]], np.float32)
    a = dominance.dominance_matrix(torch.from_numpy(f)).numpy()
    assert not a[1].any() and not a[:, 1].any() and not a[3].any() and not a[:, 3].any()
    assert a[0, 2] and not a[2, 0]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 200])
def test_peel_count_matches_numpy_popcount(n):
    f = _costs(n, n, 3, specials=False)
    words = dominance.dominance_packed(torch.from_numpy(f))
    mat = dominance.dominance_matrix_plain(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(dominance.peel_count_plain(words).numpy(), mat.sum(0))
    front = np.random.default_rng(n).uniform(0, 1, n) > 0.5
    got = dominance.peel_count_plain(words, torch.from_numpy(front))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), (mat & front[:, None]).sum(0))


# ---------------------------------------------------------------------------
# peel_fronts: the whole front peel over the packed words
# ---------------------------------------------------------------------------


def _until(kind, n):
    return {"none": None, "one": 1, "half": n // 2, "all": n}[kind]


def _peel_costs(n):
    """Tie-heavy objectives with ±inf entries and NaN rows (n > 8), and a
    chain of strictly improving rows so that some fronts hold one row."""
    f = _costs(n * 5 + 1, n, 3)
    if n > 20:
        f[10:20] = (np.arange(10, dtype=np.float32)[:, None] / 16 - 1.0) * np.ones(3, np.float32)
    return f


@pytest.mark.parametrize("n", [1, 31, 32, 33, 200])
@pytest.mark.parametrize("until", ["none", "one", "half", "all"])
def test_peel_fronts_plain_matches_both_jax_routes(n, until):
    """The plain peel on the packed words equals JAX's packed route and its
    unpacked while loop (the route it takes below 2048 rows), rank for rank,
    the sentinel n included."""
    f = _peel_costs(n)
    u = _until(until, n)
    words = dominance.dominance_packed(torch.from_numpy(f))
    got = dominance.peel_fronts_plain(words, u)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_non_dominate_rank_packed(jnp.asarray(f), u)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jrank(jnp.asarray(f), until_count=u)))
    np.testing.assert_array_equal(dominance.peel_fronts(words, u).numpy(), got.numpy())


def test_peel_fronts_until_count_edges():
    """A count at or below 0 ranks nothing; one above n ranks every front,
    as ``None`` does; the front crossing the count is ranked whole."""
    f = _peel_costs(200)
    words = dominance.dominance_packed(torch.from_numpy(f))
    full = dominance.peel_fronts(words)
    assert torch.equal(dominance.peel_fronts(words, 0), torch.full((200,), 200, dtype=torch.int32))
    assert torch.equal(dominance.peel_fronts(words, -3), torch.full((200,), 200, dtype=torch.int32))
    assert torch.equal(dominance.peel_fronts(words, 10**12), full)
    first = int((full == 0).sum())
    assert torch.equal(dominance.peel_fronts(words, first), torch.where(full == 0, 0, 200).to(torch.int32))
    crossing = dominance.peel_fronts(words, first + 1)
    assert int(crossing.max()) == 200 and torch.equal(crossing[full <= 1], full[full <= 1])


# The peel kernel's host plan and its algorithm: the CUDA kernel itself is
# held against peel_fronts_plain on the card (tests/test_torch_cuda.py).


@pytest.mark.parametrize("n,ptr,vec", [(20_000, 0, 4), (20_000, 8, 2), (20_000, 4, 1), (20_002, 0, 2),
                                       (20_001, 0, 1), (132, 0, 4), (130, 16, 2), (33, 0, 1), (1, 0, 1)])
def test_peel_plan_load_width(n, ptr, vec):
    """The widest load (4, 2, 1 words) that divides n and to whose bytes
    the words are aligned."""
    assert dominance._peel_plan(n, ptr, 132, lambda v, b, t: 1).vec == vec


@pytest.mark.parametrize("n", [1, 33, 2049, 4224, 4225, 20_000, 100_000])
@pytest.mark.parametrize("sms,per_sm", [(132, 1), (132, 2), (8, 1)])
def test_peel_plan_grid_is_resident_and_splits_the_tiles_evenly(n, sms, per_sm):
    nw = -(-n // 32)
    plan = dominance._peel_plan(n, 0, sms, lambda v, b, t: per_sm)
    assert plan.blocks == min(nw, sms) <= sms * per_sm
    assert plan.threads == (1024 if nw >= dominance._PEEL_WIDE_WORDS else 256)
    tiles = dominance._peel_tiles(nw, plan.blocks)
    assert tiles[0][0] == 0 and tiles[-1][1] == nw
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    sizes = [t1 - t0 for t0, t1 in tiles]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_peel_plan_refuses_a_grid_that_does_not_fit():
    with pytest.raises(RuntimeError):
        dominance._peel_plan(20_000, 0, 132, lambda v, b, t: 0)


def _peel_model(words, until, blocks, seed=0):
    """The kernel's algorithm on the host: blocks own whole tiles and
    publish each front as dense mask words into one of two buffers that
    start as garbage and are never cleared; phase 0 writes front 0's ranks
    and the sentinel; each iteration starts with a grid barrier, reads the
    front's size from its words and stops at an empty front or once
    ``until`` rows are ranked.  Returns the ranks and the barriers."""
    nw, n = words.shape
    u = -1 if until is None else min(max(until, 0), n + 1)
    rank = np.full(n, -7, np.int64)
    if u == 0:
        rank[:] = n
        return rank, 0
    w = words.numpy().view(np.uint32)
    dom = ((w[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1).reshape(nw * 32, n)[:n]
    count = dom.sum(0).astype(np.int64)
    masks = np.random.default_rng(seed).integers(0, 2**32, (2, nw), dtype=np.uint64).astype(np.uint32)
    tiles = dominance._peel_tiles(nw, blocks)

    def publish(buf, front, first):
        for t0, t1 in tiles:
            for t in range(t0, t1):
                j = np.arange(32 * t, min(32 * t + 32, n))
                flags = count[j] == 0
                masks[buf, t] = int(np.sum(flags.astype(np.uint64) << (j - 32 * t).astype(np.uint64)))
                rank[j[flags]] = front
                if first:
                    rank[j[~flags]] = n

    publish(0, 0, True)
    barriers = assigned = k = 0
    while True:
        barriers += 1
        cur = masks[k & 1]
        front = ((cur[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)[:n].astype(bool)
        size = int(front.sum())
        if size == 0:
            break
        assigned += size
        if u > 0 and assigned >= u:
            break
        count = np.where(count > 0, count - dom[front].sum(0), -1)
        publish((k + 1) & 1, k + 1, False)
        k += 1
    return rank, barriers


@pytest.mark.parametrize("n", [1, 31, 33, 200])
@pytest.mark.parametrize("until", ["none", "zero", "one", "half", "all", "over"])
@pytest.mark.parametrize("blocks", [1, 2, 5])
def test_peel_kernel_algorithm_matches_the_plain_peel(n, until, blocks):
    """Ranks equal the plain peel's, every column written; a barrier a
    front, and one only when front 0 reaches ``until``."""
    words = dominance.dominance_packed(torch.from_numpy(_peel_costs(n)))
    u = {"none": None, "zero": 0, "one": 1, "half": n // 2, "all": n, "over": n + 1}[until]
    blocks = min(blocks, -(-n // 32))
    rank, barriers = _peel_model(words, u, blocks)
    want = dominance.peel_fronts_plain(words, u)
    np.testing.assert_array_equal(rank, want.numpy())
    fronts = int(want[want < n].max()) + 1 if bool((want < n).any()) else 0
    first = int((want == 0).sum())
    if u == 0:
        assert barriers == 0
    elif u is not None and first >= u:
        assert barriers == 1
    else:
        assert barriers <= fronts + 1


def test_peel_kernel_algorithm_peels_a_total_order_a_barrier_a_front():
    n = 64
    order = np.random.default_rng(1).permutation(n).astype(np.float32)
    words = dominance.dominance_packed(torch.from_numpy(np.stack([order, order], 1)))
    rank, barriers = _peel_model(words, None, 2)
    np.testing.assert_array_equal(rank, order.astype(np.int64))
    assert barriers == n + 1


def test_cpu_wrappers_count_no_launches():
    before = (topk.lex_rank.launches, crowding.crowding_neighbors.launches,
              dominance.dominance_packed.launches,
              dominance.peel_fronts.launches,
              dominance.dominance_matrix.launches, probe.scale_by_two.launches)
    f = torch.from_numpy(_costs(1, 40, 3))
    dominance.peel_fronts(dominance.dominance_packed(f), 20)
    dominance.dominance_matrix(f)
    crowding.crowding_neighbors(f, torch.ones(40, dtype=torch.bool))
    topk.lex_rank(f[:, 0])
    probe.scale_by_two(f)
    after = (topk.lex_rank.launches, crowding.crowding_neighbors.launches,
             dominance.dominance_packed.launches,
             dominance.peel_fronts.launches,
             dominance.dominance_matrix.launches, probe.scale_by_two.launches)
    assert after == before


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------


def test_probe_plain_version_and_cpu_refusal():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(probe.scale_by_two(x), 2 * x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            probe.run_capability_probe()
    with pytest.raises(RuntimeError):
        probe.run_capability_probe("cpu")
