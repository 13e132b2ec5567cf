"""The port's random streams with device-resident keys
(``evox_tpu_torch/utils/rng.py``, ``ops/philox.py``).

The oracle is the earlier stream, whose keys were read on the host: a copy
of its splitmix64 child derivation in Python integers, and Philox through
``rng.philox4x32`` with the seed as an integer (held against Random123's
known answers in ``tests/test_torch_core.py``).  Every key, child seed and
draw of the device-key stream must equal it bit for bit, for seeds at and
above 2^63 too.  The draw kernel itself is held against
``philox_draws_plain`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest
import torch

from evox_tpu_torch.algorithms import NSGA2, PSO
from evox_tpu_torch.metrics import hv
from evox_tpu_torch.operators.crossover import sbx as sbx_mod
from evox_tpu_torch.operators.mutation import pm_mutation as pm_mod
from evox_tpu_torch.ops import philox
from evox_tpu_torch.ops.pso_step import fused_pso_move_plain
from evox_tpu_torch.utils import rng
from evox_tpu_torch.utils.convert import state_from_numpy

# The module (the package re-exports a function of the same name).
ts_mod = importlib.import_module("evox_tpu_torch.operators.selection.tournament_selection")

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
SEEDS = [0, 7, 2**63 - 1, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15, 12345678901234567890]


# -- the earlier (host-key) stream -------------------------------------------


def old_splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def old_children(seed: int, counter: int, num: int) -> list[int]:
    return [old_splitmix64((seed & M64) ^ old_splitmix64(counter + i)) for i in range(num)]


def old_words(seed: int, numel: int) -> list[torch.Tensor]:
    idx = torch.arange(numel, dtype=torch.int64)
    zero = torch.zeros_like(idx)
    return rng.philox4x32((idx & M32, idx >> 32, zero, zero), seed)


def old_uniform(seed: int, shape, dtype) -> torch.Tensor:
    n = int(np.prod(shape))
    return rng.uniform_bits(old_words(seed, n)[0], dtype).reshape(shape)


def u64(t) -> int:
    return int(t) & M64


def key_pair(k) -> tuple[int, int]:
    s, c = k.tolist()
    return s & M64, c


# -- keys and child seeds -------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain_matches_the_host_key_stream(seed):
    k = rng.key(seed)
    assert k.dtype == torch.int64 and k.shape == (2,) and key_pair(k) == (seed & M64, 0)
    counter = 0
    for num in (1, 3, 2):
        k, seeds = rng.split(k, num)
        want = old_children(seed, counter, num)
        counter += num
        assert [u64(rng.seed_value(s)) for s in seeds] == want
        assert key_pair(k) == (seed & M64, counter)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_keys_match_the_host_key_stream(seed):
    k, _ = rng.split(rng.key(seed), 5)
    keys = rng.split_keys(k, 4)
    assert [key_pair(c) for c in keys] == [(c, 0) for c in old_children(seed, 5, 4)]
    assert all(c.device == k.device and c.dtype == torch.int64 and c.shape == (2,) for c in keys)


def test_split_never_reads_the_key_on_the_host():
    """On the meta device any read of a value raises; split, split_keys,
    child and seed_value still work there, so none reads the key."""
    k = torch.empty((2,), dtype=torch.int64, device="meta")
    with pytest.raises((NotImplementedError, RuntimeError)):
        k.tolist()
    k2, seeds = rng.split(k, 3)
    assert k2.device.type == "meta" and k2.shape == (2,)
    keys = rng.split_keys(k2, 4)
    assert len(keys) == 4 and all(c.device.type == "meta" for c in keys)
    assert rng.seed_value(seeds[2]).device.type == "meta"
    assert rng.seed_value(rng.child(keys[0], 1)).shape == ()


def test_keys_are_checked_without_reading_them():
    for bad in (torch.tensor([1, 2], dtype=torch.int32), torch.zeros(3, dtype=torch.int64), 5):
        with pytest.raises(ValueError):
            rng.split(bad)
    with pytest.raises(ValueError):
        rng.split_keys(torch.zeros((2, 2), dtype=torch.int64), 2)


# -- draws ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 2**63 + 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64, torch.float16])
def test_uniform_from_a_seed_matches_the_host_key_stream(seed, dtype):
    k, (s0, s1) = rng.split(rng.key(seed), 2)
    c0, c1 = old_children(seed, 0, 2)
    for s, c in ((s0, c0), (s1, c1)):
        got = rng.uniform(s, (37, 5), dtype, device="cpu")
        assert got.dtype == dtype and torch.equal(got, old_uniform(c, (37, 5), dtype))
    # An integer seed is the Philox key itself, as before.
    assert torch.equal(rng.uniform(c0, (9,), dtype, device="cpu"), old_uniform(c0, (9,), dtype))


@pytest.mark.parametrize("low,high", [(0, 2), (-3, 9), (0, 20_000), (5, 5 + 2**31)])
def test_randint_from_a_seed_matches_the_host_key_stream(low, high):
    seed = 2**64 - 5
    got = rng.randint(rng.child(rng.key(seed)), (300, 2), low, high, device="cpu")
    word = old_words(old_children(seed, 0, 1)[0], 600)[0]
    assert got.dtype == torch.int64 and torch.equal(got, (low + ((word * (high - low)) >> 32)).reshape(300, 2))
    assert int(got.min()) >= low and int(got.max()) < high


@pytest.mark.parametrize("kinds", [
    [torch.float32],
    [torch.float32, (0, 2), torch.float32, torch.float32],
    [torch.bfloat16, torch.bfloat16],
    [torch.float64, (-7, 1000), torch.float16],
])
def test_philox_draws_plain_takes_one_word_per_output(kinds):
    seed = rng.child(rng.key(2**63 + 1), 2)
    out = philox.philox_draws(seed, 1001, kinds, "cpu")
    words = old_words(old_children(2**63 + 1, 0, 3)[2], 1001)
    assert len(out) == len(kinds)
    for got, kind, word in zip(out, kinds, words):
        want = rng.randint_bits(word, *kind) if isinstance(kind, tuple) else rng.uniform_bits(word, kind)
        assert got.dtype == want.dtype and got.shape == (1001,) and torch.equal(got, want)


def test_philox_draws_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        philox.philox_draws(1, 10, [], "cpu")
    with pytest.raises(ValueError):
        philox.philox_draws(1, 10, [torch.float32] * 5, "cpu")
    with pytest.raises(TypeError):
        philox.philox_draws(1, 10, [torch.int32], "cpu")
    with pytest.raises(ValueError):
        philox.philox_draws(1, 10, [(3, 3)], "cpu")
    with pytest.raises(ValueError):
        philox.philox_draws(1, 10, [torch.float32], "meta")


def test_cpu_draws_count_no_launches():
    before = philox.philox_draws.launches
    rng.uniform(rng.child(rng.key(1)), (10,), device="cpu")
    sbx_mod.sbx_draws(rng.key(2), (4, 3), torch.float32, "cpu")
    assert philox.philox_draws.launches == before


# -- every operator's draws ---------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2**63 + 5])
def test_operator_draws_match_the_host_key_stream(seed):
    k = rng.key(seed)
    c = old_children(seed, 0, 1)[0]
    w = old_words(c, 6 * 4)
    mu, direction, p1, p2 = sbx_mod.sbx_draws(k, (6, 4), torch.float32, "cpu")
    assert torch.equal(mu, rng.uniform_bits(w[0], torch.float32).reshape(6, 4))
    assert direction.dtype == torch.int64 and torch.equal(direction, rng.randint_bits(w[1], 0, 2).reshape(6, 4))
    assert torch.equal(p1, rng.uniform_bits(w[2], torch.float32).reshape(6, 4))
    assert torch.equal(p2, rng.uniform_bits(w[3], torch.float32).reshape(6, 4))
    site, mu2 = pm_mod.pm_draws(k, (6, 4), torch.float32, "cpu")
    assert torch.equal(site, rng.uniform_bits(w[0], torch.float32).reshape(6, 4))
    assert torch.equal(mu2, rng.uniform_bits(w[1], torch.float32).reshape(6, 4))
    cand = ts_mod._candidates(k, 12, 2, 50, "cpu", None)
    assert torch.equal(cand, rng.randint_bits(old_words(c, 24)[0], 0, 50).reshape(12, 2))
    objs = torch.tensor([[0.5, 0.25], [0.1, 0.9]])
    ref = torch.tensor([1.0, 1.0])
    samples = old_uniform(c, (2000, 2), torch.float32) * torch.amax(torch.abs(objs - ref), dim=0)
    inside = torch.any(torch.all(samples[:, None, :] < torch.abs(objs - ref)[None], dim=2), dim=1)
    want_hv = torch.sum(inside) / 2000 * torch.prod(torch.amax(torch.abs(objs - ref), dim=0))
    assert torch.equal(hv(k, objs, ref, num_sample=2000), want_hv)


@pytest.mark.parametrize("seed", [42, 2**64 - 2])
def test_pso_setup_and_move_draws_match_the_host_key_stream(seed):
    n, d = 8, 5
    algo = PSO(n, -2 * torch.ones(d), 2 * torch.ones(d), device="cpu")
    state = algo.setup(rng.key(seed))
    pop_seed, v_seed = old_children(seed, 0, 2)
    assert torch.equal(state.pop, old_uniform(pop_seed, (n, d), torch.float32) * 4.0 - 2.0)
    assert torch.equal(state.velocity, (old_uniform(v_seed, (n, d), torch.float32) * 2.0 - 1.0) * 4.0)
    assert key_pair(state.key) == (seed & M64, 2)
    # The step's move: child 0 of the state's key, drawn in the plain move.
    key, (s,) = rng.split(state.key)
    args = (state.pop, state.velocity, state.pop, torch.zeros(n), torch.ones(n), state.pop[0],
            algo.lb, algo.ub, 0.6, 2.5, 0.8)
    got = fused_pso_move_plain(*args, s)
    want = fused_pso_move_plain(*args, old_children(seed, 2, 1)[0])
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert key_pair(key) == (seed & M64, 3)


def test_nsga2_keys_match_the_host_key_stream():
    seed = 2**63 + 99
    algo = NSGA2(8, 2, torch.zeros(3), torch.ones(3), device="cpu")
    state = algo.setup(rng.key(seed))
    (init_seed,) = old_children(seed, 0, 1)
    assert torch.equal(state.pop, old_uniform(init_seed, (8, 3), torch.float32))
    children = rng.split_keys(state.key, 4)
    assert [key_pair(c) for c in children] == [(c, 0) for c in old_children(seed, 1, 4)]


def test_keys_go_where_the_state_goes():
    st = state_from_numpy({"algorithm": {"key": np.zeros(2, np.uint32), "pop": np.zeros((2, 2))}},
                          device="cpu", seed=2**63)
    assert st.algorithm.key.device.type == "cpu" and key_pair(st.algorithm.key) == (2**63, 0)
    with pytest.raises(RuntimeError):
        # No card here: the default device of a key-bearing state is CUDA.
        state_from_numpy({"key": np.zeros(2, np.uint32)})


# -- the draw kernel's launch plan (``ops/philox.py``), computed on the host --

SMS = 132
THREADS, VEC = philox._THREADS, philox._VEC


def _walk(batch, numel, plan):
    """The elements the kernel stores, by its own index arithmetic: stream
    b's vectors ``v < vectors`` of ``plan.vec`` elements (thread ``t`` of
    the stream's ``blocks * threads`` takes v = t, t + stride, ...), vector
    v covering flat elements ``vec * (first + v) ..``, each stored where its
    stream index ``i`` lies in [0, numel).  Returns the (flat element,
    stream, counter) triples and each thread's pass count."""
    stored, passes = [], {}
    vec, stride = plan.vec, plan.blocks * plan.threads
    for b in range(batch):
        lo = b * numel
        first = lo // vec
        vectors = (lo + numel + vec - 1) // vec - first
        for t in range(stride):
            for v in range(t, vectors, stride):
                passes[b, t] = passes.get((b, t), 0) + 1
                f0 = (first + v) * vec
                stored += [(f0 + e, b, f0 + e - lo) for e in range(vec) if 0 <= f0 + e - lo < numel]
    return stored, passes


def _plan(batch, numel, per_sm, sms=SMS, waves=None, monkeypatch=None):
    return philox._launch_plan(batch, numel, sms, lambda wide, vec: per_sm)


@pytest.mark.parametrize("batch,numel", [(1, 1), (1, 9), (3, 5), (3, 7), (4, 6), (5, 1030), (2, 4099), (7, 3),
                                         (2, 3000)])
@pytest.mark.parametrize("per_sm", [1, 4])
@pytest.mark.parametrize("waves", [0, 2])
@pytest.mark.parametrize("scalar", [0, 2])
def test_draw_plan_stores_every_element_once_with_its_counter(monkeypatch, batch, numel, per_sm, waves, scalar):
    """On a small card (2 SMs, so that streams take several passes), on
    either route (a thread an element or a vector of 4) and either grid
    (one pass or passes over the resident blocks)."""
    monkeypatch.setattr(philox, "_ONE_PASS_WAVES", waves)
    monkeypatch.setattr(philox, "_SCALAR_BLOCKS", scalar)
    plan = philox._launch_plan(batch, numel, 2, lambda wide, vec: per_sm)
    stored, passes = _walk(batch, numel, plan)
    assert sorted(f for f, _, _ in stored) == list(range(batch * numel))
    assert all(f == b * numel + i for f, b, i in stored)
    assert max(passes.values()) <= plan.passes


SHAPES = [(1, 1), (1, 4), (3, 5), (7, 1), (8, 102_400), (64, 16_384), (1, 100_000_000), (1, 20_000),
          (1, 200_003), (4096, 7), (4097, 2**19 + 1), (2048, 4), (13, 2**20 + 3)]


@pytest.mark.parametrize("batch,numel", SHAPES)
@pytest.mark.parametrize("per_sm", [1, 4, 8])
def test_draw_plan_makes_whole_passes_on_the_resident_blocks(batch, numel, per_sm):
    """Where one pass of a vector a thread would need more than
    ``_ONE_PASS_WAVES`` waves, each stream's vectors take the fewest passes
    its share of the resident blocks can make, spread so that no pass is
    left empty and the last is short by less than a block a pass; the grid
    is then no larger than the card holds, unless a block a stream is
    already more.  Else one pass, on at most ``_ONE_PASS_WAVES`` waves."""
    plan = _plan(batch, numel, per_sm)
    vectors = philox._stream_vectors(batch, numel, plan.vec)
    resident = SMS * per_sm
    threads = plan.blocks * plan.threads
    assert threads * plan.passes >= vectors > threads * (plan.passes - 1)
    if plan.passes == 1 and vectors * batch <= philox._ONE_PASS_WAVES * resident * THREADS:
        assert plan.blocks * plan.threads * batch <= max(philox._ONE_PASS_WAVES * resident * THREADS, 32 * batch)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= philox._ONE_PASS_BLOCK
        return
    share = max(1, resident // batch)
    assert plan.threads == THREADS and plan.blocks <= share
    assert plan.passes == -(-vectors // (share * THREADS))
    assert threads * plan.passes - vectors < plan.passes * (THREADS + 1)
    assert plan.blocks * batch <= max(resident, batch)


@pytest.mark.parametrize("batch,numel", SHAPES)
def test_draw_plan_spreads_a_small_draw_over_the_sms(batch, numel):
    """A draw that fits in ``_SCALAR_BLOCKS`` blocks an SM takes a thread
    an element; a one-pass grid reaches every SM where the draw has that
    many warps."""
    plan = _plan(batch, numel, 4)
    assert plan.vec == (1 if batch * numel <= philox._SCALAR_BLOCKS * SMS * THREADS else VEC)
    if plan.passes == 1 and batch * -(-numel // plan.vec) >= 32 * SMS:
        assert plan.blocks * batch >= SMS or plan.threads == THREADS


@pytest.mark.parametrize("batch,numel", [(1, 2**31 - 1), (1, 2**31), (4095, 2**19 + 1), (4097, 2**19 + 1),
                                         (2, 2**30), (2, 2**30 - 1), (65535, 32768), (1, 2**40)])
def test_draw_plan_keeps_indices_32_bit_below_2_31_elements(batch, numel):
    """The 32-bit route where batch x numel < 2^31: every index the kernel
    forms there (the last stream's end rounded up to a vector) fits in 32
    unsigned bits, and every element's flat index in 31."""
    plan = _plan(batch, numel, 4)
    assert plan.wide == (batch * numel >= 2**31)
    if not plan.wide:
        assert batch * numel + VEC - 1 < 2**32 and batch * numel - 1 < 2**31


@pytest.mark.parametrize("numel", range(0, 13))
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("vec", [1, 4])
def test_stream_vectors_is_the_most_any_stream_touches(batch, numel, vec):
    most = max(((b + 1) * numel + vec - 1) // vec - (b * numel) // vec for b in range(batch))
    assert philox._stream_vectors(batch, numel, vec) == most


def test_draw_plan_of_no_element_launches_nothing():
    assert _plan(3, 0, 4).blocks == 0
    for g in philox.philox_draws(1, 0, [torch.float32, (0, 3)], "cpu"):
        assert g.shape == (0,)
