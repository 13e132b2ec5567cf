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
