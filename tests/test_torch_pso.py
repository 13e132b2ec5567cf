"""The port's PSO (``evox_tpu_torch.algorithms.PSO``) against the JAX
package's PSO, one generation at a time.

Each generation starts both frameworks from the same state: the JAX state
is carried across with ``state_from_numpy``, the port's PSO is handed the
draws JAX's step makes (through its ``_draws`` seam), and every leaf of the
port's next state is compared with JAX's at rtol 1e-5.  Feeding each step
from JAX keeps the chaotic growth of rounding differences out of the
check."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import evox_tpu.core as jcore  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import Ackley as JAckley  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import PSO, PallasPSO  # noqa: E402
from evox_tpu_torch.core import get_params  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402

N, D = 40, 6


class InjectedPSO(PSO):
    """PSO whose move uses draws supplied from outside (``rand="input"``)."""

    next_draws = None

    def _draws(self, state):
        return state, self.next_draws


def to_numpy(state):
    out = {}
    for k, v in state.items():
        if isinstance(v, jcore.State):
            out[k] = to_numpy(v)
        elif jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key):
            out[k] = np.asarray(jax.random.key_data(v))
        else:
            out[k] = np.asarray(v)
    return out


def convert(jstate):
    return state_from_numpy(
        to_numpy(jstate), device="cpu", seed=1, params=jcore.get_params(jstate)
    )


def jax_draws(algo_state, dtype=None):
    """The draws JAX's ``PSO.step`` makes from this state's key, in the
    population's dtype (or ``dtype``: under a precision policy the step
    draws in the compute dtype of the promoted population)."""
    _, rp_key, rg_key = jax.random.split(algo_state.key, 3)
    shape, dtype = algo_state.pop.shape, dtype or algo_state.pop.dtype
    return tuple(to_torch(jax.random.uniform(k, shape, dtype=dtype)) for k in (rp_key, rg_key))


def to_torch(a):
    """A JAX array as a torch tensor of the same dtype and bits."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def assert_algo_close(port, ref, atol=1e-6):
    assert set(port) == set(ref)
    for k in ref:
        if k == "key":
            continue
        want = np.asarray(ref[k])
        got = port[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=k)


def test_setup_layout_matches_jax():
    lb, ub = -5 * np.ones(D, np.float32), 5 * np.ones(D, np.float32)
    jstate = JPSO(N, jnp.asarray(lb), jnp.asarray(ub)).setup(jax.random.key(0))
    tstate = PSO(N, torch.from_numpy(lb), torch.from_numpy(ub), device="cpu").setup(
        torch.tensor([0, 0])
    )
    assert list(tstate) == list(jstate)
    assert tstate.param_keys == jstate.param_keys
    for k in jstate:
        if k != "key":
            assert tuple(tstate[k].shape) == jstate[k].shape, k
    pop = tstate.pop
    assert bool((pop >= -5).all()) and bool((pop < 5).all())
    assert float(tstate.w) == pytest.approx(0.6)
    assert issubclass(PallasPSO, PSO)


def test_init_step_and_five_steps_match_jax_per_generation():
    lb, ub = -32 * np.ones(D, np.float32), 32 * np.ones(D, np.float32)
    jwf = JWorkflow(JPSO(N, jnp.asarray(lb), jnp.asarray(ub)), JAckley())
    algo = InjectedPSO(N, torch.from_numpy(lb), torch.from_numpy(ub), device="cpu")
    twf = StdWorkflow(algo, Ackley())

    jstate = jwf.init(jax.random.key(3))
    nxt = jax.jit(jwf.init_step)(jstate)
    port = twf.init_step(convert(jstate))
    assert_algo_close(port.algorithm, nxt.algorithm)
    assert get_params(port).keys() == jcore.get_params(nxt).keys()

    jstep = jax.jit(jwf.step)
    jstate = nxt
    for _ in range(5):
        nxt = jstep(jstate)
        algo.next_draws = jax_draws(jstate.algorithm)
        port = twf.step(convert(jstate))
        assert_algo_close(port.algorithm, nxt.algorithm)
        jstate = nxt
    # The run moved: the global best improved over the five steps.
    assert float(jstate.algorithm.global_best_fit) < float(
        jax.jit(jwf.init_step)(jwf.init(jax.random.key(3))).algorithm.global_best_fit
    )


def test_step_advances_key_and_hw_mode_is_reproducible():
    lb, ub = -torch.ones(D), torch.ones(D)
    wf = StdWorkflow(PSO(N, lb, ub, device="cpu"), Ackley())
    a = wf.run(wf.init(5), 4)
    b = wf.run(wf.init(5), 4)
    c = wf.run(wf.init(6), 4)
    for k in a.algorithm:
        assert torch.equal(a.algorithm[k], b.algorithm[k]), k
    assert not torch.equal(a.algorithm.pop, c.algorithm.pop)
    assert int(a.algorithm.key[1]) == 2 + 3  # 2 setup draws + 3 steps


# ---------------------------------------------------------------------------
# PallasPSO(rand=), PSO(dtype=bfloat16) and Sphere in bfloat16
# ---------------------------------------------------------------------------


_INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32,
             torch.float64: torch.int64}


def ordered_bits(t):
    """Integers that order like the floats of ``t`` (-0 == +0): a
    difference of k is k units in the last place of the dtype."""
    bits = t.view(_INT_VIEW[t.dtype]).to(torch.int64)
    mag = bits & torch.iinfo(_INT_VIEW[t.dtype]).max
    return torch.where(bits < 0, -mag, mag)


def bf16_ulps(got, want):
    """Units in the last place of bfloat16 between two bfloat16 arrays."""
    return (ordered_bits(got) - ordered_bits(want)).abs()


def test_pallas_pso_rand_hw_is_pso():
    lb, ub = -torch.ones(D), torch.ones(D)
    a = StdWorkflow(PSO(N, lb, ub, device="cpu"), Ackley())
    b = StdWorkflow(PallasPSO(N, lb, ub, rand="hw", device="cpu"), Ackley())
    sa, sb = a.run(a.init(5), 4), b.run(b.init(5), 4)
    for k in sa.algorithm:
        assert torch.equal(sa.algorithm[k], sb.algorithm[k]), k
    assert PallasPSO(N, lb, ub, device="cpu").rand == "hw"


@pytest.mark.parametrize("rand", ["nope", "HW", None])
def test_pallas_pso_refuses_other_rand(rand):
    with pytest.raises(ValueError, match="rand must be 'hw' or 'input'"):
        PallasPSO(N, -torch.ones(D), torch.ones(D), rand=rand, device="cpu")


class InjectedPallasPSO(PallasPSO):
    """``PallasPSO(rand="input")`` whose two draws are replaced by JAX's
    after its own ``_draws`` has made them and advanced the key."""

    next_draws = None
    made = None

    def _draws(self, state):
        state, draws = super()._draws(state)
        self.made = draws
        return state, self.next_draws


def jax_pallas_draws(algo_state):
    """The draws JAX's ``PallasPSO(rand="input")`` step makes."""
    _, step_key = jax.random.split(algo_state.key)
    rp_key, rg_key = jax.random.split(step_key)
    shape, dtype = algo_state.pop.shape, algo_state.pop.dtype
    return tuple(
        torch.from_numpy(np.array(jax.random.uniform(k, shape, dtype=dtype))) for k in (rp_key, rg_key)
    )


def test_pallas_pso_rand_input_matches_jax_kernel_path(monkeypatch):
    """Port ``PallasPSO(rand="input")`` against JAX's with its Pallas kernel
    dispatched (gate open, interpret mode on the CPU; dim 128 needs no lane
    padding), JAX's draws injected, five generations.  The interpreter's
    kernel is one XLA program, which contracts the move's multiply-adds, so
    each leaf is held at rtol 1e-5 and an absolute 4 float32 ulps of the
    bound 32 (the scale of the move's terms)."""
    from evox_tpu.algorithms import PallasPSO as JPallasPSO
    from evox_tpu.ops import pallas_gate

    d = 128
    lb, ub = -32 * np.ones(d, np.float32), 32 * np.ones(d, np.float32)
    monkeypatch.setenv("EVOX_TPU_PALLAS", "1")
    pallas_gate._reset_for_tests()
    try:
        jalgo = JPallasPSO(N, jnp.asarray(lb), jnp.asarray(ub), rand="input")
        assert jalgo.use_kernel and jalgo.dim == d
        jwf = JWorkflow(jalgo, JAckley())
        algo = InjectedPallasPSO(N, torch.from_numpy(lb), torch.from_numpy(ub), rand="input", device="cpu")
        twf = StdWorkflow(algo, Ackley())
        jstate = jax.jit(jwf.init_step)(jwf.init(jax.random.key(4)))
        jstep = jax.jit(jwf.step)
        for _ in range(5):
            nxt = jstep(jstate)
            algo.next_draws = jax_pallas_draws(jstate.algorithm)
            port_in = convert(jstate)
            port = twf.step(port_in)
            assert_algo_close(port.algorithm, nxt.algorithm, atol=32 * 2.0**-21)
            # The port's own draws: two uniforms of the population's shape
            # and dtype, and the key advanced past them and the move's seed.
            rp, rg = algo.made
            assert rp.shape == rg.shape == (N, d) and rp.dtype == torch.float32
            assert not torch.equal(rp, rg) and float(rp.min()) >= 0 and float(rp.max()) < 1
            assert int(port.algorithm.key[1]) == int(port_in.algorithm.key[1]) + 3
            jstate = nxt
    finally:
        pallas_gate._reset_for_tests()


BF16_N, BF16_D = 512, 64


def test_bf16_pso_matches_jax_bf16_pso_per_generation():
    """``PSO(dtype=bfloat16)`` against JAX's ``PSO(dtype=bfloat16)`` on
    Sphere, one generation at a time from JAX's state with JAX's bfloat16
    draws injected, JAX stepping one operation at a time: every leaf equal
    bit for bit (a bound of 0 bfloat16 ulps).  Both round every bfloat16
    operation, in the same order (the port's kernel route and its plain
    version alike)."""
    from evox_tpu.problems.numerical import Sphere as JSphere
    from evox_tpu_torch.problems.numerical import Sphere

    lb = -10 * np.ones(BF16_D, np.float32)
    jlb, jub = jnp.asarray(lb, jnp.bfloat16), jnp.asarray(-lb, jnp.bfloat16)
    jwf = JWorkflow(JPSO(BF16_N, jlb, jub, dtype=jnp.bfloat16), JSphere())
    tlb, tub = to_torch(jlb), to_torch(jub)
    algo = InjectedPSO(BF16_N, tlb, tub, dtype=torch.bfloat16, device="cpu")
    twf = StdWorkflow(algo, Sphere())
    with jax.disable_jit():
        jstate = jwf.init_step(jwf.init(jax.random.key(2)))
        for _ in range(5):
            nxt = jwf.step(jstate)
            algo.next_draws = jax_draws(jstate.algorithm)
            assert algo.next_draws[0].dtype == torch.bfloat16
            port = twf.step(convert(jstate))
            for k in nxt.algorithm:
                if k == "key":
                    continue
                got, want = port.algorithm[k], to_torch(nxt.algorithm[k])
                assert got.dtype == torch.bfloat16 and got.shape == want.shape, k
                assert int(bf16_ulps(got, want).max()) == 0, k
            jstate = nxt


@pytest.mark.parametrize("shape", [(40, 6), (512, 64), (256, 1000)])
def test_bf16_sphere_matches_jax(shape):
    """Sphere on bfloat16 rows: the port's (``x**2`` rounded to bfloat16,
    summed with a float32 accumulator, rounded once) equals JAX's op by op
    (0 ulps) and is within 1 bfloat16 ulp of JAX's jitted program (which
    keeps the squares in float32)."""
    from evox_tpu.core import State as JState
    from evox_tpu.problems.numerical import Sphere as JSphere
    from evox_tpu_torch.problems.numerical import Sphere

    x = np.random.default_rng(0).uniform(-10, 10, shape).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    got = Sphere().evaluate(None, to_torch(jx))[0]
    assert got.dtype == torch.bfloat16
    with jax.disable_jit():
        eager = to_torch(JSphere().evaluate(JState(), jx)[0])
    jitted = to_torch(jax.jit(lambda a: JSphere().evaluate(JState(), a)[0])(jx))
    assert int(bf16_ulps(got, eager).max()) == 0
    assert int(bf16_ulps(got, jitted).max()) <= 1


# ---------------------------------------------------------------------------
# Public names the JAX package exports
# ---------------------------------------------------------------------------


def test_core_and_top_level_transforms_are_the_reference_names():
    import evox_tpu
    import evox_tpu_torch
    from evox_tpu_torch import core

    for name in ("compile", "jit", "vmap"):
        assert name in core.__all__ and name in evox_tpu_torch.__all__
        assert name in jcore.__all__ and name in evox_tpu.__all__
        assert getattr(evox_tpu_torch, name) is getattr(core, name)
    # JAX's are jax.jit and jax.vmap; the reference EvoX's, torch.compile
    # and torch.func.vmap.
    assert jcore.compile is jcore.jit is jax.jit and jcore.vmap is jax.vmap
    assert core.compile is core.jit is torch.compile
    assert core.vmap is torch.func.vmap
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = core.vmap(lambda r: (r * r).sum())(torch.from_numpy(xs))
    want = jcore.vmap(lambda r: (r * r).sum())(jnp.asarray(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_flatten_and_unflatten_match_jax_over_a_state():
    from evox_tpu import utils as jutils
    from evox_tpu_torch import utils

    lb, ub = -5 * np.ones(D, np.float32), 5 * np.ones(D, np.float32)
    jwf = JWorkflow(JPSO(N, jnp.asarray(lb), jnp.asarray(ub)), JAckley())
    jstate = jwf.init_step(jwf.init(jax.random.key(0)))
    tstate = convert(jstate)
    jleaves, jdef = jutils.tree_flatten(jstate)
    tleaves, tspec = utils.tree_flatten(tstate)
    assert len(tleaves) == len(jleaves)
    for got, want in zip(tleaves, jleaves):
        if jax.dtypes.issubdtype(want.dtype, jax.dtypes.prng_key):
            assert got.dtype == torch.int64
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = utils.tree_unflatten(tleaves, tspec)
    jback = jutils.tree_unflatten(jdef, jleaves)
    assert list(back) == list(jback) and list(back.algorithm) == list(jback.algorithm)
    assert back.algorithm.param_keys == jback.algorithm.param_keys
    assert all(back.algorithm[k] is tstate.algorithm[k] for k in tstate.algorithm)


def test_vmap_info_matches_jax():
    from evox_tpu.utils import VmapInfo as JVmapInfo
    from evox_tpu_torch.utils import VmapInfo

    assert VmapInfo._fields == JVmapInfo._fields
    assert VmapInfo(4) == tuple(JVmapInfo(4)) and VmapInfo(4).randomness == "different"
    assert VmapInfo(2, "same") == tuple(JVmapInfo(2, "same"))


def test_get_submodule_matches_jax():
    lb, ub = -5 * np.ones(D, np.float32), 5 * np.ones(D, np.float32)
    jwf = JWorkflow(JPSO(N, jnp.asarray(lb), jnp.asarray(ub)), JAckley())
    twf = StdWorkflow(PSO(N, torch.from_numpy(lb), torch.from_numpy(ub), device="cpu"), Ackley())
    for target in ("algorithm", "problem", "monitor"):
        assert type(twf.get_submodule(target)).__name__ == type(jwf.get_submodule(target)).__name__
    assert twf.get_submodule("algorithm.pop_size") == jwf.get_submodule("algorithm.pop_size") == N
    for wf in (twf, jwf):
        with pytest.raises(AttributeError):
            wf.get_submodule("algorithm.nope")
