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


def jax_draws(algo_state):
    """The draws JAX's ``PSO.step`` makes from this state's key."""
    _, rp_key, rg_key = jax.random.split(algo_state.key, 3)
    shape, dtype = algo_state.pop.shape, algo_state.pop.dtype
    return tuple(
        torch.from_numpy(np.array(jax.random.uniform(k, shape, dtype=dtype)))
        for k in (rp_key, rg_key)
    )


def assert_algo_close(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        if k == "key":
            continue
        want = np.asarray(ref[k])
        got = port[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=k)


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
    assert PallasPSO is PSO


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
