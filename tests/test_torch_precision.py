"""The port's precision plane (``evox_tpu_torch.precision``) against the JAX
package's (``evox_tpu.precision``), on the CPU.

* The policy: identity, tags, dtype validation and its refusals, with the
  JAX package's messages; ``promote``/``demote`` of five algorithms' states
  leaf for leaf and dtype for dtype on the same numpy inputs.
* The key streams: a name selects a stream family of the one Philox
  generator, tagged in the top byte of a key's counter word.  (a) The
  default family's keys are the keys made before the knob, bit for bit;
  (b) the same seed draws differently under another name; (c)
  ``coerce_key`` passes a key of the target family through, re-seeds a key
  of another one deterministically and builds one from an int; (d) it is
  tensor operations only (it runs under ``torch.func.vmap`` and on the
  ``meta`` device, where no value can be read).
* The workflow seam: PSO and NSGA-II under ``PrecisionPolicy()`` and
  ``key_impl="rbg"`` against JAX's ``StdWorkflow`` with the same policy,
  one generation at a time from JAX's state with JAX's draws injected and
  JAX stepping one operation at a time (``jax.disable_jit``: a jitted
  program contracts multiply-adds, and the bfloat16 rounding of storage
  would turn a last-bit float32 difference into a bfloat16 one).  Every
  leaf is held bit for bit (0 ulps of its dtype).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import evox_tpu.core as jcore  # noqa: E402
import evox_tpu.precision as jprecision  # noqa: E402
from evox_tpu.algorithms import CMAES as JCMAES  # noqa: E402
from evox_tpu.algorithms import DE as JDE  # noqa: E402
from evox_tpu.algorithms import NSGA2 as JNSGA2  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.algorithms import OpenES as JOpenES  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import precision  # noqa: E402
from evox_tpu_torch.algorithms import CMAES, DE, NSGA2, PSO, OpenES  # noqa: E402
from evox_tpu_torch.precision import (  # noqa: E402
    KEY_IMPLS,
    PrecisionPolicy,
    coerce_key,
    key_impl_name,
    make_key,
    resolve_key_impl,
    state_key_impl,
)
from evox_tpu_torch.problems.numerical import DTLZ2, Sphere  # noqa: E402
from evox_tpu_torch.utils import graph, rng  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402

from test_torch_nsga2 import InjectedNSGA2  # noqa: E402
from test_torch_nsga2 import jax_draws as nsga2_draws  # noqa: E402
from test_torch_nsga2 import to_numpy  # noqa: E402
from test_torch_pso import InjectedPSO, jax_draws, ordered_bits, to_torch  # noqa: E402

N, D = 40, 6
MO_POP, MO_D, MO_M = 64, 12, 3


@pytest.fixture(autouse=True)
def _no_env_impl(monkeypatch):
    monkeypatch.delenv("EVOX_TPU_KEY_IMPL", raising=False)


def convert(jstate):
    """A JAX state as a port state (its key, of any impl, replaced)."""
    return state_from_numpy(to_numpy(jstate), device="cpu", seed=1, params=jcore.get_params(jstate))


def message(fn):
    """The message of the exception ``fn()`` raises."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def dtype_name(t):
    return str(t.dtype).split(".")[-1]


def assert_leaves(port, ref):
    """Every leaf of a port algorithm state against JAX's: the same names,
    shapes and dtypes, and the same bits (NaN at the same places)."""
    assert list(port) == list(ref)
    for k in ref:
        if k == "key":
            continue
        got, want = port[k], to_torch(ref[k])
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if got.is_floating_point():
            assert torch.equal(torch.isnan(got), torch.isnan(want)), k
            err = (ordered_bits(got) - ordered_bits(want)).abs()[~torch.isnan(want)]
            assert err.numel() == 0 or int(err.max()) == 0, (k, int(err.max()))
        else:
            assert torch.equal(got, want), k


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------


def test_exports_are_the_jax_names_less_check_precision():
    # check_precision is ported with the checkpoint layer: the exports are
    # now the JAX package's whole list.
    assert precision.__all__ == jprecision.__all__
    assert callable(precision.check_precision)
    assert precision.KEY_IMPLS == jprecision.KEY_IMPLS
    assert precision.DEFAULT_PRECISION_TAG == jprecision.DEFAULT_PRECISION_TAG


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"storage": "float16"}, {"storage": "float32", "compute": "float64"},
     {"leaves": ("velocity", "pop")}, {"leaves": {"pop": "float16", "fit": "bfloat16"}}],
)
def test_policy_identity_and_tags_match_jax(kwargs):
    p, j = PrecisionPolicy(**kwargs), jprecision.PrecisionPolicy(**kwargs)
    assert p.identity() == j.identity() and p.tag() == j.tag()
    assert p == PrecisionPolicy(**kwargs) and hash(p) == hash(PrecisionPolicy(**kwargs))
    assert precision.precision_identity(p) == jprecision.precision_identity(j)
    assert precision.precision_tag(p) == jprecision.precision_tag(j)
    assert precision.precision_identity(None) == jprecision.precision_identity(None)
    assert precision.precision_tag(None) == jprecision.precision_tag(None)
    assert dtype_name(torch.empty(0, dtype=p.storage_dtype)) == str(j.storage_dtype)
    assert dtype_name(torch.empty(0, dtype=p.compute_dtype)) == str(j.compute_dtype)


@pytest.mark.parametrize(
    "kwargs",
    [{"storage": "int8"}, {"storage": "float64"}, {"compute": "bfloat16"},
     {"leaves": {"pop": "int8"}}, {"leaves": (("pop", "float64"),)}],
)
def test_policy_validates_dtypes_as_jax(kwargs):
    assert message(lambda: PrecisionPolicy(**kwargs)) == message(lambda: jprecision.PrecisionPolicy(**kwargs))


class Undeclared:
    pass


def test_policy_requires_declared_leaves_as_jax():
    got = message(lambda: PrecisionPolicy().leaf_map(Undeclared()))
    assert got[0] is TypeError
    assert got == message(lambda: jprecision.PrecisionPolicy().leaf_map(Undeclared()))
    # An explicit map needs no declaration.
    assert PrecisionPolicy(leaves=("pop",)).leaf_map(Undeclared()) == {"pop": torch.bfloat16}


def test_misnamed_leaf_is_refused_as_jax():
    lb, ub = -np.ones(D, np.float32), np.ones(D, np.float32)
    jstate = JPSO(N, jnp.asarray(lb), jnp.asarray(ub)).setup(jax.random.key(0))
    tstate = PSO(N, torch.from_numpy(lb), torch.from_numpy(ub), device="cpu").setup(rng.key(0))
    pol, jpol = PrecisionPolicy(leaves=("velocty",)), jprecision.PrecisionPolicy(leaves=("velocty",))
    got = message(lambda: pol.validate_state(tstate, pol.leaf_map(None)))
    assert got[0] is ValueError
    assert got == message(lambda: jpol.validate_state(jstate, jpol.leaf_map(None)))
    wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(),
                     precision=PrecisionPolicy(leaves=("velocty",)))
    with pytest.raises(ValueError, match=r"\['velocty'\]"):
        wf.init(0)


@pytest.fixture(scope="module")
def states():
    """(port algorithm, JAX algorithm, JAX state after init_step, port state
    of the same numbers) for five algorithms that declare storage leaves."""
    lb, ub = -5 * np.ones(D, np.float32), 5 * np.ones(D, np.float32)
    jlb, jub, tlb, tub = jnp.asarray(lb), jnp.asarray(ub), torch.from_numpy(lb), torch.from_numpy(ub)
    center = np.linspace(-1, 1, D).astype(np.float32)
    cases = {
        "PSO": (PSO(N, tlb, tub, device="cpu"), JPSO(N, jlb, jub), JSphere()),
        "DE": (DE(N, tlb, tub, device="cpu"), JDE(N, jlb, jub), JSphere()),
        "NSGA2": (NSGA2(MO_POP, MO_M, torch.zeros(MO_D), torch.ones(MO_D), device="cpu"),
                  JNSGA2(MO_POP, MO_M, jnp.zeros(MO_D), jnp.ones(MO_D)), JDTLZ2(d=MO_D, m=MO_M)),
        "OpenES": (OpenES(N, torch.from_numpy(center), 0.05, 0.1, device="cpu"),
                   JOpenES(N, jnp.asarray(center), 0.05, 0.1), JSphere()),
        "CMAES": (CMAES(torch.from_numpy(center), 1.5, pop_size=N, device="cpu"),
                  JCMAES(jnp.asarray(center), 1.5, pop_size=N), JSphere()),
    }
    out = {}
    for name, (algo, jalgo, jprob) in cases.items():
        jwf = JWorkflow(jalgo, jprob)
        js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(3))).algorithm
        out[name] = (algo, jalgo, js, convert(js))
    return out


@pytest.mark.parametrize("name", ["PSO", "DE", "NSGA2", "OpenES", "CMAES"])
@pytest.mark.parametrize("storage", ["bfloat16", "float16"])
def test_promote_and_demote_match_jax_leaf_for_leaf(states, name, storage):
    algo, jalgo, js, ts = states[name]
    pol, jpol = PrecisionPolicy(storage=storage), jprecision.PrecisionPolicy(storage=storage)
    leaf_map, jmap = pol.leaf_map(algo), jpol.leaf_map(jalgo)
    assert {k: dtype_name(torch.empty(0, dtype=v)) for k, v in leaf_map.items()} == {
        k: str(v) for k, v in jmap.items()
    }
    pol.validate_state(ts, leaf_map)
    low, jlow = pol.demote(ts, leaf_map), jpol.demote(js, jmap)
    assert_leaves(low, jlow)
    assert low.param_keys == ts.param_keys and torch.equal(low.key, ts.key)
    for k in leaf_map:
        assert dtype_name(low[k]) == storage, k
    assert_leaves(pol.promote(low, leaf_map), jpol.promote(jlow, jmap))
    # The unmapped leaves are the same tensors.
    assert all(low[k] is ts[k] for k in ts if k not in leaf_map)


def test_state_from_numpy_takes_an_rbg_key_and_a_0_dim_bfloat16_leaf():
    """A JAX ``rbg`` key's data is (4,) uint32: replaced like any key; a
    0-dim bfloat16 leaf stays 0-dim."""
    jwf = JWorkflow(JPSO(N, -jnp.ones(D), jnp.ones(D)), JSphere(), precision=jprecision.PrecisionPolicy(),
                    key_impl="rbg")
    tree = to_numpy(jwf.init(0))
    assert tree["algorithm"]["key"].shape == (4,) and tree["algorithm"]["key"].dtype == np.uint32
    tree["algorithm"]["global_best_fit"] = np.asarray(jnp.asarray(1.5, jnp.bfloat16))
    st = state_from_numpy(tree, device="cpu", seed=4)
    assert torch.equal(st.algorithm.key, rng.key(4))
    assert st.algorithm.global_best_fit.shape == () and float(st.algorithm.global_best_fit) == 1.5
    assert st.algorithm.global_best_fit.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Key streams
# ---------------------------------------------------------------------------


def test_resolve_key_impl_as_jax(monkeypatch):
    for arg in (None, "threefry2x32", "rbg", "unsafe_rbg"):
        assert resolve_key_impl(arg) == jprecision.resolve_key_impl(arg)
    monkeypatch.setenv("EVOX_TPU_KEY_IMPL", "rbg")
    assert resolve_key_impl(None) == jprecision.resolve_key_impl(None) == "rbg"
    assert resolve_key_impl("unsafe_rbg") == "unsafe_rbg"
    got = message(lambda: resolve_key_impl("xorwow"))
    assert got[0] is ValueError and got == message(lambda: jprecision.resolve_key_impl("xorwow"))
    monkeypatch.setenv("EVOX_TPU_KEY_IMPL", "philox")
    assert message(lambda: resolve_key_impl(None)) == message(lambda: jprecision.resolve_key_impl(None))


M64 = (1 << 64) - 1


def splitmix64(z):
    z = (z + 0x9E3779B97F4A7C15) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def child(seed, counter, i):
    return rng.signed64(splitmix64((seed & M64) ^ splitmix64((counter + i) & M64)))


def test_a_default_streams_are_the_keys_made_before_the_knob():
    """(a) The default family's key is ``[seed, 0]`` and its child keys
    ``[splitmix64(seed ^ splitmix64(i)), 0]`` (computed here on Python
    integers), so every stream drawn from them is what it was."""
    for k in (make_key(7), coerce_key(7), rng.key(7), make_key(7, "threefry2x32")):
        assert k.tolist() == [7, 0]
    keys = rng.split_keys(make_key(7), 3)
    assert [c.tolist() for c in keys] == [[child(7, 0, i), 0] for i in range(3)]
    advanced, seeds = rng.split(keys[0], 2)
    assert advanced.tolist() == [child(7, 0, 0), 2]
    assert int(rng.seed_value(seeds[1])) == child(child(7, 0, 0), 0, 1)
    # A pinned default workflow is the knob-less one, bit for bit.
    a = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere())
    b = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(), key_impl="threefry2x32")
    sa, sb = a.run(a.init(3), 4), b.run(b.init(rng.key(3)), 4)
    for x, y in zip(graph.flatten(sa)[0], graph.flatten(sb)[0]):
        assert torch.equal(x, y)


def test_b_the_same_seed_draws_differently_under_each_name():
    """(b) JAX's ``test_cross_impl_divergence_is_real``: the same seed
    under two names gives other draws (setup's swarm and the move's)."""
    runs = {}
    for impl in KEY_IMPLS:
        wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(), key_impl=impl)
        s0 = wf.init(0)
        runs[impl] = (s0.algorithm.pop, wf.step(wf.init_step(s0)).algorithm.velocity)
        assert key_impl_name(s0.algorithm.key) == impl == state_key_impl(s0)
    for i, a in enumerate(KEY_IMPLS):
        for b in KEY_IMPLS[i + 1:]:
            assert not torch.equal(runs[a][0], runs[b][0]), (a, b)
            assert not torch.equal(runs[a][1], runs[b][1]), (a, b)
    # Children keep their family: the split keys of an rbg key are rbg keys.
    assert {key_impl_name(k) for k in rng.split_keys(make_key(5, "rbg"), 4)} == {"rbg"}
    assert key_impl_name(rng.fold_in(make_key(5, "unsafe_rbg"), torch.tensor(9))) == "unsafe_rbg"


def test_c_coerce_key_passes_reseeds_and_builds():
    """(c) A key of the target family comes back unchanged; a key of
    another is folded, word by word, into a zero key of the target family
    (deterministically); an int builds a key of the family."""
    rbg = make_key(11, "rbg")
    assert torch.equal(coerce_key(rbg, "rbg"), rbg)
    thr = make_key(11)
    c1, c2 = coerce_key(thr, "rbg"), coerce_key(thr, "rbg")
    assert torch.equal(c1, c2) and key_impl_name(c1) == "rbg" and not torch.equal(c1, rbg)
    tag = rng.signed64(1 << 56)
    zero = torch.tensor([0, tag])
    assert torch.equal(c1, rng.fold_in(rng.fold_in(zero, thr[0]), thr[1]))
    assert c1.tolist() == [child(child(0, tag, 11), tag, 0), tag]
    assert torch.equal(coerce_key(7, "rbg"), make_key(7, "rbg"))
    assert key_impl_name(coerce_key(rbg, "threefry2x32")) == "threefry2x32"
    # Keys of different words land on different keys.
    assert not torch.equal(coerce_key(make_key(12), "rbg"), c1)
    # The JAX package's matrix: a seed builds, a foreign key re-seeds.
    assert jprecision.key_impl_name(jprecision.coerce_key(7, "rbg")) == key_impl_name(coerce_key(7, "rbg"))
    jthr = jprecision.make_key(11)
    assert jprecision.key_impl_name(jprecision.coerce_key(jthr, "rbg")) == key_impl_name(c1)


def test_d_coerce_key_is_tensor_operations_only():
    """(d) No value of the key is read on the host: ``coerce_key`` runs on
    the ``meta`` device (which holds no values) and under
    ``torch.func.vmap``, and ``vmap(wf.init)`` of keys of another family
    equals each key's solo ``init``."""
    meta = coerce_key(torch.empty(2, dtype=torch.int64, device="meta"), "rbg")
    assert meta.device.type == "meta" and meta.shape == (2,)
    keys = torch.stack([make_key(s) for s in range(3)] + [make_key(3, "rbg"), make_key(4, "unsafe_rbg")])
    mapped = torch.func.vmap(lambda k: coerce_key(k, "rbg"))(keys)
    assert torch.equal(mapped, torch.stack([coerce_key(k, "rbg") for k in keys]))
    wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(),
                     precision=PrecisionPolicy(), key_impl="rbg")
    states = torch.func.vmap(wf.init)(keys, torch.arange(len(keys)))
    for b, k in enumerate(keys):
        solo = wf.init(k, b)
        for x, y in zip(graph.flatten(solo)[0], graph.flatten(states)[0]):
            assert torch.equal(x, y[b])
    assert key_impl_name(states.algorithm.key) == "rbg"


def test_env_impl_equals_the_argument(monkeypatch):
    """``EVOX_TPU_KEY_IMPL=rbg`` is resolved at construction and gives the
    state ``key_impl="rbg"`` gives, also from a key of another family."""
    def make(**kw):
        return StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(), **kw)

    pinned = make(key_impl="rbg")
    want = pinned.run(pinned.init(0), 3)
    monkeypatch.setenv("EVOX_TPU_KEY_IMPL", "rbg")
    env = make()
    assert env.key_impl == "rbg"
    for seed in (0, make_key(0)):
        got = env.run(env.init(seed), 3)
        for x, y in zip(graph.flatten(got)[0], graph.flatten(want)[0]):
            assert torch.equal(x, y)
    # Without the variable and the argument, a key is used as it is given.
    monkeypatch.delenv("EVOX_TPU_KEY_IMPL")
    plain = make()
    assert plain.key_impl is None
    assert key_impl_name(plain.init(make_key(0, "rbg")).algorithm.key) == "rbg"


def test_key_impl_name_and_state_key_impl_as_jax():
    jwf = JWorkflow(JPSO(N, -jnp.ones(D), jnp.ones(D)), JSphere(), key_impl="rbg")
    wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(), key_impl="rbg")
    assert state_key_impl(wf.init(0)) == jprecision.state_key_impl(jwf.init(0)) == "rbg"
    assert state_key_impl({"x": torch.zeros(2)}) is None is jprecision.state_key_impl({"x": jnp.zeros(2)})
    with pytest.raises(ValueError, match="stream tag 9"):
        key_impl_name(torch.tensor([0, rng.signed64(9 << 56)]))


# ---------------------------------------------------------------------------
# The workflow seam
# ---------------------------------------------------------------------------


def _pso_pair(policy_kw=None):
    lb, ub = -32 * np.ones(D, np.float32), 32 * np.ones(D, np.float32)
    jwf = JWorkflow(JPSO(N, jnp.asarray(lb), jnp.asarray(ub)), JSphere(),
                    precision=jprecision.PrecisionPolicy(**(policy_kw or {})), key_impl="rbg")
    algo = InjectedPSO(N, torch.from_numpy(lb), torch.from_numpy(ub), device="cpu")
    wf = StdWorkflow(algo, Sphere(), precision=PrecisionPolicy(**(policy_kw or {})), key_impl="rbg")
    return jwf, wf, algo


@pytest.mark.parametrize("storage", ["bfloat16", "float16"])
def test_pso_under_policy_and_rbg_matches_jax_per_generation(storage):
    """PSO(40 x 6) on Sphere under the policy and ``rbg`` against JAX's:
    setup's layout, then init_step and five steps from JAX's state with
    JAX's float32 draws injected (the step draws in the compute dtype of
    the promoted swarm).  Every leaf equal bit for bit, in its storage or
    compute dtype."""
    jwf, wf, algo = _pso_pair({"storage": storage})
    js, ts = jwf.init(0), wf.init(0)
    assert jprecision.key_impl_name(js.algorithm.key) == key_impl_name(ts.algorithm.key) == "rbg"
    for k in js.algorithm:
        if k != "key":
            assert dtype_name(ts.algorithm[k]) == str(js.algorithm[k].dtype), k
    with jax.disable_jit():
        nxt = jwf.init_step(js)
    assert_leaves(wf.init_step(convert(js)).algorithm, nxt.algorithm)
    for _ in range(5):
        js = nxt
        with jax.disable_jit():
            nxt = jwf.step(js)
        algo.next_draws = jax_draws(js.algorithm, jnp.float32)
        port = wf.step(convert(js))
        assert_leaves(port.algorithm, nxt.algorithm)
        assert dtype_name(port.algorithm.pop) == storage
        assert port.algorithm.global_best_fit.dtype == torch.float32


def test_nsga2_under_policy_matches_jax_per_generation():
    """NSGA-II(64, m=3) on DTLZ2 under the policy and ``rbg`` against JAX's,
    five generations from JAX's state with JAX's mating pool and draws
    injected: every leaf bit for bit (pop, fitness and crowding distance
    in bfloat16, rank)."""
    jalgo = JNSGA2(MO_POP, MO_M, jnp.zeros(MO_D), jnp.ones(MO_D))
    jwf = JWorkflow(jalgo, JDTLZ2(d=MO_D, m=MO_M), precision=jprecision.PrecisionPolicy(), key_impl="rbg")
    algo = InjectedNSGA2(MO_POP, MO_M, torch.zeros(MO_D), torch.ones(MO_D), device="cpu")
    wf = StdWorkflow(algo, DTLZ2(d=MO_D, m=MO_M, device="cpu"), precision=PrecisionPolicy(), key_impl="rbg")
    jpol = jprecision.PrecisionPolicy()
    with jax.disable_jit():
        js = jwf.init_step(jwf.init(1))
    assert_leaves(wf.init_step(convert(jwf.init(1))).algorithm, js.algorithm)
    for _ in range(5):
        ts = convert(js)
        # JAX's step draws from the promoted state (crowding distances in
        # float32).
        algo.next_draws = nsga2_draws(jpol.promote(js.algorithm, jpol.leaf_map(jalgo)), MO_POP)
        ts = wf.step(ts)
        with jax.disable_jit():
            js = jwf.step(js)
        assert_leaves(ts.algorithm, js.algorithm)
        assert dtype_name(ts.algorithm.pop) == "bfloat16" and ts.algorithm.rank.dtype == torch.int32


def test_storage_dtype_carried_between_generations_and_run_equals_steps():
    """The state between generations holds the storage form (setup,
    init_step, step, run, run_segment), and ``run(5)`` equals five steps
    bit for bit (JAX's ``test_fused_equals_debug_under_policy``)."""
    wf = StdWorkflow(PSO(N, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(),
                     precision=PrecisionPolicy(), key_impl="rbg")
    s0 = wf.init(0)
    for k in ("pop", "velocity", "local_best_location", "local_best_fit", "fit"):
        assert s0.algorithm[k].dtype == torch.bfloat16, k
    for k in ("global_best_fit", "global_best_location", "w"):
        assert s0.algorithm[k].dtype == torch.float32, k
    ref = wf.init_step(s0)
    for _ in range(4):
        ref = wf.step(ref)
    run = wf.run(s0, 5)
    seg, tel = wf.run_segment(wf.init_step(s0), 4)
    for st in (run, seg):
        assert graph.structure(st) == graph.structure(s0)
        for x, y in zip(graph.flatten(st)[0], graph.flatten(ref)[0]):
            assert torch.equal(x, y)
    assert int(tel.executed) == 4 and key_impl_name(run.algorithm.key) == "rbg"


def test_vmapped_instances_under_policy_equal_their_solo_runs():
    """JAX's solo == packed under the policy: vmapped setup, init_step and
    three steps of three instances equal each instance's solo run."""
    wf = StdWorkflow(PSO(20, -torch.ones(D), torch.ones(D), device="cpu"), Sphere(),
                     precision=PrecisionPolicy(), key_impl="rbg")
    keys = torch.stack(rng.split_keys(make_key(2), 3))
    states = torch.func.vmap(wf.init_step)(torch.func.vmap(wf.init)(keys, torch.arange(3)))
    step = torch.func.vmap(wf.step)
    for _ in range(3):
        states = step(states)
    assert states.algorithm.pop.dtype == torch.bfloat16
    for b in range(3):
        solo = wf.init_step(wf.init(keys[b], b))
        for _ in range(3):
            solo = wf.step(solo)
        for x, y in zip(graph.flatten(solo)[0], graph.flatten(states)[0]):
            assert torch.equal(x, y[b])
