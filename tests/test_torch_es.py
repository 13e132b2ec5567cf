"""The port's ES family (``evox_tpu_torch.algorithms.so.es_variants``),
its helpers and the factorisations of ``evox_tpu_torch.ops.linalg``
against the JAX package's, on the CPU.

Draws: JAX's own (``jax.random.normal`` from the keys its step splits) go
through the port's ``_draws`` seam.  States: the JAX state is carried into
the port (``state_from_numpy``) before every generation, so each
generation starts from the same state on both sides.  Arithmetic: JAX's
step runs one operation at a time (``jax.disable_jit``: XLA's CPU backend
would fuse ``a * b + c`` into one multiply-add) and the port's workflow
evaluates with the JAX problem (:class:`Recorded`), so elementwise code
has the same bits on both sides:

* bit for bit: ``adam_single_tensor``, ``sort_by_key``, the populations
  of every algorithm that samples elementwise (mirrored pairs, the
  baseline row, ``center + sigma * z``), their fitness, the step sizes of
  ``maximum``/``where`` updates, the counters, and the reset and
  ``where`` branches (PersistentES's accumulator, NoiseReuseES's reused
  perturbation, ASEBO's warm-up, CMA-ES's decomposition cadence);
* within :data:`LEAF_RTOL` of the leaf's largest magnitude: everything
  that goes through a reduction or a matrix product (summed in another
  order: OpenES's ``noise.T @ fit`` over the population, norms, the
  weighted recombinations, CMA-ES's ``noise @ A.T``) or a transcendental
  computed by each framework on its own (CMA-ES's and SNES's log-rank and
  softmax weights, ``exp`` of the step size, the ``pow`` in ``h_sigma``);
* by invariants: the factorisations (eigenvalues, ``A A^T`` against
  ``C``, ``C^{-1/2}``, ASEBO's projectors ``U U^T``, the span of GuidedES's
  ``Q``, the port's ``expm`` against JAX's).
"""

import ast
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.scipy.linalg import expm as jexpm  # noqa: E402

from evox_tpu import algorithms as jalgorithms  # noqa: E402
from evox_tpu.algorithms.so.es_variants import adam_single_tensor as jadam  # noqa: E402
from evox_tpu.algorithms.so.es_variants import sort_by_key as jsort_by_key  # noqa: E402
from evox_tpu.core import Problem as JProblem  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.problems.numerical import CEC2022 as JCEC2022  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.algorithms.so.es_variants import adam_single_tensor, sort_by_key  # noqa: E402
from evox_tpu_torch.core import Problem  # noqa: E402
from evox_tpu_torch.ops import linalg, philox  # noqa: E402
from evox_tpu_torch.problems.numerical import CEC2022, Sphere  # noqa: E402
from evox_tpu_torch.utils import rng  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402
from test_torch_rvea import Injected  # noqa: E402

DIM, POP, GENS = 8, 16, 4  # tests/test_es_variants.py's size
# A leaf that goes through a reduction or a transcendental: its largest
# difference from JAX's over its largest magnitude (float32 sums of at
# most 16 rows and 8-entry norms round ~1e-7 apart; the weights' log and
# softmax differ by an ulp; measured at most 1.1e-6 over every generation
# held here).
LEAF_RTOL = 1e-5
# Factorisations: eigenvalues, A A^T against C, C^{-1/2}, projectors,
# spans and the Cholesky factor, relative to the largest magnitude (two
# LAPACK builds' float32 Householder and divide-and-conquer steps on
# matrices of condition up to 1e3, ~1e-6).
FACTOR_RTOL = 2e-5
# CEC2022 float32 against JAX (tests/test_torch_cec2022.py).
CEC_RTOL = 2e-4


def jeval(fn, *args):
    """JAX ``fn`` run one operation at a time (no fused multiply-add)."""
    with jax.disable_jit():
        return fn(*args)


def rel(got, want) -> float:
    """Largest difference over the largest magnitude (NaN places must
    agree; they count as equal)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if got.size == 0 or np.all(np.isnan(want)):
        return 0.0
    scale = max(float(np.nanmax(np.abs(want))), 1e-30)
    return float(np.nanmax(np.abs(got - want)) / scale)


# ---------------------------------------------------------------------------
# Helpers: adam_single_tensor, sort_by_key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(beta1=0.8, beta2=0.99, lr=0.05), dict(weight_decay=0.01, eps=1e-6)])
def test_adam_single_tensor_matches_jax_bit_for_bit(kw):
    r = np.random.default_rng(0)
    p, g, m = (r.standard_normal(257).astype(np.float32) for _ in range(3))
    v = r.uniform(0, 2, 257).astype(np.float32)
    v[:5] = 0.0
    want = jeval(lambda: jadam(*(jnp.asarray(a) for a in (p, g, m, v)), **kw))
    got = adam_single_tensor(t(p), t(g), t(m), t(v), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # With the betas and the rate as float32 scalars, as the ES states
    # hold them (``1 - beta1`` then rounds in float32 on both sides).
    scalars = ("beta1", "beta2", "lr")
    jkw = {k: jnp.float32(v_) if k in scalars else v_ for k, v_ in kw.items()}
    tkw = {k: torch.tensor(v_, dtype=torch.float32) if k in scalars else v_ for k, v_ in kw.items()}
    want = jeval(lambda: jadam(*(jnp.asarray(a) for a in (p, g, m, v)), **jkw))
    got = adam_single_tensor(t(p), t(g), t(m), t(v), **tkw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


SORT_FIT = {
    "random": np.random.default_rng(1).standard_normal(64).astype(np.float32),
    "ties": np.array([0.0, -0.0, np.nan, 1.0, -np.nan, 0.0, -0.0, -1.0, np.inf, -np.inf] * 4, np.float32),
    "all_nan": np.full(9, np.nan, np.float32),
}


@pytest.mark.parametrize("kind", list(SORT_FIT))
def test_sort_by_key_matches_jax_bit_for_bit(kind):
    fit = SORT_FIT[kind]
    pop = np.arange(fit.size * 3, dtype=np.float32).reshape(fit.size, 3)
    want = jsort_by_key(jnp.asarray(fit), jnp.asarray(pop), jnp.asarray(-pop))
    got = sort_by_key(t(fit), t(pop), t(-pop))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# Factorisations (ops/linalg.py) against JAX's, by invariants
# ---------------------------------------------------------------------------


def _spd(n, seed, cond=1e3):
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.standard_normal((n, n)))
    w = np.geomspace(1.0, cond, n)
    return ((q * w) @ q.T).astype(np.float32)


@pytest.mark.parametrize("n", [1, 8, 20, 33])
def test_eigh_matches_jax_by_invariants(n):
    C = _spd(n, n)
    jw, jv = jnp.linalg.eigh(jnp.asarray(C))
    w, v = linalg.eigh(t(C))
    assert rel(w, jw) <= FACTOR_RTOL
    assert bool((w[1:] >= w[:-1]).all())
    C64 = C.astype(np.float64)
    V = v.double().numpy()
    assert rel((V * w.double().numpy()) @ V.T, C64) <= FACTOR_RTOL
    assert rel(V.T @ V, np.eye(n)) <= FACTOR_RTOL


def test_factorisations_of_non_finite_input_are_nan_as_in_jax():
    C = _spd(6, 0)
    C[2, 3] = C[3, 2] = np.nan
    # JAX's LAPACK leaves NaN in what the NaN reached; the port gives all
    # NaN (it does not run the solver on such input).
    jw, jv = jnp.linalg.eigh(jnp.asarray(C))
    w, v = linalg.eigh(t(C))
    assert bool(jnp.isnan(jw).any()) and bool(torch.isnan(w).all()) and bool(torch.isnan(v).all())
    X = np.ones((4, 6), np.float32)
    X[1, 1] = np.inf
    assert bool(jnp.isnan(jnp.linalg.svd(jnp.asarray(X), full_matrices=False)[2]).any())
    assert bool(torch.isnan(linalg.svd_vh(t(X))).all())
    # A matrix that is not positive definite: NaN in the lower triangle of
    # both.
    bad = -np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(linalg.cholesky(t(bad)).numpy(), np.asarray(jnp.linalg.cholesky(jnp.asarray(bad))))


def _projector(rows):
    rows = np.asarray(rows, np.float64)
    return rows.T @ rows


@pytest.mark.parametrize("m,n,k", [(8, 8, 3), (20, 20, 20), (12, 5, 2), (4, 8, 4)])
def test_svd_projectors_match_jax(m, n, k):
    """The projector onto the top-k right singular vectors (ASEBO's
    ``U^T U``) where it is unique: singular values apart, k within the
    rank."""
    r = np.random.default_rng(m * n + k)
    U, _ = np.linalg.qr(r.standard_normal((m, m)))
    V, _ = np.linalg.qr(r.standard_normal((n, n)))
    s = np.geomspace(10.0, 0.5, min(m, n))
    X = ((U[:, : len(s)] * s) @ V[:, : len(s)].T).astype(np.float32)
    _, _, jvt = jnp.linalg.svd(jnp.asarray(X), full_matrices=False)
    vt = linalg.svd_vh(t(X))
    assert tuple(vt.shape) == jvt.shape
    assert rel(_projector(vt.numpy()[:k]), _projector(np.asarray(jvt)[:k])) <= FACTOR_RTOL


@pytest.mark.parametrize("shape", [(8, 4), (20, 20), (8, 8)])
def test_qr_spans_and_cholesky_match_jax(shape):
    r = np.random.default_rng(shape[0] * 7 + shape[1])
    X = r.standard_normal(shape).astype(np.float32)
    jq, _ = jnp.linalg.qr(jnp.asarray(X))
    q = linalg.qr(t(X))
    assert tuple(q.shape) == jq.shape
    assert rel(_projector(q.numpy().T), _projector(np.asarray(jq).T)) <= FACTOR_RTOL
    assert rel(q.double().T @ q.double(), np.eye(q.shape[1])) <= FACTOR_RTOL
    C = _spd(shape[1], 3)
    assert rel(linalg.cholesky(t(C)), jnp.linalg.cholesky(jnp.asarray(C))) <= FACTOR_RTOL


EXPM_SCALES = [1e-3, 0.1, 0.3, 1.0, 2.0, 10.0, 40.0]
# expm against JAX's, relative to the largest magnitude: a matrix product
# of the other framework rounds ~1e-7 apart (float32; 1e-15 in float64),
# Padé and the solve keep it near 1e-6, and each of the n squarings at most
# doubles it: the limit is EXPM_RTOL * 2^n.
EXPM_RTOL = {"float32": 4e-6, "float64": 1e-13}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("scale", EXPM_SCALES)
def test_expm_matches_jax(scale, dtype):
    """Every Padé degree and up to 4 squarings (the largest scale stays
    below float32 overflow): the port's copy of JAX's algorithm against
    JAX's."""
    r = np.random.default_rng(int(scale * 1000))
    A = (r.standard_normal((DIM, DIM)) * scale / DIM).astype(dtype)
    maxnorm = 3.925724783138660 if dtype == "float32" else 5.371920351148152
    n = max(0, math.floor(math.log2(np.abs(A).sum(axis=0).max() / maxnorm)))
    limit = EXPM_RTOL[dtype] * 2**n
    if dtype == "float64":
        with jax.enable_x64(True):
            want = np.asarray(jexpm(jnp.asarray(A)))
    else:
        want = np.asarray(jexpm(jnp.asarray(A)))
    got = linalg.expm(t(A))
    assert got.dtype == getattr(torch, dtype)
    assert rel(got, want) <= limit


def test_expm_beyond_its_squarings_is_nan_as_in_jax():
    A = np.eye(4, dtype=np.float32) * 1e6
    assert bool(jnp.isnan(jexpm(jnp.asarray(A))).all())
    assert bool(torch.isnan(linalg.expm(t(A))).all())
    assert bool(torch.isnan(linalg.expm(t(A), max_squarings=3)).all())


# ---------------------------------------------------------------------------
# The algorithms, generation for generation against JAX
# ---------------------------------------------------------------------------


class Recorded(Problem):
    """A port problem that evaluates with the JAX package's problem, one
    operation at a time, and keeps every population it was given."""

    def __init__(self, jprob):
        self.jprob = jprob
        self.pops = []

    def evaluate(self, state, pop):
        self.pops.append(pop.clone())
        fit = jeval(lambda: self.jprob.evaluate(JState(), jnp.asarray(pop.numpy()))[0])
        return torch.from_numpy(np.array(fit)), state


class JRecorded(JProblem):
    """The JAX side's problem, keeping every population (JAX runs without
    jit here, so the populations are concrete)."""

    def __init__(self, jprob):
        self.jprob = jprob
        self.pops = []

    def evaluate(self, state, pop):
        self.pops.append(np.asarray(pop))
        return self.jprob.evaluate(state, pop)


def _normals(*shapes):
    """JAX's draws of a step that splits its key into ``len(shapes) + 1``
    and draws one standard normal of each shape."""

    def draws(ja, algo):
        keys = jax.random.split(ja.key, len(shapes) + 1)[1:]
        return [t(jax.random.normal(k, s(algo) if callable(s) else s)) for k, s in zip(keys, shapes)]

    return draws


def _full(algo):
    return (algo.pop_size, algo.dim)


def _half(algo):
    return (algo.pop_size // 2, algo.dim)


def _esmc_half(algo):
    return ((algo.pop_size - 1) // 2, algo.dim)


def _columns(algo):
    return (algo.dim, algo.pop_size // 2)


def _sub_columns(algo):
    return (algo.subspace_dims, algo.pop_size // 2)


CENTER = np.ones(DIM, np.float32)

# name -> (class, the positional arguments as a function of the center,
# keyword arguments, draws, leaves equal bit for bit, population equal bit
# for bit).  Every other float leaf is held within LEAF_RTOL; "A",
# "C_invsqrt" and ASEBO's projectors by invariants.
ALGOS = {
    "CMAES": ("CMAES", lambda c: (c, 1.0), dict(pop_size=POP), _normals(_full), {"iteration"}, False),
    "OpenES": ("OpenES", lambda c: (POP, c, 0.05, 0.1), {}, _normals(_half), set(), True),
    "OpenES_adam": ("OpenES", lambda c: (POP, c, 0.05, 0.1), dict(optimizer="adam"), _normals(_half), set(), True),
    "OpenES_plain": ("OpenES", lambda c: (POP, c, 0.05, 0.1), dict(mirrored_sampling=False), _normals(_full),
                     set(), True),
    "XNES": ("XNES", lambda c: (c, np.eye(DIM, dtype=np.float32)), dict(pop_size=POP), _normals(_full), set(),
             False),
    "SeparableNES": ("SeparableNES", lambda c: (c, np.ones(DIM, np.float32)), dict(pop_size=POP),
                     _normals(_full), set(), True),
    "SNES": ("SNES", lambda c: (POP, c), {}, _normals(_full), set(), True),
    "SNES_recomb": ("SNES", lambda c: (POP, c), dict(weight_type="recomb"), _normals(_full), set(), True),
    "DES": ("DES", lambda c: (POP, c), {}, _normals(_full), set(), True),
    "ARS": ("ARS", lambda c: (POP, c), {}, _normals(_half), set(), True),
    "ARS_adam": ("ARS", lambda c: (POP, c), dict(optimizer="adam", elite_ratio=0.5), _normals(_half), set(), True),
    "ASEBO": ("ASEBO", lambda c: (POP, c), dict(subspace_dims=4), _normals(_columns),
              {"sigma", "gen_counter", "UUT", "UUT_ort"}, False),
    # half = 2 < dim = subspace_dims = 8: U U^T and its complement are the
    # unique projectors onto the top-2 and the other right singular vectors.
    "ASEBO_projector": ("ASEBO", lambda c: (4, c), dict(subspace_dims=DIM), _normals(_columns),
                        {"sigma", "gen_counter"}, False),
    "GuidedES": ("GuidedES", lambda c: (POP, c), dict(subspace_dims=4), _normals(_columns, _sub_columns),
                 {"sigma", "alpha"}, False),
    "PersistentES": ("PersistentES", lambda c: (POP, c), dict(T=30, K=10, sigma_decay=0.9),
                     _normals(_half), {"sigma", "inner_step_counter", "pert_accum"}, True),
    "NoiseReuseES": ("NoiseReuseES", lambda c: (POP, c), dict(T=30, K=10, sigma_decay=0.9),
                     _normals(_half), {"sigma", "inner_step_counter", "unroll_pert"}, True),
    "ESMC": ("ESMC", lambda c: (POP + 1, c), dict(sigma_decay=0.9), _normals(_esmc_half), {"sigma"}, True),
}
# Leaves compared by invariants, not entry by entry.
INVARIANT = {"A", "C_invsqrt", "UUT", "UUT_ort"}
PARITY_GENS = {"ASEBO_projector": 12, "PersistentES": 7, "NoiseReuseES": 7}


def _jax_args(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)


def _port_args(args):
    return tuple(t(a) if isinstance(a, np.ndarray) else a for a in args)


def _make(name, jprob, center=CENTER):
    cls, args, kw, draws, exact, pop_exact = ALGOS[name]
    jalgo = getattr(jalgorithms, cls)(*_jax_args(args(center)), **kw)
    algo = type(f"Injected{cls}", (Injected, getattr(algorithms, cls)), {})(
        *_port_args(args(center)), device="cpu", **kw)
    return jalgo, algo, draws, exact, pop_exact


def _check_leaf(k, got, want, exact, what):
    assert got.shape == want.shape and got.dtype == want.dtype, (what, k, got.dtype, want.dtype)
    if k in exact or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {k}")
    elif k not in INVARIANT:
        assert rel(got, want) <= LEAF_RTOL, (what, k, rel(got, want))


def _check_invariants(ts, js, what):
    """CMA-ES's decomposition and ASEBO's projectors, by what they must
    satisfy, against JAX's."""
    if "C_invsqrt" in js:
        C = np.asarray(js["C"], np.float64)
        C = (C + C.T) / 2
        A = np.asarray(ts["A"], np.float64)
        jA = np.asarray(js["A"], np.float64)
        # The eigenvalues (clipped at 1e-8) are the squared column norms.
        assert rel(np.sort(np.sum(A * A, axis=0)), np.sort(np.sum(jA * jA, axis=0))) <= FACTOR_RTOL, what
        assert rel(A @ A.T, jA @ jA.T) <= FACTOR_RTOL, what
        assert rel(ts["C_invsqrt"], js["C_invsqrt"]) <= FACTOR_RTOL, what
    if "UUT" in js and float(js["gen_counter"]) > js["grad_subspace"].shape[0] + 1:
        # ASEBO out of its warm-up (the step that made this state read a
        # full history): the projectors are unique where the singular
        # values are apart.  Before, U U^T is 0 on both sides (exact) and
        # the complement, spanned partly by directions of zero singular
        # value, is not unique and not read.
        for k in ("UUT", "UUT_ort"):
            assert rel(ts[k], js[k]) <= FACTOR_RTOL, (what, k)


def _parity(name, gens):
    jprob = JRecorded(JSphere())
    jalgo, algo, draws, exact, pop_exact = _make(name, jprob)
    jwf = JWorkflow(jalgo, jprob)
    prob = Recorded(JSphere())
    wf = StdWorkflow(algo, prob)
    js = jeval(jwf.init_step, jwf.init(jax.random.key(7)))
    params = [f"algorithm.{k}" for k in js.algorithm.param_keys]
    for gen in range(gens):
        # The whole state carried across: factors, paths, moments, int and
        # float counters, and the Parameter labels.
        ts = state_from_numpy(to_numpy(js), device="cpu", params=params)
        assert ts.algorithm.param_keys == set(js.algorithm.param_keys)
        algo.next_draws = jeval(draws, js.algorithm, jalgo)
        ts = wf.step(ts)
        assert ts.algorithm.param_keys == set(js.algorithm.param_keys)
        js = jeval(jwf.step, js)
        what = f"{name} generation {gen + 1}"
        jp, tp = jprob.pops[-1], prob.pops[-1].numpy()
        if pop_exact:
            np.testing.assert_array_equal(tp, jp, err_msg=f"{what}: population")
        else:
            assert rel(tp, jp) <= LEAF_RTOL, (what, "population", rel(tp, jp))
        jn, tn = to_numpy(js)["algorithm"], {k: v.numpy() for k, v in ts.algorithm.items()}
        assert set(tn) == set(jn), what
        for k in jn:
            if k != "key":
                _check_leaf(k, tn[k], jn[k], exact, what)
        _check_invariants(tn, jn, what)
    return ts, js


@pytest.mark.parametrize("name", list(ALGOS))
def test_steps_match_jax_with_injected_draws(name):
    _parity(name, PARITY_GENS.get(name, GENS))


def test_resets_and_reuse_branches_fire():
    """With T = 30 and K = 10 PersistentES resets its accumulator and
    NoiseReuseES takes fresh noise at the third generation; ASEBO leaves
    its warm-up after subspace_dims generations."""
    # init_step counts K too: the counter reads 10, 20, then resets.
    ts, _ = _parity("PersistentES", 2)
    assert float(ts.algorithm.inner_step_counter) == 0.0 and not bool(ts.algorithm.pert_accum.any())
    ts, _ = _parity("NoiseReuseES", 3)
    assert float(ts.algorithm.inner_step_counter) == 10.0
    ts, js = _parity("ASEBO_projector", 10)
    assert float(ts.algorithm.gen_counter) == 11.0 and bool(ts.algorithm.UUT.any())


@pytest.mark.parametrize("every", [2, 3])
def test_cmaes_cadence_keeps_or_renews_the_decomposition_as_jax(every):
    """``decomp_per_iter`` > 1: JAX's ``lax.cond`` against the port's
    ``torch.where``.  Between decompositions both keep the carried ``A``
    and ``C^{-1/2}`` bit for bit; at a decomposition both renew them."""
    jalgo, algo, draws, *_ = _make("CMAES", None)
    jalgo.decomp_per_iter = algo.decomp_per_iter = every
    jwf = JWorkflow(jalgo, JSphere())
    wf = StdWorkflow(algo, Recorded(JSphere()))
    js = jeval(jwf.init_step, jwf.init(jax.random.key(1)))
    for gen in range(1, 2 * every + 1):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = jeval(draws, js.algorithm, jalgo)
        before = ts.algorithm
        ts = wf.step(ts).algorithm
        js = jeval(jwf.step, js)
        jn = to_numpy(js)["algorithm"]
        # iteration counts init_step too: generation gen is iteration gen + 1.
        due = (gen + 1) % every == 0
        for k in ("A", "C_invsqrt"):
            kept = np.array_equal(jn[k], before[k].numpy())
            assert kept == (not due), (every, gen, k)
            if not due:
                np.testing.assert_array_equal(ts[k].numpy(), before[k].numpy())
        if due:
            A = ts.A.double().numpy()
            jA = np.asarray(jn["A"], np.float64)
            assert rel(A @ A.T, jA @ jA.T) <= FACTOR_RTOL
            assert rel(ts.C_invsqrt, jn["C_invsqrt"]) <= FACTOR_RTOL


@pytest.mark.parametrize("dim,pop", [(20, 64), (200, None), (1000, None), (DIM, POP)])
def test_cmaes_constants_and_cadence_match_jax(dim, pop):
    j = jalgorithms.CMAES(jnp.zeros(dim), 1.0, pop_size=pop)
    p = algorithms.CMAES(torch.zeros(dim), 1.0, pop_size=pop, device="cpu")
    assert p.pop_size == j.pop_size and p.mu == j.mu and p.decomp_per_iter == j.decomp_per_iter
    for k in ("mu_eff", "chi_n", "c_sigma", "d_sigma", "c_c", "c_1", "c_mu"):
        assert getattr(p, k) == pytest.approx(getattr(j, k), rel=1e-6), k
    assert rel(p.weights, j.weights) <= LEAF_RTOL
    if dim == 20:
        assert j.decomp_per_iter == 1  # cmaes_cec decomposes every generation
    if dim == 1000:
        assert j.decomp_per_iter == 8


@pytest.mark.parametrize("name", ["CMAES", "OpenES_adam"])
def test_whole_slice_with_the_ports_cec2022(name):
    """The port's CMA-ES and OpenES on the port's CEC2022 f1 (D = 20, the
    bench configs' problem) against JAX's on JAX's: the populations within
    LEAF_RTOL (OpenES's bit for bit), the fitness within the CEC2022
    float32 tolerance."""
    d = 20
    center = np.zeros(d, np.float32)
    jalgo, algo, draws, _, pop_exact = _make(name, None, center)
    jwf = JWorkflow(jalgo, JRecorded(JCEC2022(1, d)))
    wf = StdWorkflow(algo, CEC2022(1, d, device="cpu"))
    js = jeval(jwf.init_step, jwf.init(jax.random.key(5)))
    for _ in range(3):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = jeval(draws, js.algorithm, jalgo)
        ts = wf.step(ts).algorithm
        js = jeval(jwf.step, js)
        jfit = np.asarray(js.algorithm.fit)
        assert rel(ts.fit, jfit) <= CEC_RTOL
        np.testing.assert_allclose(ts.fit.numpy(), jfit, rtol=CEC_RTOL)


# ---------------------------------------------------------------------------
# Whole runs, setup, draws, refusals
# ---------------------------------------------------------------------------

RUN_GENS = 30
# Both sides, 30 generations of Sphere from one seed with their own draws
# (Philox against threefry): the best fitness must not rise, and the two
# improvement factors must lie within this ratio of each other (measured
# 1.0-3.1, and 20 for NoiseReuseES, whose reused noise ties its run most
# to the draws; the draws differ, so only the order of magnitude is held).
IMPROVEMENT_RATIO = 100


@pytest.mark.parametrize("name", list(ALGOS))
def test_thirty_generations_improve_on_both_sides(name):
    jalgo, algo = _make(name, None)[0], _algo(name)
    jmon, mon = JEvalMonitor(full_fit_history=False), EvalMonitor(full_fit_history=False)
    jwf, wf = JWorkflow(jalgo, JSphere(), monitor=jmon), StdWorkflow(algo, Sphere(), monitor=mon)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(3)))
    ts = wf.init_step(wf.init(3))
    j0, t0 = float(jnp.min(js.algorithm.fit)), float(ts.algorithm.fit.min())
    jstep = jax.jit(jwf.step)
    for _ in range(RUN_GENS):
        js, ts = jstep(js), wf.step(ts)
    j1, t1 = float(jmon.get_best_fitness(js.monitor)), float(mon.get_best_fitness(ts.monitor))
    assert j1 <= j0 and t1 <= t0, (name, j0, j1, t0, t1)
    fj, ft = j0 / max(j1, 1e-30), t0 / max(t1, 1e-30)
    assert max(fj, ft) / min(fj, ft) <= IMPROVEMENT_RATIO, (name, fj, ft)


def _algo(name, **extra):
    cls, args, kw, *_ = ALGOS[name]
    return getattr(algorithms, cls)(*_port_args(args(CENTER)), device="cpu", **{**kw, **extra})


@pytest.mark.parametrize("name", list(ALGOS))
def test_run_and_segment_equal_eager_steps_on_the_cpu(name):
    """``run(20)`` and ``run_segment(20)`` against 20 eager steps, every leaf
    and the monitor's auxiliary history bit for bit."""
    mon = EvalMonitor(full_pop_history=True)
    wf = StdWorkflow(_algo(name), Sphere(), monitor=mon)
    s0 = wf.step(wf.init_step(wf.init(11)))
    n0 = len(mon.aux_history[mon.aux_keys[0]])
    s = s0
    for _ in range(20):
        s = wf.step(s)
    stepped = {k: v[n0:] for k, v in mon.aux_history.items()}
    seg, tel = wf.run_segment(s0, 20)
    wf.flush_telemetry(tel)
    flushed = {k: v[n0 + 20:] for k, v in mon.aux_history.items()}
    fused = wf.run(s0, 20, init=False)
    for st in (seg, fused):
        for k in s.algorithm:
            torch.testing.assert_close(st.algorithm[k], s.algorithm[k], rtol=0, atol=0, equal_nan=True)
    cls, args, kw, *_ = ALGOS[name]
    jalgo = getattr(jalgorithms, cls)(*_jax_args(args(CENTER)), **kw)
    assert list(flushed) == list(stepped) == list(jalgo.record_step(jalgo.setup(jax.random.key(0))))
    for k in stepped:
        assert len(flushed[k]) == len(stepped[k]) == 20
        for a, b in zip(flushed[k], stepped[k]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_setup_layout_matches_jax():
    for name, (cls, args, kw, *_) in ALGOS.items():
        jalgo = getattr(jalgorithms, cls)(*_jax_args(args(CENTER)), **kw)
        js, ts = jalgo.setup(jax.random.key(0)), _algo(name).setup(rng.key(0))
        assert set(ts) == set(js), name
        assert ts.param_keys == set(js.param_keys), name
        for k in js:
            if k != "key":
                assert tuple(ts[k].shape) == js[k].shape, (name, k)
                assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype), (name, k)


# Draw-kernel launches (one rng.normal each) a generation, and at setup.
DRAWS_PER_GEN = {"GuidedES": 2}
SETUP_DRAWS = {"GuidedES": 1}


@pytest.mark.parametrize("name", list(ALGOS))
def test_each_draw_is_one_launch_from_consecutive_seeds(name, monkeypatch):
    calls = []
    real = philox.philox_draws_plain

    def spy(seed, numel, kinds, device):
        calls.append((int(seed.key[1]), seed.index, numel))
        return real(seed, numel, kinds, device)

    monkeypatch.setattr(philox, "philox_draws_plain", spy)
    algo = _algo(name)
    wf = StdWorkflow(algo, Sphere())
    s = wf.init(0)
    assert len(calls) == SETUP_DRAWS.get(ALGOS[name][0], 0)
    s = wf.init_step(s)
    calls.clear()
    s = wf.step(s)
    k = DRAWS_PER_GEN.get(ALGOS[name][0], 1)
    assert [c[1] for c in calls] == list(range(k)) and len({c[0] for c in calls}) == 1
    calls.clear()
    wf.step(s)
    assert len(calls) == k


REFUSED = [
    ("CMAES", lambda: algorithms.CMAES(torch.zeros(3), 0.0, device="cpu")),
    ("OpenES", lambda: algorithms.OpenES(15, torch.zeros(3), 0.1, 0.1, device="cpu")),
    ("OpenES", lambda: algorithms.OpenES(16, torch.zeros(3), 0.1, 0.1, optimizer="sgd", device="cpu")),
    ("SNES", lambda: algorithms.SNES(1, torch.zeros(3), device="cpu")),
    ("SNES", lambda: algorithms.SNES(8, torch.zeros(3), weight_type="other", device="cpu")),
    ("DES", lambda: algorithms.DES(1, torch.zeros(3), device="cpu")),
    ("ARS", lambda: algorithms.ARS(7, torch.zeros(3), device="cpu")),
    ("ARS", lambda: algorithms.ARS(8, torch.zeros(3), elite_ratio=1.5, device="cpu")),
    ("ESMC", lambda: algorithms.ESMC(8, torch.zeros(3), device="cpu")),
    ("PersistentES", lambda: algorithms.PersistentES(7, torch.zeros(3), device="cpu")),
    ("NoiseReuseES", lambda: algorithms.NoiseReuseES(7, torch.zeros(3), device="cpu")),
    ("GuidedES", lambda: algorithms.GuidedES(7, torch.zeros(3), device="cpu")),
    ("ASEBO", lambda: algorithms.ASEBO(7, torch.zeros(3), device="cpu")),
    ("XNES", lambda: algorithms.XNES(torch.zeros(3), torch.eye(3), pop_size=4,
                                     recombination_weights=torch.arange(4.0), device="cpu")),
    ("SeparableNES", lambda: algorithms.SeparableNES(torch.zeros(3), torch.ones(4), device="cpu")),
    ("SeparableNES", lambda: algorithms.SeparableNES(torch.zeros(3), torch.ones(3), pop_size=4,
                                                     recombination_weights=torch.ones(5), device="cpu")),
]


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_constructors_refuse_what_jax_refuses(i):
    with pytest.raises(ValueError):
        REFUSED[i][1]()


@pytest.mark.parametrize("name", list(ALGOS))
def test_entry_points_run_on_the_card_by_default(name):
    """Without ``device=`` an algorithm goes to the CUDA card, and raises
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    cls, args, kw, *_ = ALGOS[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(algorithms, cls)(*_port_args(args(CENTER)), **kw)


def test_port_modules_import_no_jax():
    """The ES modules, the linear algebra, the monitor and the build of the
    port, ``chip_smoke.py`` and the capture probe name neither ``jax`` nor
    the JAX package in any import."""
    root = Path(algorithms.__file__).resolve().parent.parent
    files = sorted((root / "algorithms" / "so" / "es_variants").glob("*.py"))
    files += [root / "ops" / "linalg.py", root / "workflows" / "eval_monitor.py", root / "ops" / "_build.py",
              root.parent / "chip_smoke.py", root.parent / "tools" / "linalg_capture_probe" / "probe.py"]
    assert len(files) >= 19
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert not (n == "jax" or n.startswith("jax.") or n.startswith("evox_tpu.")
                            or n == "evox_tpu"), (f, n)


def test_cmaes_runs_in_float64():
    """The ES algorithms take a ``dtype``; CMA-ES in float64 decomposes in
    float64."""
    algo = algorithms.CMAES(torch.zeros(5, dtype=torch.float64), 1.0, dtype=torch.float64, device="cpu")
    wf = StdWorkflow(algo, Sphere())
    s = wf.step(wf.init_step(wf.init(0)))
    assert s.algorithm.A.dtype == torch.float64 and math.isfinite(float(s.algorithm.sigma))
