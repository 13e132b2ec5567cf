"""The blocked Jacobi eigensolver of the card (``csrc/eigh_jacobi.cu``)
through its plain PyTorch version, ``ops.linalg.eigh_jacobi_plain``, the
same algorithm, against ``jnp.linalg.eigh`` on the CPU, and the ES steps
that reach it.

Inputs come from numpy seeds at n = 33, 48, 64 and 100 (one, one, one and
two block pairs of 64), in float32 and float64.  The decompositions are
compared by invariants, as ``test_torch_es.py`` does: eigenvalues, ``V
diag(w) V^T`` against ``C`` and ``V^T V`` against ``I``, relative to
``|C|_2``.  CMA-ES (d = 64) and ASEBO (d = 48) are stepped with the card's
algorithm in place of the CPU's LAPACK route (``mirror``: ``ops.linalg.eigh``
answered by the plain Jacobi version, as the card answers it above
n = 32), from states carried across from JAX with JAX's normals
injected.  The kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu import algorithms as jalgorithms  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch import algorithms  # noqa: E402
from evox_tpu_torch.ops import linalg  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.utils.vmap_ops import VmapInfo  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402
from test_torch_es import FACTOR_RTOL, LEAF_RTOL, Recorded, _full, _normals, jeval, rel  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402
from test_torch_rvea import Injected  # noqa: E402

SIZES = [33, 48, 64, 100]
DTYPES = ["float32", "float64"]
# The invariants relative to |C|_2.  float32: the plain version measured
# 7.5e-7 (eigenvalues), 9.1e-7 (reconstruction) and 5.0e-7
# (orthogonality) at n = 100, 2.6e-6 with a spectrum of three values of
# multiplicity 33, so 2e-5 holds with room; float64: at most
# 2.1e-13 measured, held at 1e-11.
TOL = {"float32": 2e-5, "float64": 1e-11}
CSRC = Path(linalg.__file__).resolve().parent.parent / "csrc" / "eigh_jacobi.cu"


def _spectrum(n, kind):
    if kind == "spread":
        return np.geomspace(1.0, 1e3, n)
    if kind == "repeated":  # three values, each many times
        return np.repeat([1.0, 2.0, 5.0], -(-n // 3))[:n]
    raise ValueError(kind)


def _sym(n, seed, dtype, kind="spread"):
    r = np.random.default_rng(seed)
    q, _ = np.linalg.qr(r.standard_normal((n, n)))
    return ((q * _spectrum(n, kind)) @ q.T).astype(dtype)


def _jax_eigh(C):
    with jax.enable_x64(C.dtype == np.float64):
        w, v = jnp.linalg.eigh(jnp.asarray(C))
        return np.asarray(w, np.float64), np.asarray(v, np.float64)


def _invariants(C, w, V):
    """(eigenvalue error against JAX's, reconstruction, orthogonality),
    each relative to |C|_2."""
    C64 = np.asarray(C, np.float64)
    jw, _ = _jax_eigh(C)
    w, V = np.asarray(w, np.float64), np.asarray(V, np.float64)
    norm = np.linalg.norm(C64, 2)
    return (np.abs(w - jw).max() / norm, np.linalg.norm((V * w) @ V.T - C64, 2) / norm,
            np.abs(V.T @ V - np.eye(len(w))).max())


def mirror(C, due=None):
    """``ops.linalg.eigh`` as the card answers it above n = 32 (the Jacobi
    algorithm, with ``due``), on the CPU."""

    def jacobi(X):
        w, V, _, _ = linalg.eigh_jacobi_plain(X[None], None if due is None else due.reshape(1))
        return w[0], V[0]

    return linalg._nan_unless_finite(jacobi, C)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_eigh_by_invariants(n, dtype):
    C = _sym(n, n, dtype)
    w, V, sweeps, off = linalg.eigh_jacobi_plain(t(C)[None])
    assert w.dtype == V.dtype == getattr(torch, dtype) and V.shape == (1, n, n)
    assert bool((w[0, 1:] >= w[0, :-1]).all())
    assert all(e <= TOL[dtype] for e in _invariants(C, w[0].numpy(), V[0].numpy()))
    assert 0 < int(sweeps[0]) <= linalg.MAX_SWEEPS[getattr(torch, dtype)]
    assert float(off[0]) <= np.linalg.norm(C.astype(np.float64)) * TOL[dtype]


# Two block pairs (n = 100) in float32 only: float64 there takes 21 sweeps
# of the plain version, its slowest case; chip_smoke.py holds the kernel
# on it in both types.
@pytest.mark.parametrize("n,dtype", [(48, "float32"), (48, "float64"), (100, "float32")])
def test_repeated_eigenvalues_converge(n, dtype):
    C = _sym(n, n + 1, dtype, "repeated")
    w, V, sweeps, _ = linalg.eigh_jacobi_plain(t(C)[None])
    assert all(e <= TOL[dtype] for e in _invariants(C, w[0].numpy(), V[0].numpy()))
    np.testing.assert_allclose(np.unique(np.round(w[0].numpy(), 3)), [1.0, 2.0, 5.0])
    assert int(sweeps[0]) < linalg.MAX_SWEEPS[getattr(torch, dtype)]


@pytest.mark.parametrize("dtype", DTYPES)
def test_identity_takes_no_sweep_and_comes_back_exact(dtype):
    """CMA-ES starts from C = I: no rotation, the identity's own bits."""
    eye = torch.eye(64, dtype=getattr(torch, dtype))
    for n in (33, 64):
        w, V, sweeps, off = linalg.eigh_jacobi_plain(eye[None, :n, :n])
        assert int(sweeps[0]) == 0 and float(off[0]) == 0.0
        assert torch.equal(w[0], torch.ones(n, dtype=eye.dtype)) and torch.equal(V[0], eye[:n, :n])
    # A diagonal matrix: its entries sorted, the identity's columns permuted.
    d = torch.tensor([3.0, -1.0, 2.0] + [0.5] * 37, dtype=eye.dtype)
    w, V, sweeps, _ = linalg.eigh_jacobi_plain(torch.diag(d)[None])
    assert int(sweeps[0]) == 0 and torch.equal(w[0], torch.sort(d, stable=True).values)
    assert torch.equal(V[0], torch.eye(40, dtype=eye.dtype)[:, torch.sort(d, stable=True).indices])


def test_a_batch_is_its_matrices_one_by_one():
    Cs = np.stack([_sym(48, s, np.float32) for s in range(2)])
    w, V, sweeps, off = linalg.eigh_jacobi_plain(t(Cs))
    for i in range(2):
        wi, Vi, si, oi = linalg.eigh_jacobi_plain(t(Cs[i])[None])
        assert torch.equal(w[i], wi[0]) and torch.equal(V[i], Vi[0])
        assert int(sweeps[i]) == int(si[0]) and float(off[i]) == float(oi[0])


def test_not_due_leaves_the_starting_point():
    """``due`` false: no sweep, off 0, and the result is where the sweeps
    start, the diagonal sorted with the identity's columns; the due
    matrices of the same batch are those of a batch of their own."""
    Cs = t(np.stack([_sym(40, s, np.float32) for s in range(2)]))
    due = torch.tensor([False, True])
    w, V, sweeps, off = linalg.eigh_jacobi_plain(Cs, due)
    d, order = torch.sort(Cs[0].diagonal(), stable=True)
    assert torch.equal(w[0], d) and torch.equal(V[0], torch.eye(40)[:, order])
    assert int(sweeps[0]) == 0 and float(off[0]) == 0.0
    ws, Vs, ss, _ = linalg.eigh_jacobi_plain(Cs[1:])
    assert torch.equal(w[1:], ws) and torch.equal(V[1:], Vs) and torch.equal(sweeps[1:], ss)
    # eigh's own route on the CPU computes regardless of due.
    full = linalg.eigh(Cs[0])
    for a, b in zip(linalg.eigh(Cs[0], due=torch.tensor(False)), full):
        assert torch.equal(a, b)


def test_non_finite_input_is_all_nan_on_the_jacobi_route():
    C = t(_sym(50, 3, np.float32))
    C[7, 9] = C[9, 7] = float("inf")
    w, V = mirror(C)
    assert bool(torch.isnan(w).all()) and bool(torch.isnan(V).all())
    # The solver itself sees zeros: no sweep, a finite result.
    w, V, sweeps, _ = linalg.eigh_jacobi_plain(torch.zeros(1, 50, 50))
    assert int(sweeps[0]) == 0 and bool(torch.isfinite(V).all()) and not bool(w.any())


def test_vmap_rule_merges_matrices_and_predicates(monkeypatch):
    """``torch.func.vmap`` of ``eigh`` at a level of 3 instances of 1 matrix
    each reaches the card's route as one stack of 3 with its 3 predicates
    (and with the predicate broadcast when it is not batched)."""
    seen = []

    def recording(C, due, solo):
        seen.append((C.clone(), None if due is None else due.clone(), solo))
        return torch.linalg.eigh(C)

    monkeypatch.setattr(linalg, "_op", recording)
    C = torch.stack([torch.eye(40) * (i + 1) for i in range(3)])[:, None]
    due = torch.tensor([[True], [False], [True]])
    (w, V), dims = linalg._merge_rule(VmapInfo(3), (0, 0, None), C, due, 1)
    assert dims == (0, 0) and w.shape == (3, 1, 40) and V.shape == (3, 1, 40, 40)
    got_C, got_due, solo = seen[-1]
    assert solo == 0 and torch.equal(got_C, C[:, 0]) and got_due.tolist() == [True, False, True]
    linalg._merge_rule(VmapInfo(3), (0, None, None), C, torch.tensor([False]), 1)
    assert seen[-1][1].tolist() == [False, False, False]
    linalg._merge_rule(VmapInfo(3), (0, None, None), C, None, 1)
    assert seen[-1][1] is None


def test_kernel_constants_are_the_plain_versions():
    """The algorithm's constants in the CUDA source and in the plain version
    agree (the block width, the rotation floor, and the threads a block,
    which fix the order of the sums of squares), as do the kernel's phases
    that the plain version mirrors: the apply's tiles on the two halves of a
    block, each pair's solver and J block."""
    src = CSRC.read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(const("kBw")) == linalg._BW and const("kTile") == "2 * kBw"
    assert eval(const("kFloorRel")) == linalg._FLOOR_REL
    assert int(const("kThreads")) == linalg._THREADS and const("kHalf") == "kThreads / 2"
    assert const("kRounds") == "kTile - 1" and const("kUpper") == "kPairs * (kPairs - 1) / 2"
    # The pairings: the kernel's pair_of is the plain version's _pairs.
    for m in (2, 4, 32, 64):
        for r in range(m - 1):
            pairs = linalg._pairs(m, r)
            assert sorted(i for pq in pairs for i in pq) == list(range(m))
        every = {pq for r in range(m - 1) for pq in linalg._pairs(m, r)}
        assert len(every) == m * (m - 1) // 2


@pytest.mark.parametrize("batch,N,per_sm,sms,want", [
    (1, 1024, 1, 132, 132),  # n = 1000: every SM, fewer than the 2 x 256 tiles
    (1, 64, 1, 132, 2),      # n = 64: the pair's solver and its J block
    (4, 64, 1, 132, 8),      # 4 vmapped CMAES(64)
    (1, 128, 1, 132, 8),     # n = 100: 2 pairs, 4 tiles
    (3, 2048, 2, 132, 264),
])
def test_launch_plan_keeps_every_block_resident(batch, N, per_sm, sms, want):
    """The cooperative launch's grid: no more blocks than the card holds at
    once (``per_sm`` a multiprocessor), nor than the largest phase's items
    (each tile's V product and sums of squares)."""
    assert linalg._grid(batch, N, per_sm, sms) == want


def _bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def test_a_pair_below_the_threshold_keeps_the_identity():
    """A 64 x 64 sub-matrix with no entry above the rotation test keeps J = I
    exactly and does not rotate, with or without the skip (the kernel skips
    its 63 rounds); beside it in the same round a pair that rotates gets the
    same J either way, bit for bit."""
    eps, fro = torch.finfo(torch.float32).eps, 1.0
    floor = eps * fro * linalg._FLOOR_REL
    r = np.random.default_rng(7)
    quiet = np.diag(r.uniform(1, 2, 64)) + np.triu(r.uniform(-1, 1, (64, 64)) * floor / 2, 1)
    quiet = quiet + np.triu(quiet, 1).T
    loud = _sym(64, 8, np.float64)
    S = t(np.stack([quiet, loud, quiet]))
    assert bool(linalg._above(S, eps, floor).tolist() == [False, True, False])
    J, rot = linalg._inner_plain(S, eps, floor, skip=True)
    J0, rot0 = linalg._inner_plain(S, eps, floor, skip=False)
    assert rot.tolist() == rot0.tolist() == [False, True, False]
    eye = torch.eye(64, dtype=torch.float64)
    assert torch.equal(_bits(J[0]), _bits(eye)) and torch.equal(_bits(J[2]), _bits(eye))
    assert torch.equal(_bits(J), _bits(J0))


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_sweep_is_bit_identical_with_and_without_the_skip(dtype):
    """A matrix of two coupled 32-column blocks among four decoupled ones
    (n = 192: pairs that never rotate, tiles whose J are all I): the sweeps
    with the kernel's skips (solves, A and V tiles) give the bits of the
    sweeps without them."""
    n = 192
    C = np.diag(np.linspace(1.0, 3.0, n))
    C[:64, :64] = _sym(64, 11, np.float64) + 2 * np.eye(64)
    C = C.astype(dtype)
    runs = []
    for skip in (True, False):
        W, V = linalg._start(t(C)[None])
        sweeps, off = linalg._sweeps_plain(W[0], V[0], skip)
        runs.append((W, V, sweeps, off))
    (W1, V1, s1, o1), (W0, V0, s0, o0) = runs
    assert 0 < s1 == s0 and o1 == o0
    assert torch.equal(_bits(W1), _bits(W0)) and torch.equal(_bits(V1), _bits(V0))


def _norms_reference(W, threads):
    """|W|_F and off(W) of the padded float64 matrix W in the kernel's
    order, written as loops: each 64 x 64 tile (row-major) by ``threads``
    threads, thread t its entries t, t + threads, ... from 0, then the tree
    t += t + s, s = threads/2 ... 1; the tiles' sums in row-major order."""
    W = np.asarray(W, np.float64)
    P = W.shape[0] // 64
    sums = [0.0, 0.0]
    for ti in range(P):
        for tj in range(P):
            tile = W[64 * ti:64 * ti + 64, 64 * tj:64 * tj + 64].reshape(-1)
            acc = np.zeros((2, threads))
            for t_ in range(threads):
                for e in range(t_, 4096, threads):
                    v2 = tile[e] * tile[e]
                    acc[0, t_] += v2
                    if ti != tj or e // 64 != e % 64:
                        acc[1, t_] += v2
            s_ = threads // 2
            while s_:
                acc[:, :s_] = acc[:, :s_] + acc[:, s_:2 * s_]
                s_ //= 2
            sums[0] += float(acc[0, 0])
            sums[1] += float(acc[1, 0])
    return float(np.sqrt(sums[0])), float(np.sqrt(sums[1]))


def test_off_is_summed_in_the_kernel_order():
    """The plain version's |A|_F and off(A) are the kernel's sums of squares
    (tiles, threads, tree, tiles' sums), bit for bit against the order
    written as loops, for one matrix and for each matrix of a batch: the
    matrices here are done before a sweep (off(A) <= eps sqrt(N) |A|_F), so
    ``off`` is the starting point's."""
    r = np.random.default_rng(3)
    mats = []
    for n in (40, 100, 128):
        d = np.diag(r.uniform(0.5, 2.0, n))
        noise = np.triu(r.standard_normal((n, n)), 1) * 1e-18
        mats.append(d + noise + noise.T)
    for C in mats:
        W, _ = linalg._start(t(C)[None])
        assert linalg._norms(W[0]) == _norms_reference(W[0].numpy(), linalg._THREADS)
        assert np.isclose(linalg._norms(W[0])[1], np.linalg.norm(C - np.diag(np.diag(C))), rtol=1e-14)
    # One matrix, then a batch of two of the same size.
    for stack in ([mats[0]], [mats[1], mats[1] * 0.5]):
        Cs = t(np.stack(stack))
        _, _, sweeps, off = linalg.eigh_jacobi_plain(Cs)
        for i, C in enumerate(stack):
            W, _ = linalg._start(t(C)[None])
            assert int(sweeps[i]) == 0 and float(off[i]) == _norms_reference(W[0].numpy(), linalg._THREADS)[1]


def test_the_lower_triangle_is_read():
    """The Jacobi route reads the lower triangle, as cuSOLVER and the CPU's
    eigh do: an upper triangle of noise changes nothing."""
    C = _sym(48, 5, np.float32)
    noisy = C + np.triu(np.random.default_rng(1).standard_normal((48, 48)).astype(np.float32), 1)
    a = linalg.eigh_jacobi_plain(t(C)[None])
    b = linalg.eigh_jacobi_plain(t(noisy)[None])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _jax_decompose(C):
    """JAX's CMA-ES ``decompose`` (``cma_es.py``, inside ``step``)."""
    C = (C + C.T) / 2
    eigvals, B = jnp.linalg.eigh(C)
    eigvals = jnp.clip(eigvals, 1e-8, None)
    return B * jnp.sqrt(eigvals), (B * (1.0 / jnp.sqrt(eigvals))) @ B.T


def test_cmaes_decompose_on_the_mirror_matches_jax(monkeypatch):
    monkeypatch.setattr(linalg, "eigh", mirror)
    r = np.random.default_rng(64)
    U = r.standard_normal((64, 12)).astype(np.float32) / 8
    C = (np.eye(64, dtype=np.float32) * 0.7 + U @ U.T).astype(np.float32)
    A, inv = algorithms.CMAES.decompose(t(C))
    jA, jinv = (np.asarray(x, np.float64) for x in _jax_decompose(jnp.asarray(C)))
    A = A.double().numpy()
    assert rel(A @ A.T, jA @ jA.T) <= FACTOR_RTOL
    assert rel(inv, jinv) <= FACTOR_RTOL
    # Not due: the starting point, which the step discards.
    A0, _ = algorithms.CMAES.decompose(t(C), torch.tensor(False))
    assert bool((A0 != 0).sum(0).eq(1).all())  # a column of the identity, scaled
    torch.testing.assert_close(torch.sort((A0 * A0).sum(0)).values, torch.sort(t(C).diagonal()).values,
                               rtol=1e-6, atol=0)


def test_cmaes_step_on_the_mirror_matches_jax(monkeypatch):
    """CMA-ES at d = 64 from a state carried across from JAX, JAX's normals
    injected, the decomposition on the card's algorithm, with
    ``decomp_per_iter`` 2: a due generation, then a kept one (``due``
    false, the cached factors bit for bit)."""
    monkeypatch.setattr(linalg, "eigh", mirror)
    dim, pop, every = 64, 16, 2
    jalgo = jalgorithms.CMAES(jnp.ones(dim), 1.0, pop_size=pop)
    algo = type("InjectedCMAES", (Injected, algorithms.CMAES), {})(torch.ones(dim), 1.0, pop_size=pop, device="cpu")
    jalgo.decomp_per_iter = algo.decomp_per_iter = every
    jwf = JWorkflow(jalgo, JSphere())
    wf = StdWorkflow(algo, Recorded(JSphere()))
    draws = _normals(_full)
    # JAX's steps compiled whole: the comparison is by tolerance and
    # invariants, so XLA's fused arithmetic is no obstacle.
    jstep = jax.jit(jwf.step)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(3)))
    for gen in range(2):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        before = {k: ts.algorithm[k].numpy().copy() for k in ("A", "C_invsqrt")}
        algo.next_draws = jeval(draws, js.algorithm, jalgo)
        ts = wf.step(ts).algorithm
        js = jstep(js)
        jn = to_numpy(js)["algorithm"]
        for k in ("mean", "sigma", "p_sigma", "p_c", "C", "fit"):
            assert rel(ts[k].numpy(), jn[k]) <= LEAF_RTOL, (gen, k)
        A, jA = ts.A.double().numpy(), np.asarray(jn["A"], np.float64)
        assert rel(A @ A.T, jA @ jA.T) <= FACTOR_RTOL, gen
        assert rel(ts.C_invsqrt, jn["C_invsqrt"]) <= FACTOR_RTOL, gen
        if gen == 1:  # iteration 3: not due, the carried factors kept
            np.testing.assert_array_equal(ts.A.numpy(), before["A"])
            np.testing.assert_array_equal(ts.C_invsqrt.numpy(), before["C_invsqrt"])


def test_asebo_projectors_on_the_mirror_match_jax(monkeypatch):
    """ASEBO at d = 48 out of its warm-up (a full gradient history carried
    across from JAX): its projectors from ``svd_vh`` on the card's route,
    the Gram matrix's Jacobi eigenvectors, against JAX's SVD.  asebo.py is
    unchanged: it reaches the new solver through ``svd_vh`` alone."""
    monkeypatch.setattr(linalg, "eigh", mirror)
    monkeypatch.setattr(linalg, "svd_vh", linalg._gram_vh)
    dim, pop = 48, 16
    jalgo = jalgorithms.ASEBO(pop, jnp.ones(dim))
    algo = type("InjectedASEBO", (Injected, algorithms.ASEBO), {})(pop, torch.ones(dim), device="cpu")
    jwf = JWorkflow(jalgo, JSphere())
    wf = StdWorkflow(algo, Recorded(JSphere()))
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(5)))
    history = np.random.default_rng(48).standard_normal((dim, dim)).astype(np.float32)
    js = js.replace(algorithm=js.algorithm.replace(grad_subspace=jnp.asarray(history),
                                                   gen_counter=jnp.asarray(float(dim + 1))))
    ts = state_from_numpy(to_numpy(js), device="cpu")
    algo.next_draws = jeval(_normals(lambda a: (a.dim, a.pop_size // 2)), js.algorithm, jalgo)
    ts = wf.step(ts).algorithm
    jn = to_numpy(jax.jit(jwf.step)(js))["algorithm"]
    for k in ("UUT", "UUT_ort"):
        assert rel(ts[k].numpy(), jn[k]) <= FACTOR_RTOL, k
    assert rel(ts.center.numpy(), jn["center"]) <= LEAF_RTOL
