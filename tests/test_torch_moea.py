"""The port's NSGA-III, MOEA/D and HypE (``evox_tpu_torch.algorithms.mo``)
against the JAX package's, on the CPU, and the ``tests/test_moea.py``
contract on the port's whole multi-objective family.

Each generation starts both frameworks from the same state (carried across
with ``state_from_numpy``) and the port is handed JAX's draws through its
``_draws`` seam.  Tolerances: ranks, survivors' order, neighbour tables and
NaN places exactly; population, fitness and ideal points at rtol 1e-5
(float32 ``pow``/``sin``/``cos``/``sqrt`` and sums may differ in the last
bits); the normalization and hypervolume contributions at rtol 1e-5."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from evox_tpu.algorithms import MOEAD as JMOEAD  # noqa: E402
from evox_tpu.algorithms import NSGA3 as JNSGA3  # noqa: E402
from evox_tpu.algorithms import HypE as JHypE  # noqa: E402
from evox_tpu.algorithms.mo import hype as jhype  # noqa: E402
from evox_tpu.algorithms.mo import moead as jmoead  # noqa: E402
from evox_tpu.operators.selection import tournament_selection_multifit as jtour_multi  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402
from evox_tpu_torch.algorithms import MOEAD, NSGA2, NSGA3, RVEA, HypE, RVEAa  # noqa: E402
from evox_tpu_torch.algorithms.mo import hype, moead, nsga3  # noqa: E402
from evox_tpu_torch.metrics import igd  # noqa: E402
from evox_tpu_torch.ops import dominance  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2  # noqa: E402
from evox_tpu_torch.utils.convert import state_from_numpy  # noqa: E402
from evox_tpu_torch.utils import graph  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402
from test_torch_nsga2 import t, to_numpy  # noqa: E402
from test_torch_rvea import Injected, sbx_pm_draws  # noqa: E402

D, M = 10, 3


class InjectedNSGA3(Injected, NSGA3):
    pass


class InjectedMOEAD(Injected, MOEAD):
    pass


class InjectedHypE(Injected, HypE):
    pass


def _workflows(jcls, cls, pop, **kw):
    jwf = JWorkflow(jcls(pop, M, jnp.zeros(D), jnp.ones(D), **kw), JDTLZ2(d=D, m=M))
    algo = cls(pop, M, torch.zeros(D), torch.ones(D), device="cpu", **kw)
    return jwf, StdWorkflow(algo, DTLZ2(d=D, m=M, device="cpu")), algo


def _close(got, want, what, rtol=1e-5):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=f"{what}: NaN places")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6, err_msg=what)


def _run_against_jax(jwf, wf, algo, draws, gens, seed, check):
    jstep = jax.jit(jwf.step)
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(seed)))
    ts = wf.init_step(state_from_numpy(to_numpy(jwf.init(jax.random.key(seed))), device="cpu"))
    check(ts, js)
    for _ in range(gens):
        ts = state_from_numpy(to_numpy(js), device="cpu")
        algo.next_draws = draws(js.algorithm)
        ts = wf.step(ts)
        js = jstep(js)
        check(ts, js)


# ---------------------------------------------------------------------------
# NSGA-III
# ---------------------------------------------------------------------------


def _jax_niche_fill(rank, worst_rank, group_id, group_dist, nv, pop_size):
    """JAX's niching, as ``evox_tpu/algorithms/mo/nsga3.py:160-242`` has it
    (stage 1, the stage-2 ``lax.while_loop`` and the surplus drop), on
    given ranks and groups; returns the ranks after niching."""
    n = rank.shape[0]
    big = jnp.int32(n)
    sel_mask = rank < worst_rank
    rho = jax.ops.segment_sum(sel_mask.astype(jnp.int32), group_id, num_segments=nv)
    selected_num = jnp.sum(rho)
    last_mask = rank == worst_rank
    rho_last = jax.ops.segment_sum(last_mask.astype(jnp.int32), group_id, num_segments=nv)
    rho = jnp.where(rho_last == 0, big, rho)
    group_id = jnp.where(last_mask, group_id, big)
    rows = jnp.arange(nv, dtype=jnp.int32)
    rank_pad = jnp.concatenate([rank, jnp.zeros((1,), jnp.int32)])
    stage1 = rho == 0
    sel_ref = jnp.where(stage1, rows, big)
    dist_tab = jnp.where(group_id[None, :] == sel_ref[:, None], group_dist[None, :], jnp.inf)
    candi_idx = jnp.argmin(dist_tab, axis=1).astype(jnp.int32)
    scatter_idx = jnp.where(stage1, candi_idx, big)
    rank_pad = rank_pad.at[scatter_idx].set(worst_rank - 1)
    rho_last = jnp.where(stage1, rho_last - 1, rho_last)
    rho = jnp.where(stage1, 1, rho)
    rho = jnp.where(rho_last == 0, big, rho)
    selected_num = selected_num + jnp.sum(stage1)
    group_id = jnp.where(jnp.isin(jnp.arange(n), jnp.where(stage1, candi_idx, big)), big, group_id)
    member_tab = jnp.sort(
        jnp.where(rows[:, None] == group_id[None, :], jnp.arange(n, dtype=jnp.int32), big), axis=1
    )

    def cond_fn(carry):
        return carry[4] < pop_size

    def body_fn(carry):
        rank_pad, rho, rho_last, cand_ptr, selected_num, _, _ = carry
        rho_level = jnp.min(rho)
        sel = rho == rho_level
        candi = member_tab[rows, jnp.minimum(cand_ptr, n - 1)]
        scatter = jnp.where(sel, candi, big)
        rank_pad = rank_pad.at[scatter].set(worst_rank - 1)
        cand_ptr = jnp.where(sel, cand_ptr + 1, cand_ptr)
        rho_last = jnp.where(sel, rho_last - 1, rho_last)
        rho = jnp.where(sel, rho_level + 1, rho)
        rho = jnp.where(rho_last == 0, big, rho)
        selected_num = selected_num + jnp.sum(sel)
        return rank_pad, rho, rho_last, cand_ptr, selected_num, sel, candi

    carry = (rank_pad, rho, rho_last, jnp.zeros((nv,), jnp.int32), selected_num, stage1, candi_idx)
    rank_pad, _, _, _, selected_num, last_sel, last_candi = jax.lax.while_loop(cond_fn, body_fn, carry)
    dif = selected_num - pop_size
    surplus = jnp.sort(jnp.where(last_sel, last_candi, big))
    drop_idx = jnp.where(jnp.arange(nv) < dif, surplus, big)
    rank_pad = rank_pad.at[drop_idx].set(worst_rank)
    return rank_pad[:n]


# (pop, vectors): NSGA-III has at most pop vectors (the Das-Dennis count
# under pop), fewer than the 2 pop merged rows, whose count JAX's loop
# uses as the sentinel vector id.
_NICHE_SHAPES = [(16, 9), (16, 16), (30, 9), (30, 30)]


_jax_niche_jit = jax.jit(_jax_niche_fill, static_argnums=(4, 5))


def _niche_inputs(seed):
    """Random ranks and groups, in four shapes (one compile each of the
    JAX loop).  Even seeds: ranks mostly 0 so few places are left and
    stage 1 alone overshoots them; odd seeds: several fronts and a large
    boundary front, niched by the loop over several levels."""
    r = np.random.default_rng(seed)
    pop, nv = _NICHE_SHAPES[(seed // 2) % 4]
    n = 2 * pop
    if seed % 2 == 0:
        rank = np.where(r.uniform(size=n) < 0.45, 0, 1 + r.integers(0, 3, n))
    else:
        rank = r.integers(0, 4, n)
    rank = rank.astype(np.int32)
    group_id = r.integers(0, nv, n).astype(np.int32)
    group_dist = (np.round(r.uniform(0, 1, n) * 6) / 6).astype(np.float32)  # ties
    worst = np.sort(rank)[pop]
    return rank, worst, group_id, group_dist, nv, pop


def _stage1_overshoots(rank, worst, group_id, nv, pop):
    sel = rank < worst
    has_sel = np.bincount(group_id[sel], minlength=nv) > 0
    has_last = np.bincount(group_id[rank == worst], minlength=nv) > 0
    return sel.sum() + (has_last & ~has_sel).sum() >= pop


@pytest.mark.parametrize("seed", range(24))
def test_niche_fill_matches_the_jax_loop_bit_for_bit(seed):
    rank, worst, gid, gdist, nv, pop = _niche_inputs(seed)
    want = _jax_niche_jit(jnp.asarray(rank), jnp.int32(worst), jnp.asarray(gid), jnp.asarray(gdist), nv, pop)
    got = nsga3._niche_fill(t(rank), torch.tensor(worst, dtype=torch.int32), t(gid), t(gdist), nv, pop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got < worst).sum()) == pop


def test_niche_inputs_cover_both_cases():
    cases = {_stage1_overshoots(*(lambda r, w, g, d, nv, p: (r, w, g, nv, p))(*_niche_inputs(s))) for s in range(24)}
    assert cases == {True, False}


@pytest.mark.parametrize("kind", ["random", "singular", "one_row"])
def test_normalize_matches_jax(kind):
    r = np.random.default_rng(3)
    fit = r.uniform(0, 2, (40, M)).astype(np.float32)
    mask = r.uniform(size=40) < 0.6
    if kind == "singular":
        fit[mask] = fit[mask][0]  # every extreme point is one row
    if kind == "one_row":
        mask[:] = False
        mask[7] = True
    jalgo = JNSGA3(20, M, jnp.zeros(D), jnp.ones(D))
    algo = NSGA3(20, M, torch.zeros(D), torch.ones(D), device="cpu")
    want = jalgo._normalize(jnp.asarray(fit), jnp.asarray(mask))
    got = algo._normalize(t(fit), t(mask))
    _close(got, want, f"normalized fitness ({kind})")


def _nsga3_draws(pop, nv):
    def draws(js):
        _, sel_key, x_key, mut_key, shuf_key, ref_key = jax.random.split(js.key, 6)
        pool = t(jtour_multi(sel_key, pop, [js.rank.astype(js.fit.dtype)])).to(torch.int64)
        sbx, pm = sbx_pm_draws(x_key, mut_key, pop // 2, 2 * (pop // 2), D)
        n = pop + 2 * (pop // 2)
        shuffle = t(jax.random.permutation(shuf_key, n)).to(torch.int64)
        return pool, sbx, pm, shuffle, t(jax.random.permutation(ref_key, nv)).to(torch.int64)

    return draws


def test_reference_permutation_is_a_row_permutation():
    """JAX shuffles the reference points by the permutation of their row
    count: the port is handed that permutation."""
    ref = JNSGA3(30, M, jnp.zeros(D), jnp.ones(D)).ref
    key = jax.random.key(11)
    perm = jax.random.permutation(key, ref.shape[0])
    np.testing.assert_array_equal(np.asarray(jax.random.permutation(key, ref, axis=0)), np.asarray(ref[perm]))


@pytest.mark.parametrize("pop", [20, 37])
def test_nsga3_steps_match_jax_with_injected_draws(pop):
    jwf, wf, algo = _workflows(JNSGA3, InjectedNSGA3, pop)

    def check(ts, js):
        _close(ts.algorithm.pop, js.algorithm.pop, "pop")
        _close(ts.algorithm.fit, js.algorithm.fit, "fit")
        np.testing.assert_array_equal(ts.algorithm.rank.numpy(), np.asarray(js.algorithm.rank))

    _run_against_jax(jwf, wf, algo, _nsga3_draws(pop, algo.ref.shape[0]), 5, pop, check)


# ---------------------------------------------------------------------------
# MOEA/D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pop,m", [(20, 3), (100, 3), (60, 2), (50, 4)])
def test_moead_neighbours_match_jax(pop, m):
    j = JMOEAD(pop, m, jnp.zeros(D), jnp.ones(D))
    a = MOEAD(pop, m, torch.zeros(D), torch.ones(D), device="cpu")
    assert (a.pop_size, a.n_neighbor) == (j.pop_size, j.n_neighbor)
    np.testing.assert_array_equal(a.neighbors.numpy(), np.asarray(j.neighbors))
    np.testing.assert_array_equal(a.w.numpy(), np.asarray(j.w))


def test_pbi_matches_jax():
    r = np.random.default_rng(0)
    f = r.uniform(0, 2, (30, 7, M)).astype(np.float32)
    w = r.uniform(0, 1, (30, 7, M)).astype(np.float32)
    z = r.uniform(-0.1, 0.1, M).astype(np.float32)
    _close(moead.pbi(t(f), t(w), t(z)), jmoead.pbi(jnp.asarray(f), jnp.asarray(w), jnp.asarray(z)), "pbi")


def _moead_draws(P, T):
    def draws(js):
        _, parent_key, x_key, mut_key = jax.random.split(js.key, 4)
        perm = jax.vmap(lambda k: jax.random.permutation(k, T))(jax.random.split(parent_key, P))
        sbx, pm = sbx_pm_draws(x_key, mut_key, P, P, D)
        return t(perm[:, :2]).to(torch.int64), sbx, pm

    return draws


def test_moead_steps_match_jax_with_injected_draws():
    jwf, wf, algo = _workflows(JMOEAD, InjectedMOEAD, 40)

    def check(ts, js):
        for k in ("pop", "fit", "z"):
            _close(ts.algorithm[k], js.algorithm[k], k)

    _run_against_jax(jwf, wf, algo, _moead_draws(algo.pop_size, algo.n_neighbor), 5, 7, check)


# ---------------------------------------------------------------------------
# HypE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [0.0, 3.0, 20.0, 29.5])
def test_cal_hv_matches_jax(k):
    r = np.random.default_rng(int(k))
    fit = r.uniform(0, 1, (40, M)).astype(np.float32)
    fit[5] = fit[6]
    ref = np.full(M, 1.3, np.float32)
    key = jax.random.key(1)
    want = jhype.cal_hv(key, jnp.asarray(fit), jnp.asarray(ref), jnp.float32(k), 512)
    u = t(jax.random.uniform(key, (512, M), dtype=jnp.float32))
    got = hype.cal_hv(None, t(fit), t(ref), torch.tensor(k), 512, u)
    _close(got, want, "hypervolume contributions")


def _hype_draws(pop, n_sample):
    """JAX's raw draws of one HypE generation: both hypervolume estimates'
    uniforms and the tournament's candidates, so the port's own first
    estimate (budget ``pop``) and tournament run in the step."""

    def draws(js):
        _, hv1_key, sel_key, x_key, mut_key, hv2_key = jax.random.split(js.key, 6)
        parents = t(jax.random.randint(sel_key, (pop, 2), 0, pop)).to(torch.int64)
        sbx, pm = sbx_pm_draws(x_key, mut_key, pop // 2, 2 * (pop // 2), D)
        return (
            t(jax.random.uniform(hv1_key, (n_sample, M), dtype=js.fit.dtype)),
            parents, sbx, pm,
            t(jax.random.uniform(hv2_key, (n_sample, M), dtype=js.fit.dtype)),
        )

    return draws


def test_hype_steps_match_jax_with_injected_draws():
    jwf, wf, algo = _workflows(JHypE, InjectedHypE, 30, n_sample=256)

    def check(ts, js):
        for k in ("pop", "fit", "ref"):
            _close(ts.algorithm[k], js.algorithm[k], k)

    _run_against_jax(jwf, wf, algo, _hype_draws(30, 256), 5, 3, check)


# ---------------------------------------------------------------------------
# The tests/test_moea.py contract on the port
# ---------------------------------------------------------------------------

POP = 20
ALGOS = {
    "nsga2": lambda: NSGA2(POP, M, torch.zeros(D), torch.ones(D), device="cpu"),
    "nsga3": lambda: NSGA3(POP, M, torch.zeros(D), torch.ones(D), device="cpu"),
    "rvea": lambda: RVEA(POP, M, torch.zeros(D), torch.ones(D), device="cpu"),
    "rveaa": lambda: RVEAa(POP, M, torch.zeros(D), torch.ones(D), device="cpu"),
    "moead": lambda: MOEAD(POP, M, torch.zeros(D), torch.ones(D), device="cpu"),
    "hype": lambda: HypE(POP, M, torch.zeros(D), torch.ones(D), n_sample=512, device="cpu"),
}


def _fit_ok(fit):
    # NaN rows are empty slots of the NaN-padded algorithms; at least one
    # row is real and every real row is finite.
    valid = ~torch.isnan(fit).any(dim=-1)
    assert int(valid.sum()) > 0
    assert bool(torch.isfinite(fit[valid]).all())


@pytest.mark.parametrize("name", ALGOS)
def test_mo_eager_steps_equal_run_and_keep_a_front(name):
    """3 eager steps, then run(3) from the same state: equal leaf for leaf
    (the first generation changes the monitor's shapes, so both start
    after one step)."""
    mon = EvalMonitor(multi_obj=True, full_sol_history=True)
    wf = StdWorkflow(ALGOS[name](), DTLZ2(d=D, m=M, device="cpu"), monitor=mon)
    s1 = wf.step(wf.init_step(wf.init(0)))
    state = s1
    for _ in range(3):
        state = wf.step(state)
    _fit_ok(state.algorithm.fit)
    sol, fit = mon.get_pf()
    assert sol.shape[1] == D and fit.shape[1] == M and fit.shape[0] > 0
    assert mon.get_pf_fitness().shape[1] == M
    fused = wf.run(s1, 3, init=False)
    la, sa = graph.flatten(fused)
    lb, sb = graph.flatten(state)
    assert sa == sb
    for a, b in zip(la, lb):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["nsga3", "hype", "rveaa"])
def test_mo_ranking_runs_no_kernel_on_the_cpu(name):
    before = (dominance.dominance_packed.launches, dominance.peel_fronts.launches)
    wf = StdWorkflow(ALGOS[name](), DTLZ2(d=D, m=M, device="cpu"))
    wf.step(wf.init_step(wf.init(1)))
    assert (dominance.dominance_packed.launches, dominance.peel_fronts.launches) == before


@pytest.mark.parametrize("name", ["rvea", "nsga3"])
def test_mo_converges(name):
    """IGD on DTLZ2 improves by 30 % over 30 generations."""
    prob = DTLZ2(d=D, m=M, device="cpu")
    wf = StdWorkflow(ALGOS[name](), prob)
    state = wf.init_step(wf.init(3))
    fit0 = state.algorithm.fit
    igd0 = float(igd(fit0[~torch.isnan(fit0).any(dim=-1)], prob.pf()))
    for _ in range(30):
        state = wf.step(state)
    fit = state.algorithm.fit
    igd1 = float(igd(torch.where(torch.isnan(fit), 1e9, fit), prob.pf()))
    assert igd1 < igd0 * 0.7, f"IGD did not improve: {igd0} -> {igd1}"


@pytest.mark.parametrize("jcls,cls,params", [
    (JNSGA3, NSGA3, ()),
    (JMOEAD, MOEAD, ()),
    (JHypE, HypE, ()),
    ("RVEA", RVEA, ("algorithm.alpha", "algorithm.fr", "algorithm.max_gen")),
    ("RVEAa", RVEAa, ("algorithm.alpha", "algorithm.fr", "algorithm.max_gen")),
])
def test_state_from_numpy_carries_each_mo_state(jcls, cls, params):
    """A JAX state after init_step converts into one with the structure,
    shapes, dtypes and hyperparameter labels of the port's own."""
    from evox_tpu import algorithms as jalgorithms

    jcls = getattr(jalgorithms, jcls) if isinstance(jcls, str) else jcls
    jwf = JWorkflow(jcls(POP, M, jnp.zeros(D), jnp.ones(D)), JDTLZ2(d=D, m=M))
    wf = StdWorkflow(cls(POP, M, torch.zeros(D), torch.ones(D), device="cpu"), DTLZ2(d=D, m=M, device="cpu"))
    js = jax.jit(jwf.init_step)(jwf.init(jax.random.key(0)))
    ts = state_from_numpy(to_numpy(js), device="cpu", params=params)
    own = wf.init_step(wf.init(0))
    assert graph.structure(ts.algorithm) == graph.structure(own.algorithm)
    _fit_ok(wf.step(ts).algorithm.fit)
