"""The port's parallel layer (``evox_tpu_torch/parallel``), shard-granular
quarantine, the per-shard health metrics and the package namespace, held
against the JAX package on the same numpy inputs.

In this process the port's meshes are one-rank gloo groups (the JAX side
runs on the 8 virtual CPU devices ``conftest.py`` forces); the multi-rank
cases run in one world of 4 gloo processes (``test_torch_dist_worker.py``,
file store under ``tmp_path``) that builds the sub-meshes of 1, 2 and 4
ranks, and compare its results here.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import evox_tpu.parallel as jpar  # noqa: E402
from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.problems.numerical import DTLZ2 as JDTLZ2  # noqa: E402
from evox_tpu.problems.numerical import Ackley as JAckley  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.resilience import FaultyProblem  # noqa: E402
from evox_tpu.resilience.health import scan_state as jscan  # noqa: E402
from evox_tpu.workflows import EvalMonitor as JEvalMonitor  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402

import evox_tpu_torch  # noqa: E402
from evox_tpu_torch import parallel  # noqa: E402
from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.parallel import ShardedProblem, make_pop_mesh  # noqa: E402
from evox_tpu_torch.problems.numerical import DTLZ2, Ackley, Sphere  # noqa: E402
from evox_tpu_torch.resilience import scan_state  # noqa: E402
from evox_tpu_torch.utils import graph, rng  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_dist_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True, scope="module")
def _no_process_group_left():
    """Tests here may set up a one-rank gloo group (``make_pop_mesh``):
    destroy it with the module, so no later test file in this process finds
    one."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _mesh():
    return make_pop_mesh(device="cpu")


# ---------------------------------------------------------------------------
# the namespace
# ---------------------------------------------------------------------------


def test_import_exposes_every_ported_subpackage_and_builds_nothing():
    code = (
        "import subprocess, sys\n"
        "calls = []\n"
        "real = subprocess.Popen.__init__\n"
        "def spy(self, *a, **k):\n"
        "    calls.append(a[0] if a else k.get('args'))\n"
        "    return real(self, *a, **k)\n"
        "subprocess.Popen.__init__ = spy\n"
        "import evox_tpu_torch as e\n"
        "from evox_tpu_torch.ops import _build\n"
        "for name in ('algorithms', 'control', 'core', 'hpo', 'metrics', 'obs', 'operators', 'ops', 'parallel',\n"
        "             'precision', 'problems', 'resilience', 'service', 'utils', 'workflows'):\n"
        "    assert name in e.__all__ and getattr(e, name).__name__ == 'evox_tpu_torch.' + name, name\n"
        "assert not _build._loaded, _build._loaded\n"
        "assert not calls, calls\n"
        "assert 'jax' not in sys.modules and 'evox_tpu' not in sys.modules\n"
        "for name in e.NOT_PORTED:\n"
        "    try:\n"
        "        getattr(e, name)\n"
        "    except ImportError as err:\n"
        "        assert name in str(err)\n"
        "    else:\n"
        "        raise AssertionError(name)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
    assert set(evox_tpu_torch.NOT_PORTED) == {"vis_tools"}


def _jax_exports():
    """``(module path, __all__)`` of every ``evox_tpu/**/__init__.py``, read
    with ``ast`` (no import)."""
    root = ROOT / "evox_tpu"
    for init in sorted(root.rglob("__init__.py")):
        rel = ".".join(init.parent.relative_to(root).parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
                yield rel, ast.literal_eval(node.value)


def test_namespace_parity_with_the_jax_package():
    """Every name a JAX package ``__init__`` exports has a counterpart in the
    port's module of the same place, or is on that module's not-ported list
    (and importing it raises ImportError naming it); a whole subpackage not
    ported is on ``evox_tpu_torch.NOT_PORTED``."""
    import importlib

    checked = 0
    for rel, names in _jax_exports():
        if rel.split(".")[0] in evox_tpu_torch.NOT_PORTED:
            continue
        mod = importlib.import_module("evox_tpu_torch" + ("." + rel if rel else ""))
        not_ported = set(getattr(mod, "_NOT_PORTED", ())) | set(getattr(mod, "NOT_PORTED", ()))
        for name in names:
            if name in not_ported:
                with pytest.raises(ImportError, match=name):
                    getattr(mod, name)
            else:
                assert name in vars(mod), f"evox_tpu_torch.{rel}: {name} has no counterpart"
            checked += 1
    assert checked > 300


# ---------------------------------------------------------------------------
# mesh helpers against the JAX package
# ---------------------------------------------------------------------------

SIZES = [(16, 8), (10, 4), (7, 3), (5, 8), (1, 1), (12, 5)]


@pytest.mark.parametrize("pop_size, n_shards", SIZES)
def test_mesh_helpers_equal_jax(pop_size, n_shards):
    x = np.random.default_rng(pop_size).standard_normal((pop_size, 3)).astype(np.float32)
    assert parallel.padded_size(pop_size, n_shards) == jpar.mesh.padded_size(pop_size, n_shards)
    np.testing.assert_array_equal(
        parallel.shard_row_ids(pop_size, n_shards).numpy(), np.asarray(jpar.shard_row_ids(pop_size, n_shards))
    )
    np.testing.assert_array_equal(
        parallel.population_mask(pop_size, n_shards).numpy(),
        np.asarray(jpar.population_mask(pop_size, n_shards)),
    )
    tree = {"w": torch.from_numpy(x), "b": torch.from_numpy(x[:, 0].copy())}
    got, mask = parallel.pad_population(tree, n_shards)
    want, jmask = jpar.pad_population({"w": jnp.asarray(x), "b": jnp.asarray(x[:, 0])}, n_shards)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    fit = np.arange(parallel.padded_size(pop_size, n_shards) * 2, dtype=np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(
        parallel.unpad_fitness(torch.from_numpy(fit), pop_size).numpy(),
        np.asarray(jpar.unpad_fitness(jnp.asarray(fit), pop_size)),
    )


def test_pad_population_refusals():
    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        parallel.padded_size(4, 0)
    with pytest.raises(ValueError, match="disagree on the leading axis"):
        parallel.pad_population({"a": torch.zeros(5), "b": torch.zeros(4)}, 2)
    with pytest.raises(ValueError, match="non-empty"):
        parallel.pad_population({}, 2)


def test_one_rank_mesh_placement():
    mesh = _mesh()
    assert mesh.shape["pop"] == 1 and mesh.axis_names == ("pop",) and mesh.shard_index == 0
    assert mesh.platform == "cpu" and mesh.device == torch.device("cpu")
    pop = torch.rand(16, 3)
    np.testing.assert_array_equal(parallel.shard_population(pop, mesh).numpy(), pop.numpy())
    state = State(a=pop, b=State(c=torch.arange(3)))
    rep = parallel.replicate(state, mesh)
    assert torch.equal(rep.a, pop) and rep.a is not pop and torch.equal(rep.b.c, state.b.c)
    assert parallel.ALL_GATHER in (
        getattr(torch.distributed, "all_gather_single", None), torch.distributed.all_gather_into_tensor
    )
    with pytest.raises(ValueError, match="1 <= n"):
        make_pop_mesh(2, device="cpu")


# ---------------------------------------------------------------------------
# ShardedProblem against the JAX package
# ---------------------------------------------------------------------------


def _problems(name):
    if name == "Sphere":
        return Sphere(), JSphere(), 10
    if name == "Ackley":
        return Ackley(), JAckley(), 10
    return DTLZ2(d=12, m=3, device="cpu"), JDTLZ2(d=12, m=3), 12


@pytest.mark.parametrize("name", ["Sphere", "Ackley", "DTLZ2"])
def test_sharded_problem_equals_jax(name):
    """The port on a one-rank mesh, JAX on its 8-device mesh, same rows: at
    test_torch_problems.py's tolerance; the port also equals its own
    unsharded evaluation bit for bit."""
    prob, jprob, d = _problems(name)
    x = np.random.default_rng(3).uniform(0.0 if name == "DTLZ2" else -5.0, 1.0 if name == "DTLZ2" else 5.0,
                                         (32, d)).astype(np.float32)
    sp = ShardedProblem(prob, _mesh())
    got, st = sp.evaluate(sp.setup(None), torch.from_numpy(x))
    assert len(st) == 0
    jsp = jpar.ShardedProblem(jprob, jpar.make_pop_mesh(8))
    want, _ = jsp.evaluate(jsp.setup(None), jnp.asarray(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    plain, _ = prob.evaluate(prob.setup(None), torch.from_numpy(x))
    assert torch.equal(got, plain)


def test_sharded_problem_pytree_population_and_pad():
    """A nest of tensors is split leaf by leaf; ``pad=True`` accepts any
    size (on one rank nothing is padded)."""

    class Pair(Problem):
        def evaluate(self, state, pop):
            return (pop["w"] * pop["w"]).sum(-1) + pop["b"], state

    pop = {"w": torch.rand(7, 3), "b": torch.rand(7)}
    sp = ShardedProblem(Pair(), _mesh(), pad=True)
    got, _ = sp.evaluate(State(), pop)
    want, _ = Pair().evaluate(State(), pop)
    assert torch.equal(got, want)
    # A gloo all-gather runs on the host: no CUDA graph can hold it.
    assert not sp.capturable


def test_keyed_per_individual_evaluation_on_one_rank():
    """Each row under ``fold_in(key, slot)``; the key advances by
    ``fold_in(key, 0x5EED)``; ``per_individual_keys=False`` folds the shard
    index (0) and evaluates the block whole."""
    key = rng.key(11)
    pop = worker.population()
    sp = ShardedProblem(worker.keyed_sphere(), _mesh())
    fit, st = sp.evaluate(sp.setup(key), pop)
    inner = worker.keyed_sphere()
    rows = [inner.evaluate(State(key=rng.fold_in(key, torch.tensor(i))), pop[i:i + 1])[0][0] for i in range(len(pop))]
    assert torch.equal(fit, torch.stack(rows))
    assert torch.equal(st.key, rng.fold_in(key, torch.tensor(0x5EED)))
    whole = ShardedProblem(worker.keyed_sphere(), _mesh(), per_individual_keys=False)
    fit0, _ = whole.evaluate(whole.setup(key), pop)
    want, _ = inner.evaluate(State(key=rng.fold_in(key, torch.tensor(0))), pop)
    assert torch.equal(fit0, want)


def test_sharded_problem_refuses_vmap():
    sp = ShardedProblem(Sphere(), _mesh())
    with pytest.raises(NotImplementedError, match="torch.func.vmap"):
        torch.func.vmap(lambda x: sp.evaluate(State(), x)[0])(torch.rand(2, 4, 3))


# ---------------------------------------------------------------------------
# the distributed workflow on one rank
# ---------------------------------------------------------------------------


def _pso(n=16, d=4):
    return PSO(n, -10.0 * torch.ones(d), 10.0 * torch.ones(d), device="cpu")


def test_distributed_workflow_equals_unsharded_on_one_rank():
    """``enable_distributed=True`` on a one-rank mesh (set up by the
    workflow): eager steps, ``run`` and ``run_segment`` equal the unsharded
    workflow's bit for bit."""
    wf = StdWorkflow(_pso(), Sphere(), monitor=EvalMonitor(), enable_distributed=True)
    ref = StdWorkflow(_pso(), Sphere(), monitor=EvalMonitor())
    assert isinstance(wf.problem, ShardedProblem) and wf.mesh is wf.problem.mesh and wf._n_shards == 1
    assert ref.mesh is None and ref._n_shards is None
    s, r = wf.init_step(wf.init(0)), ref.init_step(ref.init(0))
    for _ in range(3):
        s, r = wf.step(s), ref.step(r)
    for a, b in zip(graph.flatten(s)[0], graph.flatten(r)[0]):
        assert torch.equal(a, b)
    for a, b in zip(graph.flatten(wf.run(s, 5, init=False))[0], graph.flatten(ref.run(r, 5, init=False))[0]):
        assert torch.equal(a, b)
    seg, tel = wf.run_segment(s, 3)
    assert "shard_nonfinite" not in tel.metrics  # one shard: no per-shard metrics


def test_distributed_workflow_does_not_double_shard_and_checks_divisibility():
    mesh = _mesh()
    inner = ShardedProblem(Sphere(), mesh)

    class Wrap(Problem):
        def __init__(self, problem):
            self.problem = problem
            self.in_sharded_program = False

        def setup(self, key):
            return self.problem.setup(key)

        def evaluate(self, state, pop):
            return self.problem.evaluate(state, pop)

    wrapped = Wrap(inner)
    wf = StdWorkflow(_pso(), wrapped, enable_distributed=True, mesh=mesh)
    assert wf.problem is wrapped and wrapped.in_sharded_program
    assert parallel.find_sharded(wf.problem) is inner
    assert list(parallel.iter_problem_chain(wf.problem)) == [wrapped, inner, inner.problem]
    # Unsharded: the flag is reset, the mesh not stored.
    plain = Wrap(Sphere())
    wf = StdWorkflow(_pso(), plain, mesh=mesh)
    assert not plain.in_sharded_program and wf.mesh is None


def test_shard_quarantine_on_one_rank():
    """One shard: any NaN row condemns the whole population (the JAX
    package's rule, with one shard)."""

    class NaNRow(Problem):
        def evaluate(self, state, pop):
            fit = (pop * pop).sum(-1)
            return torch.where(torch.arange(fit.shape[0]) == 3, torch.full_like(fit, float("nan")), fit), state

    mon = EvalMonitor()
    wf = StdWorkflow(_pso(), NaNRow(), monitor=mon, enable_distributed=True, quarantine_granularity="shard")
    s = wf.init_step(wf.init(0))
    s = wf.step(s)
    assert int(mon.get_num_shard_quarantines(s.monitor)) == 2
    assert int(mon.get_num_nonfinite(s.monitor)) == 32
    assert bool((s.algorithm.fit == 1e30).all())
    with pytest.raises(ValueError, match="needs a sharded evaluation"):
        StdWorkflow(_pso(), Sphere(), quarantine_granularity="shard")


# ---------------------------------------------------------------------------
# per-shard health metrics against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, shards", [(16, 4), (10, 4), (9, 2)])
def test_scan_state_shards_equal_jax(n, shards):
    g = np.random.default_rng(n)
    pop = g.standard_normal((n, 3)).astype(np.float32)
    fit = g.standard_normal((n,)).astype(np.float32)
    fit[1] = np.nan
    fit[n - 1] = np.inf
    pop[-1] = pop[-2]  # a shard whose rows coincide
    port = scan_state(State(algorithm=State(pop=torch.from_numpy(pop), fit=torch.from_numpy(fit))),
                      diversity=True, shards=shards)
    from evox_tpu.core import State as JState

    ref = jscan(JState(algorithm=JState(pop=jnp.asarray(pop), fit=jnp.asarray(fit))), diversity=True, shards=shards)
    for k in ("shard_nonfinite", "shard_rows"):
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(port["shard_diversity"].numpy(), np.asarray(ref["shard_diversity"]), rtol=1e-6)
    fit2 = g.standard_normal((n, 2)).astype(np.float32)
    fit2[0, 1] = np.nan
    port = scan_state(State(algorithm=State(fit=torch.from_numpy(fit2))), shards=shards)
    ref = jscan(JState(algorithm=JState(fit=jnp.asarray(fit2))), shards=shards)
    np.testing.assert_array_equal(port["shard_nonfinite"].numpy(), np.asarray(ref["shard_nonfinite"]))
    assert "shard_nonfinite" not in scan_state(State(algorithm=State(fit=torch.from_numpy(fit))), shards=1)


def test_segment_health_reads_shards():
    """``health.shards`` reaches the segment's metrics, and a dead shard
    stops a stop-guarded segment."""

    class Probe:
        shards = 4
        check_nonfinite = True
        nonfinite_skip = ()
        diversity_floor = None
        step_size_range = None

    wf = StdWorkflow(_pso(), Sphere())
    s = wf.init_step(wf.init(0))
    _, tel = wf.run_segment(s, 2, health=Probe())
    assert tel.metrics["shard_rows"].tolist() == [4, 4, 4, 4]
    assert tel.metrics["shard_nonfinite"].tolist() == [0, 0, 0, 0]
    cfg = wf.segment_config(health=Probe())
    dead = s.replace(algorithm=s.algorithm.replace(fit=torch.where(
        torch.arange(16) < 4, torch.full((16,), float("nan")), s.algorithm.fit)))
    assert bool(wf._unhealthy(dead, cfg))
    assert not bool(wf._unhealthy(s, cfg))


# ---------------------------------------------------------------------------
# a world of 4 gloo ranks: sub-meshes of 1, 2 and 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return worker.run_world("parallel", tmp_path_factory.mktemp("parallel_world"))


def _keyed_rows(key, pop):
    inner = worker.keyed_sphere()
    return torch.stack(
        [inner.evaluate(State(key=rng.fold_in(key, torch.tensor(i))), pop[i:i + 1])[0][0] for i in range(len(pop))]
    ).numpy()


def test_keyed_evaluation_is_topology_invariant(world):
    """Keyed per-individual evaluation: every rank of every mesh (1, 2, 4)
    gathers the same fitness, bit for bit equal to unsharded per-row
    evaluation, and the same advanced key."""
    want = _keyed_rows(rng.key(11), worker.population())
    key_want = rng.fold_in(rng.key(11), torch.tensor(0x5EED)).numpy()
    seen = 0
    for rank, out in enumerate(world):
        for n in (1, 2, 4):
            if f"keyed_m{n}" in out:
                np.testing.assert_array_equal(out[f"keyed_m{n}"], want, err_msg=f"rank {rank} mesh {n}")
                np.testing.assert_array_equal(out[f"keyed_key_m{n}"], key_want)
                seen += 1
    assert seen == 1 + 2 + 4


def test_whole_shard_keys_decorrelate_by_shard(world):
    """``per_individual_keys=False``: shard ``s`` evaluates its block under
    ``fold_in(key, s)``, so the streams depend on the mesh."""
    key, pop = rng.key(11), worker.population()
    inner = worker.keyed_sphere()
    for n in (1, 2, 4):
        block = len(pop) // n
        want = np.concatenate([
            inner.evaluate(State(key=rng.fold_in(key, torch.tensor(s))), pop[s * block:(s + 1) * block])[0].numpy()
            for s in range(n)
        ])
        for out in world[:n]:
            np.testing.assert_array_equal(out[f"whole_m{n}"], want)
    assert not np.array_equal(world[0]["whole_m2"], world[0]["whole_m4"])


def test_pso_run_sharded_four_ways_equals_one_rank(world):
    """A 10-generation PSO run on the 4-rank mesh: every rank's state equals
    the 1-rank mesh's run and the unsharded run, bit for bit."""
    wf = StdWorkflow(worker.pso(), Sphere(), monitor=EvalMonitor())
    s = wf.init_step(wf.init(3))
    for _ in range(worker.STEPS - 1):
        s = wf.step(s)
    ref = [t.numpy() for t in graph.flatten(s)[0]]
    for rank, out in enumerate(world):
        leaves = [out[f"pso_m4_{i}"] for i in range(len(ref))]
        for a, b in zip(leaves, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank}")
    for i, b in enumerate(ref):
        np.testing.assert_array_equal(world[0][f"pso_m1_{i}"], b)


def test_dead_shard_quarantine_counts_equal_jax(world):
    """test_elastic.py's dead-shard scenario on 4 shards: shard 2 all-NaN at
    evaluations 3, 4, 5 of 12; the port's counts (every rank) equal the JAX
    package's on a 4-device mesh, and the fault-free run counts none."""
    mesh = jpar.make_pop_mesh(4)
    lb, ub = -10.0 * jnp.ones(worker.DIM), 10.0 * jnp.ones(worker.DIM)

    def run(dead):
        mon = JEvalMonitor(full_fit_history=False)
        prob = FaultyProblem(jpar.ShardedProblem(JSphere(), mesh), dead_shards={worker.DEAD_SHARD: dead})
        wf = JWorkflow(JPSO(worker.POP, lb, ub), prob, monitor=mon, quarantine_granularity="shard")
        state = jax.jit(wf.init_step)(wf.init(jax.random.key(5)))
        step = jax.jit(wf.step)
        for _ in range(11):
            state = step(state)
        return int(mon.get_num_shard_quarantines(state.monitor)), int(mon.get_num_nonfinite(state.monitor))

    want = run(worker.DEAD_EVALS)
    assert want == (3, 12) and run(()) == (0, 0)
    for out in world:
        assert (int(out["chaos_shard_quarantines"]), int(out["chaos_nonfinite"])) == want
        assert (int(out["clean_shard_quarantines"]), int(out["clean_nonfinite"])) == (0, 0)
        assert np.isfinite(out["chaos_best"])
        assert float(out["chaos_best"]) <= max(10.0 * float(out["clean_best"]), float(out["clean_best"]) + 1.0)


def test_divisibility_message_and_pad_on_four_shards():
    """The divisibility errors name the same numbers as the JAX package's
    (no collective runs before them, so a mesh-shaped stand-in of 4 shards
    is enough here; the 4-rank world runs the padded path,
    test_padded_evaluation_on_four_ranks)."""

    class Four:
        shape = {"pop": 4}
        axis_names = ("pop",)
        shard_index = 0

    x = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError) as got:
        ShardedProblem(Sphere(), Four()).evaluate(State(), torch.from_numpy(x))
    with pytest.raises(ValueError) as want:
        jpar.ShardedProblem(JSphere(), jpar.make_pop_mesh(4)).evaluate(JSphere().setup(None), jnp.asarray(x))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        StdWorkflow(_pso(10), Sphere(), enable_distributed=True, mesh=Four())
    with pytest.raises(ValueError) as want:
        JWorkflow(JPSO(10, -jnp.ones(4), jnp.ones(4)), JSphere(), enable_distributed=True,
                  mesh=jpar.make_pop_mesh(4))
    assert str(got.value) == str(want.value)


def test_padded_evaluation_on_four_ranks(world):
    """``pad=True`` on the 4-rank mesh: 10 rows padded to 12, split 3 a rank,
    gathered and cut back to 10, equal to the unsharded evaluation."""
    pop = worker.population()[:10]
    want, _ = Sphere().evaluate(State(), pop)
    for out in world:
        np.testing.assert_array_equal(out["padded_m4"], want.numpy())
