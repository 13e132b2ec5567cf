"""One rank of a multi-process gloo world for the port's parallel and
elastic tests (imports torch and evox_tpu_torch only, never JAX).

    python tests/test_torch_dist_worker.py SCENARIO INIT_URL RANK WORLD OUTDIR

Each rank joins the world through ``init_multi_host`` (a file store: no
port to collide), builds the sub-meshes of 1, 2 and 4 ranks every rank
must create together, runs ``SCENARIO`` and writes what it computed to
``OUTDIR/rank{RANK}.npz`` for the test to compare.  :func:`run_world`
starts the ranks and joins each with a time limit.

Scenarios:

* ``parallel`` — keyed per-individual sharded evaluation on each mesh,
  ``per_individual_keys=False`` on each mesh, a 10-step PSO run on the
  1- and 4-rank meshes, a padded evaluation and the dead-shard quarantine
  scenario on the 4-rank mesh.
* ``elastic`` — a 4-rank run checkpointed after 4 evaluations and carried
  on to 10; the checkpoint resumed on the 2-rank mesh to 10.
* ``hpo_mesh`` — HPO instances split over each mesh: a ``NestedProblem``
  (telemetry on) and an ``HPOProblemWrapper`` evaluated through
  ``ShardedProblem``, 6 candidates padded over 4 ranks, and an outer PSO
  run over the nest on the 4-rank mesh, each beside the unsharded nest's
  evaluation in the same process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
POP, DIM = 16, 4
DEAD_SHARD, DEAD_EVALS = 2, (3, 4, 5)
STEPS = 10
SAVE_AT = 4
HPO_CANDIDATES, HPO_PADDED, HPO_ITERATIONS, HPO_OUTER_STEPS, HPO_SEED = 8, 6, 4, 3, 21


def run_world(scenario: str, outdir: Path, world: int = 4, timeout: float = 120.0) -> list[dict]:
    """Run ``scenario`` on ``world`` gloo ranks; returns each rank's arrays.
    Every rank is joined within ``timeout`` seconds of the start, or all are
    killed and the call raises."""
    import numpy as np

    outdir.mkdir(parents=True, exist_ok=True)
    url = f"file://{outdir / 'store'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, scenario, url, str(r), str(world), str(outdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{scenario}: a rank did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{scenario}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


# -- the problems the scenarios evaluate ----------------------------------------


def keyed_sphere():
    """Sphere plus a uniform draw of the state's key per row (a keyed
    problem whose fitness depends on the key it is evaluated under)."""
    import torch

    from evox_tpu_torch.core import Problem, State
    from evox_tpu_torch.utils import rng

    class KeyedSphere(Problem):
        def setup(self, key):
            return State(key=key)

        def evaluate(self, state, pop):
            noise = rng.uniform(rng.child(state.key), (pop.shape[0],), pop.dtype, pop.device)
            key, _ = rng.split(state.key)
            return (pop * pop).sum(dim=-1) + noise, state.replace(key=key)

    return KeyedSphere()


def dead_shard(problem, n_shards: int):
    """NaN every fitness row of shard ``DEAD_SHARD`` at the evaluations
    ``DEAD_EVALS`` (counted from 0), as the JAX package's
    ``FaultyProblem(dead_shards=)`` does."""
    import torch

    from evox_tpu_torch.core import Problem, State
    from evox_tpu_torch.parallel import shard_row_ids

    class DeadShard(Problem):
        def __init__(self):
            self.problem = problem

        def setup(self, key):
            return State(inner=problem.setup(key), fault_generation=torch.zeros((), dtype=torch.int32))

        def evaluate(self, state, pop):
            fit, inner = problem.evaluate(state.inner, pop)
            gen = state.fault_generation
            ids = shard_row_ids(fit.shape[0], n_shards, fit.device)
            hit = torch.isin(gen, torch.tensor(DEAD_EVALS, dtype=torch.int32)) & (ids == DEAD_SHARD)
            fit = torch.where(hit, torch.full_like(fit, float("nan")), fit)
            return fit, State(inner=inner, fault_generation=gen + 1)

    return DeadShard()


def pso():
    import torch

    from evox_tpu_torch.algorithms import PSO

    return PSO(POP, -10.0 * torch.ones(DIM), 10.0 * torch.ones(DIM), device="cpu")


def population():
    import torch

    g = torch.Generator().manual_seed(0)
    return torch.rand((POP, DIM), generator=g) * 20.0 - 10.0


def flat(state) -> list:
    from evox_tpu_torch.utils import graph

    return [t.numpy() for t in graph.flatten(state)[0]]


def hpo_nest(kind: str, candidates: int = HPO_CANDIDATES):
    """A small nest: PSO(8, ±10 in dim 4) on Sphere, 4 inner generations,
    as a ``NestedProblem`` (uid streams, telemetry) or an
    ``HPOProblemWrapper`` (the split schedule, no telemetry)."""
    import torch

    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.hpo import HPOFitnessMonitor, NestedProblem
    from evox_tpu_torch.problems.hpo_wrapper import HPOProblemWrapper
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.workflows import StdWorkflow

    inner = StdWorkflow(PSO(8, -10.0 * torch.ones(DIM), 10.0 * torch.ones(DIM), device="cpu"), Sphere(),
                        monitor=HPOFitnessMonitor())
    if kind == "wrapper":
        return HPOProblemWrapper(iterations=HPO_ITERATIONS, num_instances=candidates, workflow=inner)
    return NestedProblem(inner, iterations=HPO_ITERATIONS, num_candidates=candidates)


def hpo_transform(x):
    """The outer PSO's rows as the inner PSO's inertia and social weights."""
    return {"algorithm.w": x[:, 0], "algorithm.phi_g": x[:, 1]}


def hpo_outer(nest, mesh=None):
    import torch

    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.workflows import StdWorkflow

    algo = PSO(HPO_CANDIDATES, torch.tensor([0.1, 0.5]), torch.tensor([0.9, 2.5]), device="cpu")
    return StdWorkflow(algo, nest, solution_transform=hpo_transform, enable_distributed=mesh is not None, mesh=mesh)


def hpo_evaluations(make, mesh, key, pad=False) -> tuple:
    """``(unsharded, sharded)``: the nest's evaluation of its initial
    hyper-parameters, alone and through ``ShardedProblem`` on ``mesh``,
    each ``(fitness, state)``."""
    from evox_tpu_torch.parallel import ShardedProblem

    nest = make()
    state = nest.setup(key)
    hp = nest.get_init_params(state)
    return nest.evaluate(state, hp), ShardedProblem(make(), mesh, pad=pad).evaluate(state, hp)


# -- scenarios ---------------------------------------------------------------------


def scenario_parallel(meshes: dict, out: dict) -> None:
    from evox_tpu_torch.core import State
    from evox_tpu_torch.parallel import ShardedProblem
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.utils import rng
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    pop = population()
    key = rng.key(11)
    for n, mesh in meshes.items():
        if mesh.shard_index is None:
            continue
        for per_individual in (True, False):
            sp = ShardedProblem(keyed_sphere(), mesh, per_individual_keys=per_individual)
            fit, st = sp.evaluate(sp.setup(key), pop)
            tag = "keyed" if per_individual else "whole"
            out[f"{tag}_m{n}"] = fit.numpy()
            out[f"{tag}_key_m{n}"] = st.key.numpy()
        if n in (1, 4):
            wf = StdWorkflow(pso(), Sphere(), monitor=EvalMonitor(), enable_distributed=True, mesh=mesh)
            s = wf.init_step(wf.init(3))
            for _ in range(STEPS - 1):
                s = wf.step(s)
            for i, leaf in enumerate(flat(s)):
                out[f"pso_m{n}_{i}"] = leaf
    mesh = meshes[4]
    padded, _ = ShardedProblem(Sphere(), mesh, pad=True).evaluate(State(), pop[:10])
    out["padded_m4"] = padded.numpy()
    for dead in (False, True):
        mon = EvalMonitor(full_fit_history=False)
        problem = ShardedProblem(Sphere(), mesh)
        if dead:
            problem = dead_shard(problem, 4)
        wf = StdWorkflow(pso(), problem, monitor=mon, quarantine_granularity="shard")
        s = wf.init_step(wf.init(5))
        for _ in range(11):
            s = wf.step(s)
        tag = "chaos" if dead else "clean"
        out[f"{tag}_shard_quarantines"] = mon.get_num_shard_quarantines(s.monitor).numpy()
        out[f"{tag}_nonfinite"] = mon.get_num_nonfinite(s.monitor).numpy()
        out[f"{tag}_best"] = mon.get_best_fitness(s.monitor).numpy()


def scenario_elastic(meshes: dict, out: dict, outdir: Path) -> None:
    import torch.distributed as dist

    from evox_tpu_torch.resilience import workflow_topology
    from evox_tpu_torch.utils import CheckpointError, load_state, save_state
    from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow

    def workflow(mesh):
        return StdWorkflow(pso(), keyed_sphere(), monitor=EvalMonitor(), enable_distributed=True, mesh=mesh)

    wf4 = workflow(meshes[4])
    s = wf4.init_step(wf4.init(9))
    ckpt = outdir / "ckpt_4.npz"
    for evals in range(2, STEPS + 1):
        s = wf4.step(s)
        if evals == SAVE_AT:
            if dist.get_rank() == 0:
                save_state(ckpt, s, generation=SAVE_AT,
                           metadata={"topology": workflow_topology(wf4).to_manifest()}, durable=True)
            dist.barrier()
    for i, leaf in enumerate(flat(s)):
        out[f"run4_{i}"] = leaf
    mesh2 = meshes[2]
    if mesh2.shard_index is None:
        return
    wf2 = workflow(mesh2)
    template = wf2.init(0)
    try:
        load_state(ckpt, template, mesh=mesh2, remesh=False)
    except CheckpointError as e:
        out["gate"] = str(e)
    r = load_state(ckpt, template, mesh=mesh2, verify=True)
    for _ in range(STEPS - SAVE_AT):
        r = wf2.step(r)
    for i, leaf in enumerate(flat(r)):
        out[f"resumed2_{i}"] = leaf


def scenario_hpo_mesh(meshes: dict, out: dict) -> None:
    from evox_tpu_torch.utils import rng

    key = rng.key(HPO_SEED, device="cpu")
    for n, mesh in meshes.items():
        if mesh.shard_index is None:
            continue
        for kind in ("nest", "wrapper"):
            (ref_fit, ref_state), (fit, state) = hpo_evaluations(lambda: hpo_nest(kind), mesh, key)
            out[f"{kind}_ref_fit_m{n}"] = ref_fit.numpy()
            out[f"{kind}_fit_m{n}"] = fit.numpy()
            for tag, st in (("ref", ref_state), ("sharded", state)):
                for i, leaf in enumerate(flat(st)):
                    out[f"{kind}_{tag}_state_m{n}_{i}"] = leaf
    (ref_fit, ref_state), (fit, state) = hpo_evaluations(lambda: hpo_nest("nest", HPO_PADDED), meshes[4], key, pad=True)
    out["pad_ref_fit"], out["pad_fit"] = ref_fit.numpy(), fit.numpy()
    for tag, st in (("ref", ref_state), ("sharded", state)):
        for i, leaf in enumerate(flat(st)):
            out[f"pad_{tag}_state_{i}"] = leaf
    for tag, mesh in (("ref", None), ("sharded", meshes[4])):
        wf = hpo_outer(hpo_nest("nest"), mesh)
        s = wf.init_step(wf.init(HPO_SEED))
        for _ in range(HPO_OUTER_STEPS - 1):
            s = wf.step(s)
        for i, leaf in enumerate(flat(s)):
            out[f"run_{tag}_{i}"] = leaf


def main(argv: list[str]) -> int:
    scenario, url, rank, world, outdir = argv[1], argv[2], int(argv[3]), int(argv[4]), Path(argv[5])
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from evox_tpu_torch.parallel import init_multi_host, make_pop_mesh

    torch.set_num_threads(1)
    init_multi_host(url, world, rank, device="cpu")
    meshes = {n: make_pop_mesh(n, device="cpu") for n in (1, 2, 4)}
    out: dict = {}
    if scenario == "parallel":
        scenario_parallel(meshes, out)
    elif scenario == "elastic":
        scenario_elastic(meshes, out, outdir)
    elif scenario == "hpo_mesh":
        scenario_hpo_mesh(meshes, out)
    else:
        raise SystemExit(f"unknown scenario {scenario!r}")
    np.savez(outdir / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
