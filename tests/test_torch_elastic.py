"""The port's elastic topology (``evox_tpu_torch/resilience/elastic.py``)
and ``load_state(mesh=, remesh=)``, case for case against
``tests/test_elastic.py``'s topology tests; and a resume across meshes: a
run checkpointed on 4 gloo ranks resumed on 2, bit for bit equal to the
uninterrupted 4-rank run (``test_torch_dist_worker.py``'s ``elastic`` world)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evox_tpu.resilience import elastic as jel  # noqa: E402
from evox_tpu.utils import CheckpointError as JCheckpointError  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import Problem, State  # noqa: E402
from evox_tpu_torch.parallel import ShardedProblem, make_pop_mesh  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.resilience import (  # noqa: E402
    MeshTopology,
    check_topology,
    current_topology,
    remesh_state,
    topology_differs,
    workflow_mesh,
    workflow_topology,
)
from evox_tpu_torch.utils import CheckpointError, load_state, read_manifest, save_state  # noqa: E402
from evox_tpu_torch.workflows import StdWorkflow  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_dist_worker as worker  # noqa: E402

POP, DIM = 16, 4

@pytest.fixture(autouse=True, scope="module")
def _no_process_group_left():
    """Tests here may set up a one-rank gloo group (``make_pop_mesh``):
    destroy it with the module, so no later test file in this process finds
    one."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _pso():
    return PSO(POP, -torch.ones(DIM), torch.ones(DIM), device="cpu")


def _topo(sizes, names=("pop",)):
    return MeshTopology(tuple(names), tuple(sizes), "cpu", "cpu", int(np.prod(sizes)), 1)


def test_save_state_records_environment_topology(tmp_path):
    topo = read_manifest(save_state(tmp_path / "s.npz", State(a=torch.zeros(3))))["topology"]
    assert topo == current_topology().to_manifest()
    assert topo["num_devices"] == 1 and topo["num_processes"] == 1 and topo["platform"] == "cpu"
    assert topo["axis_names"] == []
    assert not MeshTopology.from_manifest(topo).meshed


def test_load_state_topology_gate(tmp_path):
    """A mesh-bound archive under another mesh: ``remesh=False`` raises
    before any leaf is restored; ``remesh=True`` loads and places the state
    on the mesh's device; the same mesh passes even with ``remesh=False``."""
    state = State(algorithm=State(pop=torch.rand(POP, DIM), fit=torch.rand(POP)), monitor=State(g=torch.tensor(3)))
    eight = save_state(tmp_path / "m8.npz", state, metadata={"topology": _topo((8,)).to_manifest()})
    mesh = make_pop_mesh(device="cpu")
    with pytest.raises(CheckpointError, match="re-meshing is disabled"):
        load_state(eight, state, mesh=mesh, remesh=False)
    restored = load_state(eight, state, mesh=mesh)
    assert torch.equal(restored.algorithm.pop, state.algorithm.pop)
    assert restored.algorithm.pop.device == mesh.device
    same = save_state(tmp_path / "m1.npz", state, metadata={"topology": MeshTopology.from_mesh(mesh).to_manifest()})
    assert torch.equal(load_state(same, state, mesh=mesh, remesh=False).algorithm.fit, state.algorithm.fit)
    # A meshless writer never gates.
    plain = save_state(tmp_path / "plain.npz", state)
    load_state(plain, state, mesh=mesh, remesh=False)


def test_load_state_respects_custom_axis_name(tmp_path):
    state = State(algorithm=State(pop=torch.ones(POP, DIM), fit=torch.zeros(POP)))
    path = save_state(tmp_path / "s.npz", state)
    mesh = make_pop_mesh(axis_name="devices", device="cpu")
    assert mesh.axis_names == ("devices",) and MeshTopology.from_mesh(mesh).axis_names == ("devices",)
    restored = load_state(path, state, mesh=mesh)
    np.testing.assert_array_equal(restored.algorithm.pop.numpy(), np.ones((POP, DIM)))
    assert remesh_state(state, mesh).algorithm.pop.device == torch.device("cpu")


def test_check_topology_divisibility_gate():
    eight, three = _topo((8,)), _topo((3,))
    with pytest.raises(CheckpointError, match="does not divide the 3-way"):
        check_topology(eight, three, remesh=True, pop_size=16)
    assert check_topology(eight, three, remesh=True, pop_size=12) == eight
    assert check_topology(None, three) is None
    assert check_topology(eight.to_manifest(), three, pop_size=12) == eight


def test_check_topology_multi_axis_uses_population_axis():
    eight = _topo((8,))
    two_axis = _topo((4, 2), ("pop", "model"))
    assert check_topology(eight, two_axis, remesh=True, pop_size=12, pop_axis="pop") == eight
    with pytest.raises(CheckpointError, match="does not divide the 4-way"):
        check_topology(eight, two_axis, remesh=True, pop_size=10, pop_axis="pop")
    assert two_axis.mesh_size == 8 and not topology_differs(_topo((), ()), eight)


@pytest.mark.parametrize("recorded, current, pop_size, remesh", [
    ((8,), (3,), 16, True), ((8,), (4,), None, False), ((4, 2), (8,), 10, True),
])
def test_topology_messages_equal_jax(recorded, current, pop_size, remesh):
    """The same records give the JAX package's descriptions and errors."""
    names = lambda s: ("pop", "model")[: len(s)]  # noqa: E731
    mine = [_topo(s, names(s)) for s in (recorded, current)]
    theirs = [jel.MeshTopology.from_manifest(t.to_manifest()) for t in mine]
    assert [t.describe() for t in mine] == [t.describe() for t in theirs]
    with pytest.raises(CheckpointError) as got:
        check_topology(mine[0], mine[1], remesh=remesh, pop_size=pop_size)
    with pytest.raises(JCheckpointError) as want:
        jel.check_topology(theirs[0], theirs[1], remesh=remesh, pop_size=pop_size)
    # The JAX message names its resilient runner's option too.
    assert str(got.value) == str(want.value).replace("ResilientRunner(remesh=True) / ", "")


def test_workflow_topology_walks_wrapper_chains():
    mesh = make_pop_mesh(device="cpu")

    class Wrap(Problem):
        def __init__(self, problem):
            self.problem = problem

        def evaluate(self, state, pop):
            return self.problem.evaluate(state, pop)

    wf = StdWorkflow(_pso(), Wrap(ShardedProblem(Sphere(), mesh)))
    topo = workflow_topology(wf)
    assert topo.meshed and topo.axis_sizes == (1,) and topo.platform == "cpu"
    assert workflow_mesh(wf)[0] is mesh
    dist_wf = StdWorkflow(_pso(), Sphere(), enable_distributed=True, mesh=mesh)
    assert workflow_mesh(dist_wf) == (mesh, "pop")


def test_unsharded_workflow_with_a_mesh_is_not_mesh_bound():
    mesh = make_pop_mesh(device="cpu")
    wf = StdWorkflow(_pso(), Sphere(), mesh=mesh)
    assert wf.mesh is None and workflow_mesh(wf) is None
    assert not workflow_topology(wf).meshed


def test_resume_on_two_ranks_equals_the_four_rank_run(tmp_path):
    """Save on 4 ranks after 4 evaluations (keyed problem, per-individual
    keys), resume on the 2-rank mesh to 10: every leaf equals the
    uninterrupted 4-rank run's, bit for bit; the gate refuses the resume
    with ``remesh=False``."""
    out = worker.run_world("elastic", tmp_path / "elastic_world")
    n = len([k for k in out[0] if k.startswith("run4_")])
    assert n > 10
    for rank in (0, 1):
        assert "re-meshing is disabled" in str(out[rank]["gate"])
        for i in range(n):
            np.testing.assert_array_equal(out[rank][f"resumed2_{i}"], out[0][f"run4_{i}"], err_msg=f"leaf {i}")
    for rank in (1, 2, 3):
        for i in range(n):
            np.testing.assert_array_equal(out[rank][f"run4_{i}"], out[0][f"run4_{i}"])
    man = read_manifest(tmp_path / "elastic_world" / "ckpt_4.npz")
    assert man["generation"] == worker.SAVE_AT and man["topology"]["axis_sizes"] == [4]
    assert man["key_impl"] == "threefry2x32"
