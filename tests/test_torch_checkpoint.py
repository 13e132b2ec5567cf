"""The port's checkpoint store (``evox_tpu_torch/utils/checkpoint.py``),
case for case against ``tests/test_parallel_and_checkpoint.py``'s, plus
digests, bfloat16 leaves, the precision guard, the async writer and the
archive format shared with the JAX package: each package's
``verify_checkpoint`` accepts the other's archive and their non-key leaves
load bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from evox_tpu.algorithms import PSO as JPSO  # noqa: E402
from evox_tpu.core import State as JState  # noqa: E402
from evox_tpu.problems.numerical import Sphere as JSphere  # noqa: E402
from evox_tpu.utils import checkpoint as jckpt  # noqa: E402
from evox_tpu.workflows import StdWorkflow as JWorkflow  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.core import State  # noqa: E402
from evox_tpu_torch.precision import PrecisionPolicy, precision_tag  # noqa: E402
from evox_tpu_torch.problems.numerical import Sphere  # noqa: E402
from evox_tpu_torch.utils import (  # noqa: E402
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    CheckpointError,
    CheckpointStore,
    ReadOnlyCheckpointStore,
    atomic_write_text,
    graph,
    load_state,
    quarantine_target,
    read_manifest,
    save_state,
    verify_checkpoint,
)
from evox_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

DIM = 8


def _pso(n=16):
    return PSO(n, -10.0 * torch.ones(DIM), 10.0 * torch.ones(DIM), device="cpu")


def _same(a, b):
    la, sa = graph.flatten(a)
    lb, sb = graph.flatten(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device and torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path):
    wf = StdWorkflow(_pso(), Sphere(), monitor=EvalMonitor())
    state = wf.init_step(wf.init(0))
    for _ in range(3):
        state = wf.step(state)
    path = tmp_path / "ckpt.npz"
    save_state(path, state)
    restored = load_state(path, wf.init(999))
    _same(restored, state)
    # Continuing from the restored state is continuing the original.
    _same(wf.step(wf.step(restored)), wf.step(wf.step(state)))


def test_checkpoint_zero_dim_leaves(tmp_path):
    """0-dim leaves (hyperparameters, counters) keep their shape and dtype."""
    state = State(lr=torch.tensor(0.05), steps=torch.tensor(3), pop=torch.zeros((4, 2)))
    save_state(tmp_path / "weak.npz", state)
    restored = load_state(tmp_path / "weak.npz", State(lr=torch.tensor(0.0), steps=torch.tensor(0),
                                                       pop=torch.ones((4, 2))))
    _same(restored, state)


def test_checkpoint_suffixless_path_round_trips(tmp_path):
    written = save_state(tmp_path / "ckpt", State(a=torch.arange(3.0)))
    assert written.name == "ckpt.npz"
    restored = load_state(tmp_path / "ckpt", State(a=torch.zeros(3)))
    np.testing.assert_array_equal(restored.a.numpy(), np.arange(3.0))


def test_checkpoint_missing_leaf_raises(tmp_path):
    save_state(tmp_path / "s.npz", State(a=torch.zeros(3)))
    with pytest.raises(ValueError, match="no entry for state leaf 'b'"):
        load_state(tmp_path / "s.npz", State(a=torch.zeros(3), b=torch.ones(2)))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_state(tmp_path / "s.npz", State(a=torch.zeros(3)))
    with pytest.raises(ValueError, match=r"leaf 'a' has shape \(3,\)"):
        load_state(tmp_path / "s.npz", State(a=torch.zeros(4)))


def test_checkpoint_size_zero_placeholder_adopts_shape(tmp_path):
    save_state(tmp_path / "s.npz", State(buf=torch.arange(6.0).reshape(2, 3)))
    restored = load_state(tmp_path / "s.npz", State(buf=torch.empty((0,))))
    assert restored.buf.shape == (2, 3) and restored.buf.dtype == torch.float32


def test_checkpoint_dtype_kind_mismatch_raises(tmp_path):
    save_state(tmp_path / "s.npz", State(a=torch.zeros(3, dtype=torch.float32)))
    # Width changes cast (a float64 writer's archive loads into float32)...
    save_state(tmp_path / "w.npz", {"a": torch.zeros(3, dtype=torch.float64)})
    assert load_state(tmp_path / "w.npz", {"a": torch.zeros(3)})["a"].dtype == torch.float32
    # ...kind changes do not...
    with pytest.raises(ValueError, match="cannot be safely cast"):
        load_state(tmp_path / "s.npz", State(a=torch.zeros(3, dtype=torch.int32)))
    # ...and narrow storage widths never cross silently.
    with pytest.raises(ValueError, match="precision boundary"):
        load_state(tmp_path / "s.npz", State(a=torch.zeros(3, dtype=torch.float16)))
    with pytest.raises(ValueError, match="precision boundary"):
        load_state(tmp_path / "s.npz", State(a=torch.zeros(3, dtype=torch.bfloat16)))


def test_checkpoint_manifest_round_trip(tmp_path):
    written = save_state(tmp_path / "s.npz", State(a=torch.zeros(3)), generation=17, metadata={"x": 1})
    man = read_manifest(written)
    assert man["generation"] == 17 and man["format"] == 2 and man["x"] == 1
    assert "evox_tpu_version" in man and "torch_version" in man
    assert set(man["leaf_digests"]) == {"a"} and man["n_leaves"] == 1
    assert man["topology"]["axis_names"] == [] and man["topology"]["platform"] == "cpu"
    assert "key_impl" not in man  # no key leaf


def test_checkpoint_atomic_write_replaces(tmp_path):
    path = tmp_path / "s.npz"
    save_state(path, State(a=torch.zeros(3)), generation=1)
    save_state(path, State(a=torch.ones(3)), generation=2, durable=True)
    assert read_manifest(path)["generation"] == 2
    np.testing.assert_array_equal(load_state(path, State(a=torch.zeros(3))).a.numpy(), np.ones(3))
    assert [p.name for p in tmp_path.iterdir()] == ["s.npz"]


def test_checkpoint_truncated_file_raises_checkpoint_error(tmp_path):
    path = save_state(tmp_path / "s.npz", State(a=torch.zeros(3)))
    path.write_bytes(path.read_bytes()[:20])
    with pytest.raises(CheckpointError, match="unreadable"):
        read_manifest(path)
    with pytest.raises(CheckpointCorruptError, match="unreadable"):
        load_state(path, State(a=torch.zeros(3)))
    with pytest.raises(FileNotFoundError):
        read_manifest(tmp_path / "absent.npz")


def test_checkpoint_allow_missing_keeps_template(tmp_path):
    save_state(tmp_path / "s.npz", State(a=torch.zeros(3)))
    bigger = State(a=torch.full((3,), 7.0), b=torch.ones(2))
    with pytest.warns(UserWarning, match="keeping the template value"):
        restored = load_state(tmp_path / "s.npz", bigger, allow_missing=True)
    np.testing.assert_array_equal(restored.a.numpy(), np.zeros(3))
    np.testing.assert_array_equal(restored.b.numpy(), np.ones(2))


def _flip_byte(path, needle: bytes):
    """Flip one byte inside the stored bytes of an entry (located by its
    content), keeping the zip structure intact."""
    raw = bytearray(path.read_bytes())
    at = raw.find(needle)
    assert at > 0
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))


def test_flipped_byte_is_caught_by_verify(tmp_path):
    data = torch.arange(64, dtype=torch.float32) * 1.2345
    path = save_state(tmp_path / "s.npz", State(a=data))
    assert verify_checkpoint(path)["format"] == 2
    _flip_byte(path, data.numpy().tobytes()[8:16])
    # The digest (or, for a member read whole, zip's CRC) catches it.
    with pytest.raises(CheckpointCorruptError, match="digest mismatch|unreadable"):
        verify_checkpoint(path)
    with pytest.raises(CheckpointCorruptError):
        load_state(path, State(a=torch.zeros(64)), verify=True)
    # The manifest-only mode does not read leaf bytes.
    verify_checkpoint(path, leaves=False)


def test_verify_refuses_archives_without_a_manifest(tmp_path):
    np.savez(tmp_path / "plain.npz", a=np.zeros(3))
    with pytest.raises(CheckpointError, match="no __manifest__"):
        verify_checkpoint(tmp_path / "plain.npz")
    with pytest.raises(CheckpointError, match="no __manifest__"):
        read_manifest(tmp_path / "plain.npz")


def test_bfloat16_round_trip_and_precision_guard(tmp_path):
    """bfloat16 leaves ride as a ``__bf16__/`` uint16 view, bit for bit; a
    bfloat16 archive refuses a float32 load through ``check_precision``."""
    policy = PrecisionPolicy()
    wf = StdWorkflow(_pso(), Sphere(), precision=policy)
    state = wf.step(wf.init_step(wf.init(1)))
    assert state.algorithm.pop.dtype == torch.bfloat16
    path = save_state(tmp_path / "b.npz", state, metadata={"precision": precision_tag(policy)})
    with np.load(path) as data:
        assert data["__bf16__/algorithm/pop"].dtype == np.uint16
    restored = load_state(path, wf.init(5), precision=policy, verify=True)
    _same(restored, state)
    with pytest.raises(CheckpointError, match="precision policy mismatch"):
        load_state(path, wf.init(5), precision=None)
    f32 = StdWorkflow(_pso(), Sphere())
    with pytest.raises(CheckpointError, match="precision boundary"):
        load_state(path, f32.init(5))


def test_key_leaves_ride_under_their_own_tag(tmp_path):
    wf = StdWorkflow(_pso(), Sphere(), key_impl="rbg")
    state = wf.init_step(wf.init(2))
    path = save_state(tmp_path / "k.npz", state)
    man = read_manifest(path)
    assert man["key_impl"] == "rbg" and man["key_format"] == ckpt.KEY_PREFIX
    assert "__torch_key__/algorithm/key" in man["leaf_digests"]
    load_state(path, state, key_impl="rbg")
    with pytest.raises(CheckpointError, match="key-impl mismatch"):
        load_state(path, state, key_impl=None)


def test_stores_and_atomic_text(tmp_path):
    p = atomic_write_text(tmp_path / "t.json", json.dumps({"a": 1}), durable=True)
    assert json.loads(p.read_text()) == {"a": 1}
    assert [x.name for x in tmp_path.iterdir()] == ["t.json"]
    ro = ReadOnlyCheckpointStore("test")
    with pytest.raises(OSError, match="read-only"):
        save_state(tmp_path / "s.npz", State(a=torch.zeros(2)), store=ro)

    class Failing(CheckpointStore):
        def write_archive(self, f, arrays):
            raise OSError(28, "no space")

    with pytest.raises(OSError, match="no space"):
        save_state(tmp_path / "f.npz", State(a=torch.zeros(2)), store=Failing())
    assert sorted(x.name for x in tmp_path.iterdir()) == ["t.json"]  # no temp litter
    (tmp_path / "c.npz").write_bytes(b"x")
    (tmp_path / "c.npz.corrupt").write_bytes(b"x")
    assert quarantine_target(tmp_path / "c.npz").name == "c.npz.corrupt.1"


def test_async_writer_publishes_and_reports_failures(tmp_path):
    wf = StdWorkflow(_pso(), Sphere())
    state = wf.init_step(wf.init(0))
    seen = []
    writer = AsyncCheckpointWriter(on_error=lambda p, e: seen.append(p), idle_timeout=0.2)
    for gen in range(3):
        state = wf.step(state)
        writer.submit(tmp_path / f"c{gen}.npz", state, generation=gen)
    assert writer.barrier(timeout=60)
    assert writer.writes_completed == 3 and not writer.pop_errors()
    _same(load_state(tmp_path / "c2.npz", wf.init(7)), state)
    writer.submit(tmp_path / "missing" / "c.npz", state)
    assert writer.close(timeout=60)
    errors = writer.pop_errors()
    assert len(errors) == 1 and seen == [errors[0][0]]
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(tmp_path / "x.npz", state)


# ---------------------------------------------------------------------------
# the format shared with the JAX package
# ---------------------------------------------------------------------------


def test_cross_package_archives(tmp_path):
    """An archive the port wrote passes the JAX package's verify_checkpoint
    and the other way round; their non-key leaves are the same arrays bit
    for bit, and each package loads the other's non-key leaves into its own
    template (the keys draw different streams and are refused)."""
    g = np.random.default_rng(0)
    leaves = {
        "pop": g.standard_normal((16, DIM)).astype(np.float32),
        "fit": g.standard_normal(16).astype(np.float32),
        "count": np.arange(5, dtype=np.int32),
        "w": np.float32(0.6),
    }
    port = State(algorithm=State(**{k: torch.from_numpy(np.array(v)) for k, v in leaves.items()},
                                 key=torch.tensor([3, 0])),
                 monitor=State(bf=torch.from_numpy(leaves["fit"]).to(torch.bfloat16)))
    jax_state = JState(algorithm=JState(**{k: jnp.asarray(v) for k, v in leaves.items()},
                                        key=jax.random.key(3)),
                       monitor=JState(bf=jnp.asarray(leaves["fit"]).astype(jnp.bfloat16)))
    mine = save_state(tmp_path / "port.npz", port, generation=4)
    theirs = jckpt.save_state(tmp_path / "jax.npz", jax_state, generation=4)
    for path in (mine, theirs):
        assert jckpt.verify_checkpoint(path)["format"] == 2
        assert verify_checkpoint(path)["format"] == 2
    with np.load(mine) as a, np.load(theirs) as b:
        for name in ("algorithm/pop", "algorithm/fit", "algorithm/count", "algorithm/w", "__bf16__/monitor/bf"):
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
            assert a[name].tobytes() == b[name].tobytes(), name
            assert json.loads(str(a["__manifest__"]))["leaf_digests"][name] == \
                json.loads(str(b["__manifest__"]))["leaf_digests"][name]
        assert "__torch_key__/algorithm/key" in a.files and "__key__/algorithm/key" in b.files
    # Non-key leaves load across; keys are refused by name.
    with pytest.raises(CheckpointError, match="not the port's"):
        load_state(theirs, port)
    restored = load_state(theirs, State(algorithm=State(**{k: v for k, v in port.algorithm.items() if k != "key"}),
                                        monitor=port.monitor))
    _same(restored.algorithm, State(**{k: v for k, v in port.algorithm.items() if k != "key"}))
    _same(restored.monitor, port.monitor)
    with pytest.raises(jckpt.CheckpointError, match="algorithm/key"):
        jckpt.load_state(mine, jax_state)
    back = jckpt.load_state(mine, JState(algorithm=JState(**{k: jnp.zeros_like(jnp.asarray(v))
                                                              for k, v in leaves.items()}),
                                         monitor=jax_state.monitor))
    for k, v in leaves.items():
        np.testing.assert_array_equal(np.asarray(back.algorithm[k]), v)


def test_port_archive_of_a_workflow_state_passes_jax_verify(tmp_path):
    """A whole PSO workflow state (port) against the JAX package's archive of
    its own PSO state: the same entry names, less the key's tag."""
    wf = StdWorkflow(_pso(), Sphere(), monitor=EvalMonitor())
    path = save_state(tmp_path / "wf.npz", wf.init_step(wf.init(0)))
    man = jckpt.verify_checkpoint(path)
    jwf = JWorkflow(JPSO(16, -10 * jnp.ones(DIM), 10 * jnp.ones(DIM)), JSphere())
    jpath = jckpt.save_state(tmp_path / "jwf.npz", jwf.init(jax.random.key(0)))
    jman = jckpt.read_manifest(jpath)
    ours = {n for n in man["leaf_digests"] if n.startswith("algorithm/")}
    theirs = {n for n in jman["leaf_digests"] if n.startswith("algorithm/")}
    assert ours == theirs
    assert os.path.getsize(path) > 0
