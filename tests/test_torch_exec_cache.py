"""The port's persistent program cache (``evox_tpu_torch/utils/exec_cache.py``)
on the CPU, held to the JAX package's cache contract (``tests/test_daemon.py``'s
exec-cache cases): the round trip across instances, a one-bit flip and a
truncated entry quarantined, a stale environment quarantined by content, a
failed save an event and not an abort; ``abstract_signature`` keyed by
path, shape and dtype (paths and shapes equal to the JAX package's); the
pack's prewarm reporting true provenance; the runner's shared cache keeping
two same-shaped workflows apart; ``ops/_build.py``'s verified install and
library sources (no ``nvcc`` here: libraries are bytes under their current
names).  On the card, ``tests/test_torch_cuda.py`` holds a capture record's
real libraries and a warm process with an empty build directory.
"""

import hashlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from evox_tpu.utils import abstract_signature as jabstract_signature  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.ops import _build  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley, Sphere  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore, ResilientRunner  # noqa: E402
from evox_tpu_torch.resilience.testing import flip_bit, silent  # noqa: E402
from evox_tpu_torch.service import TenantPack  # noqa: E402
from evox_tpu_torch.utils import (  # noqa: E402
    ExecCacheStats,
    ExecutableCache,
    abstract_signature,
    enable_xla_compilation_cache,
    exec_cache,
    rng,
)
from evox_tpu_torch.utils.exec_cache import CaptureRecord, capture_record  # noqa: E402
from evox_tpu_torch.workflows import EvalMonitor, StdWorkflow  # noqa: E402

DIM, POP = 4, 8


def toy_program():
    """A picklable program: a capture record of one library's bytes."""
    return CaptureRecord(libraries={"libtoy.so": (hashlib.sha256(b"toy").hexdigest(), b"toy")})


def sig():
    return abstract_signature(torch.ones(4))


def pso_workflow(problem=None):
    algo = PSO(POP, torch.full((DIM,), -32.0), torch.full((DIM,), 32.0), device="cpu")
    return StdWorkflow(algo, problem if problem is not None else Ackley(), monitor=EvalMonitor(ordered=False))


def test_exec_cache_roundtrip_across_instances(tmp_path):
    cache = ExecutableCache(tmp_path / "exec")
    assert cache.load("toy", sig()) is None
    program, hit = cache.get_or_compile("toy", sig(), toy_program)
    assert not hit and cache.stats.saves == 1 and cache.stats.misses == 2
    # A fresh instance (= a restarted process's view of the directory).
    cache2 = ExecutableCache(tmp_path / "exec")
    loaded = cache2.load("toy", sig())
    assert loaded == program and cache2.stats.hits == 1
    again, hit = cache2.get_or_compile("toy", sig(), toy_program)
    assert hit and again == program
    assert isinstance(cache2.stats, ExecCacheStats) and cache2.stats.quarantines == 0


def test_exec_cache_corrupt_entry_quarantined_never_trusted(tmp_path):
    cache = ExecutableCache(tmp_path / "exec")
    cache.get_or_compile("toy", sig(), toy_program)
    path = cache.entry_path("toy", sig())
    blob = bytearray(path.read_bytes())
    blob[-20] ^= 0x01  # single-bit flip in the pickled program
    path.write_bytes(bytes(blob))
    cache2 = ExecutableCache(tmp_path / "exec")
    assert silent(cache2.load, "toy", sig()) is None
    assert cache2.stats.quarantines == 1
    assert "digest mismatch" in cache2.stats.quarantined[0][1]
    assert (path.parent / (path.name + ".corrupt")).exists()
    assert not path.exists()
    # A re-save then works, and the first corruption's evidence stays.
    cache2.get_or_compile("toy", sig(), toy_program)
    assert cache2.load("toy", sig()) == toy_program()
    assert (path.parent / (path.name + ".corrupt")).exists()


@pytest.mark.parametrize("keep", [4, 20, 40, -3])
def test_exec_cache_truncated_entry_quarantined(tmp_path, keep):
    """A torn write's survivor at every depth: inside the magic, inside the
    header JSON, just past it, and short of the payload's end."""
    cache = ExecutableCache(tmp_path / "exec")
    cache.get_or_compile("toy", sig(), toy_program)
    path = cache.entry_path("toy", sig())
    path.write_bytes(path.read_bytes()[:keep])
    cache2 = ExecutableCache(tmp_path / "exec")
    assert silent(cache2.load, "toy", sig()) is None
    assert cache2.stats.quarantines == 1 and cache2.stats.misses == 1


def test_exec_cache_stale_key_material_quarantined(tmp_path, monkeypatch):
    """An entry whose recorded environment no longer matches (another
    torch version, card count, kernel source) is quarantined, not loaded."""
    cache = ExecutableCache(tmp_path / "exec")
    cache.get_or_compile("toy", sig(), toy_program)
    blob = cache.entry_path("toy", sig()).read_bytes()
    real = exec_cache._environment_fingerprint()
    monkeypatch.setattr(
        exec_cache, "_environment_fingerprint", lambda: {**real, "device_count": real["device_count"] + 8}
    )
    cache2 = ExecutableCache(tmp_path / "exec")
    # The new fingerprint keys another path; plant the stale entry there
    # to prove content (not file name) is what gates the load.
    cache2.entry_path("toy", sig()).write_bytes(blob)
    assert silent(cache2.load, "toy", sig()) is None
    assert cache2.stats.quarantines == 1
    assert "stale entry" in cache2.stats.quarantined[0][1]
    assert "device_count" in cache2.stats.quarantined[0][1]


def test_exec_cache_save_failure_is_event_not_abort(tmp_path):
    store = FaultyStore(enospc_saves=[0])
    events = []
    cache = ExecutableCache(tmp_path / "exec", store=store, on_event=events.append)
    program, hit = cache.get_or_compile("toy", sig(), toy_program)
    assert not hit and cache.stats.save_failures == 1 and cache.stats.saves == 0
    # The live program is still the caller's; nothing was published, and
    # no temp file is left behind.
    assert program == toy_program()
    assert cache.load("toy", sig()) is None
    assert list((tmp_path / "exec").iterdir()) == []
    assert any("failed" in e and "No space left" in e for e in events)


def test_exec_cache_unpicklable_program_is_a_save_failure(tmp_path):
    cache = ExecutableCache(tmp_path / "exec")
    program, hit = silent(cache.get_or_compile, "toy", sig(), lambda: (lambda x: x))
    assert not hit and callable(program) and cache.stats.save_failures == 1


def test_exec_cache_key_material_and_metrics(tmp_path):
    """The entry's key: label, signature and environment (torch and CUDA
    versions, card, world size, each kernel library's hashed name); the
    registry counters of the JAX package."""
    from evox_tpu_torch.obs import MetricsRegistry

    env = exec_cache._environment_fingerprint()
    assert env["device"] == ("cpu" if not torch.cuda.is_available() else torch.cuda.get_device_name(0))
    assert env["world_size"] == 1 and env["torch_version"] == torch.__version__
    assert env["kernels"] == _build.library_names() and set(env["kernels"]) == set(_build.SOURCES)
    reg = MetricsRegistry()
    cache = ExecutableCache(tmp_path / "exec", registry=reg)
    assert cache.entry_path("a", sig()) != cache.entry_path("b", sig())
    assert cache.entry_path("a", sig()) != cache.entry_path("a", abstract_signature(torch.ones(5)))
    # The name is a digest of the key alone: the same in another directory.
    assert cache.entry_path("a", sig()).name == ExecutableCache(tmp_path / "other").entry_path("a", sig()).name
    cache.get_or_compile("a", sig(), toy_program)
    cache.load("a", sig())
    text = reg.to_prometheus()
    for name, value in (("misses", 1), ("saves", 1), ("hits", 1)):
        assert f"evox_exec_cache_{name}_total {value}" in text, name


def test_abstract_signature_keys_by_path_shape_and_dtype():
    a = {"x": torch.zeros(3, 2), "y": (torch.zeros(4, dtype=torch.int64), 7)}
    assert abstract_signature(a) == abstract_signature({"x": torch.ones(3, 2), "y": (torch.ones(4, dtype=torch.int64), 9)})
    for other in (
        {"x": torch.zeros(3, 3), "y": (torch.zeros(4, dtype=torch.int64), 7)},  # shape
        {"x": torch.zeros(3, 2, dtype=torch.float64), "y": (torch.zeros(4, dtype=torch.int64), 7)},  # dtype
        {"z": torch.zeros(3, 2), "y": (torch.zeros(4, dtype=torch.int64), 7)},  # path
    ):
        assert abstract_signature(a) != abstract_signature(other)
    # The paths and shapes of the JAX package's signature of the same tree.
    j = {"x": jnp.zeros((3, 2)), "y": (jnp.zeros(4, dtype=jnp.int32), 7)}
    got = [(p, s) for p, s, _ in abstract_signature(a)]
    want = [(p, s) for p, s, _ in jabstract_signature(j)]
    assert got == want
    assert [d for _, _, d in abstract_signature(a)] == ["torch.float32", "torch.int64", "int"]


def test_prewarm_reports_true_provenance_on_reruns(tmp_path):
    """A re-prewarm reports where an installed program ACTUALLY came from;
    a new pack over the same cache reports hits; a new cadence is a miss."""
    cache = ExecutableCache(tmp_path / "exec")
    wf = pso_workflow()
    state = wf.setup(rng.key(0, "cpu"))
    pack = TenantPack(wf, 2)
    first = pack.prewarm(state, 4, cache=cache, label="b")
    assert list(first.values()) == [False, False] and cache.stats.saves == 2
    second = pack.prewarm(state, [4, 8], cache=cache, label="b")
    assert list(second.values()) == [False, False, False] and cache.stats.saves == 3
    # Another process's pack of the same bucket.
    other = TenantPack(pso_workflow(), 2)
    third = other.prewarm(state, [4, 8, 12], cache=cache, label="b")
    assert list(third.values()) == [True, True, True, False]
    assert all(v is False for v in TenantPack(pso_workflow(), 2).prewarm(state, 4, cache=None).values())
    # Another lane count or label keys other entries.
    assert not any(TenantPack(pso_workflow(), 3).prewarm(state, 4, cache=cache, label="b").values())
    assert other._graphs.max_graphs >= 4


def test_runner_shared_exec_cache_isolates_programs(tmp_path):
    """Two workflows with identically-shaped states but different problems
    must not share an entry of a shared runner cache: the label is salted
    with the workflow's static-configuration digest."""
    from evox_tpu_torch.obs import MetricsRegistry, Observability

    cache = ExecutableCache(tmp_path / "exec")

    def run(problem, tag, registry=None):
        wf = pso_workflow(problem)
        obs = Observability(registry=registry) if registry is not None else False
        runner = ResilientRunner(wf, tmp_path / tag, checkpoint_every=4, exec_cache=cache, preemption=False, obs=obs)
        return silent(runner.run, wf.init(0), n_steps=9)

    run(Ackley(), "a")
    assert (cache.stats.hits, cache.stats.misses, cache.stats.saves) == (0, 1, 1)
    run(Sphere(), "b")  # same shapes, another program
    assert (cache.stats.hits, cache.stats.misses, cache.stats.saves) == (0, 2, 2)
    reg = MetricsRegistry()
    run(Ackley(), "c", reg)  # the first program again: a load
    assert (cache.stats.hits, cache.stats.misses) == (1, 2)
    assert "evox_runner_exec_cache_loads_total 1" in reg.to_prometheus()


def test_build_install_checks_and_counts(tmp_path, monkeypatch):
    """``_build.install``: a wrong SHA-256 or a name that is no current
    library is refused and nothing is written; the right bytes land
    atomically once, and count."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build.counts, "installs", 0)
    name = _build.library_names()["probe"]
    data = b"\x7fELF not really a library"
    sha = hashlib.sha256(data).hexdigest()
    with pytest.raises(ValueError, match="SHA-256"):
        _build.install(name, data, hashlib.sha256(b"other").hexdigest())
    with pytest.raises(ValueError, match="no library"):
        _build.install("libprobe-0000000000000000.so", data, sha)
    assert not (tmp_path / "build").exists() or list((tmp_path / "build").iterdir()) == []
    assert _build.install(name, data, sha) is True
    assert (tmp_path / "build" / name).read_bytes() == data
    assert _build.install(name, data, sha) is False
    assert _build.counts["installs"] == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [name]


def test_cache_supplies_its_libraries_to_builds(tmp_path, monkeypatch):
    """A cache's entries carry libraries: a build of a missing library asks
    the live caches first and installs the verified bytes (no ``nvcc``); a
    record with a damaged library is passed over; a stale entry supplies
    nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build.counts, "installs", 0)
    monkeypatch.setattr(_build, "_sources", [])
    names = _build.library_names()
    good, bad = b"pso_move bytes", b"philox bytes"
    record = CaptureRecord(libraries={
        names["pso_move"]: (hashlib.sha256(good).hexdigest(), good),
        names["philox"]: (hashlib.sha256(b"something else").hexdigest(), bad),
    })
    cache = ExecutableCache(tmp_path / "exec")
    cache.save("segment[4]", sig(), record)
    assert cache.library(names["pso_move"]) == (good, hashlib.sha256(good).hexdigest())
    assert cache.library(names["dominance"]) is None
    assert _build._supplied(names["pso_move"]) and (tmp_path / "build" / names["pso_move"]).read_bytes() == good
    assert not _build._supplied(names["philox"]) and not (tmp_path / "build" / names["philox"]).exists()
    assert _build.counts["installs"] == 1
    # An entry of another environment supplies nothing.
    (tmp_path / "build" / names["pso_move"]).unlink()
    real = exec_cache._environment_fingerprint()
    monkeypatch.setattr(exec_cache, "_environment_fingerprint", lambda: {**real, "torch_version": "other"})
    assert cache.library(names["pso_move"]) is None and not _build._supplied(names["pso_move"])
    monkeypatch.setattr(exec_cache, "_environment_fingerprint", lambda: real)
    # A collected cache supplies nothing.
    del cache
    import gc

    gc.collect()
    assert not _build._supplied(names["pso_move"]) and _build._sources == []


def test_capture_record_holds_the_loaded_libraries(tmp_path, monkeypatch):
    lib = tmp_path / "libfake-1234.so"
    lib.write_bytes(b"fake library")
    monkeypatch.setattr(_build, "loaded", lambda: {"fake": lib})
    record = capture_record()
    assert record.libraries == {lib.name: (hashlib.sha256(b"fake library").hexdigest(), b"fake library")}
    monkeypatch.setattr(_build, "loaded", lambda: {})
    assert capture_record().libraries == {}


def test_enable_xla_compilation_cache_points_the_bytecode_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    assert enable_xla_compilation_cache(tmp_path / "pyc") is True
    assert sys.pycache_prefix == str((tmp_path / "pyc").resolve()) and not sys.dont_write_bytecode
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert enable_xla_compilation_cache(blocker / "sub") is False


def test_flip_bit_flips_exactly_one_bit(tmp_path):
    path = tmp_path / "f"
    path.write_bytes(bytes(range(10)))
    flip_bit(path)
    got = np.frombuffer(path.read_bytes(), dtype=np.uint8)
    diff = got ^ np.arange(10, dtype=np.uint8)
    assert diff.tolist() == [0] * 5 + [1] + [0] * 4
    flip_bit(path, offset=0)
    assert path.read_bytes()[0] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert silent(lambda: warnings.warn("muted") or 3) == 3
