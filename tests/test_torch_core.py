"""The port's core: State semantics, random streams, import isolation and
the default device (``evox_tpu_torch``, held against ``evox_tpu``)."""

import pathlib
import pickle
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import evox_tpu.core as jcore  # noqa: E402
import evox_tpu_torch  # noqa: E402
from evox_tpu_torch.core import (  # noqa: E402
    Mutable,
    Parameter,
    State,
    get_params,
    set_params,
    use_state,
)
from evox_tpu_torch.utils import rng  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "evox_tpu_torch"


def _both():
    """The same nested state built in both frameworks."""
    t = State(
        w=Parameter(0.5),
        pop=torch.zeros(3, 2),
        sub=State(lr=Parameter(0.1), count=Mutable(3)),
    )
    j = jcore.State(
        w=jcore.Parameter(0.5),
        pop=jnp.zeros((3, 2)),
        sub=jcore.State(lr=jcore.Parameter(0.1), count=jcore.Mutable(3)),
    )
    return t, j


def test_state_is_immutable_and_replace_returns_new():
    t, _ = _both()
    with pytest.raises(AttributeError):
        t.pop = torch.ones(3, 2)
    t2 = t.replace(pop=torch.ones(3, 2), extra=Parameter(2.0))
    assert torch.equal(t.pop, torch.zeros(3, 2))
    assert torch.equal(t2.pop, torch.ones(3, 2))
    assert "extra" not in t and t2.param_keys == {"w", "extra"}
    assert dict(t2.sub) == dict(t.sub)
    with pytest.raises(AttributeError):
        t.missing


def test_state_param_labels_match_jax():
    t, j = _both()
    assert t.param_keys == j.param_keys
    assert t.sub.param_keys == j.sub.param_keys
    assert list(t) == list(j) and len(t) == len(j)
    assert set(get_params(t)) == set(jcore.get_params(j)) == {"w", "sub.lr"}
    np.testing.assert_allclose(float(get_params(t)["sub.lr"]), float(jcore.get_params(j)["sub.lr"]))


def test_set_params_nested_and_unknown_paths():
    t, j = _both()
    t2 = set_params(t, {"w": torch.tensor(0.9), "sub.lr": torch.tensor(0.2)})
    j2 = jcore.set_params(j, {"w": jnp.asarray(0.9), "sub.lr": jnp.asarray(0.2)})
    for path in ("w", "sub.lr"):
        np.testing.assert_allclose(
            float(get_params(t2)[path]), float(jcore.get_params(j2)[path]), rtol=1e-7
        )
    assert float(t.w) == 0.5  # the original is untouched
    for bad in ({"pop": torch.ones(1)}, {"pop.x": torch.ones(1)}):
        with pytest.raises(KeyError):
            set_params(t, bad)
        with pytest.raises(KeyError):
            jcore.set_params(j, {k: jnp.ones(1) for k in bad})


def test_state_pickles_and_use_state_is_identity():
    t, _ = _both()
    back = pickle.loads(pickle.dumps(t))
    assert back.param_keys == t.param_keys and torch.equal(back.pop, t.pop)
    assert "w*=" in repr(t)

    def f(s):
        return s

    assert use_state(f) is f


def test_rng_split_is_deterministic_and_advances():
    k = rng.key(7)
    k1, a = rng.split(k, 3)
    k1b, b = rng.split(k, 3)

    def values(seeds):
        # Each child seed's 64-bit Philox key (the seeds are device values).
        return [int(rng.seed_value(s)) & (2**64 - 1) for s in seeds]

    assert values(a) == values(b) and torch.equal(k1, k1b)
    assert len(set(values(a))) == 3 and all(0 <= s < 2**64 for s in values(a))
    assert k1.tolist() == [7, 3] and k.tolist() == [7, 0]
    _, c = rng.split(k1, 3)
    assert not set(values(a)) & set(values(c))
    keys = rng.split_keys(k, 2)
    assert [int(x[1]) for x in keys] == [0, 0] and keys[0][0] != keys[1][0]
    with pytest.raises(ValueError):
        rng.split(torch.tensor([1, 2], dtype=torch.int32))


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors (the CUDA
    kernel computes the same function; ``chip_smoke.py`` holds the two
    equal bit for bit)."""
    cases = [
        ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (
            (0xFFFFFFFF,) * 4,
            0xFFFFFFFFFFFFFFFF,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
        ),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            0x299F31D0A4093822,
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ]
    for ctr, seed, want in cases:
        out = rng.philox4x32([torch.tensor([c], dtype=torch.int64) for c in ctr], seed)
        assert tuple(int(w) for w in out) == want


@pytest.mark.parametrize("dtype,m", [(torch.float32, 24), (torch.bfloat16, 7)])
def test_rng_uniform_bits_and_determinism(dtype, m):
    u = rng.uniform(123, (200, 50), dtype, device="cpu")
    assert u.dtype == dtype and u.shape == (200, 50)
    assert torch.equal(u, rng.uniform(123, (200, 50), dtype, device="cpu"))
    assert not torch.equal(u, rng.uniform(124, (200, 50), dtype, device="cpu"))
    x = u.double()
    assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
    # Every value is k / 2^m exactly.
    assert torch.equal(x * 2**m, torch.floor(x * 2**m))
    assert abs(float(x.mean()) - 0.5) < 0.02


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, evox_tpu_torch, evox_tpu_torch.algorithms, "
        "evox_tpu_torch.problems, evox_tpu_torch.workflows, evox_tpu_torch.ops, "
        "evox_tpu_torch.utils.convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'evox_tpu' or m.startswith('evox_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_source_imports_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+(jax|evox_tpu)\b(?!_)|from\s+(jax|evox_tpu)(\s|\.))", re.M
    )
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from evox_tpu_torch.algorithms import PSO
    from evox_tpu_torch.problems.numerical import Sphere
    from evox_tpu_torch.utils.convert import state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evox_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PSO(10, -torch.ones(3), torch.ones(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sphere(shift=np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"x": np.zeros(2)})
    assert PSO(10, -torch.ones(3), torch.ones(3), device="cpu").device.type == "cpu"
    Sphere()  # no tensors held: needs no device
