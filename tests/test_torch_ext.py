"""The port's extension autoloader (``evox_tpu_torch/autoload_ext.py``)
against the JAX package's (``evox_tpu_ext/autoload_ext.py``), on the CPU.

* the counterparts of the two autoload tests of
  ``tests/test_vis_and_ext.py``, against ``evox_tpu_torch_ext``;
* both loaders graft the same names from the same extension package;
* an ``evox_tpu_ext.metrics`` (a JAX plugin) on the path is not grafted
  into the port;
* ``import evox_tpu_torch`` in a fresh process grafts an installed
  ``evox_tpu_torch_ext.algorithms`` plugin, whose algorithm then steps,
  and imports no JAX.
"""

import importlib
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from evox_tpu_ext import autoload_ext as jautoload  # noqa: E402

import evox_tpu_torch  # noqa: E402
import evox_tpu_torch.algorithms  # noqa: E402
import evox_tpu_torch.metrics  # noqa: E402
from evox_tpu_torch.autoload_ext import auto_load_extensions, load_extension  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _write_package(root: Path, dotted: str, files: dict[str, str]) -> None:
    """``files`` in the package ``dotted`` under ``root`` (its parent
    packages as namespace portions: no ``__init__.py``)."""
    pkg = root.joinpath(*dotted.split("."))
    pkg.mkdir(parents=True)
    for name, text in files.items():
        (pkg / name).write_text(textwrap.dedent(text))


@pytest.fixture
def distro(tmp_path, monkeypatch):
    """A directory on ``sys.path`` to install extension packages into; every
    module imported from it is dropped from ``sys.modules`` afterwards."""
    root = tmp_path / "distro"
    root.mkdir()
    monkeypatch.syspath_prepend(str(root))
    importlib.invalidate_caches()
    for prefix in ("evox_tpu_torch_ext", "evox_tpu_ext."):
        for name in [m for m in sys.modules if m.startswith(prefix)]:
            monkeypatch.delitem(sys.modules, name)
    yield root
    for name in [m for m in sys.modules if m.startswith(("evox_tpu_torch_ext", "evox_tpu_ext."))]:
        sys.modules.pop(name, None)


def _ungraft(module, *names):
    for name in names:
        if name in vars(module):
            delattr(module, name)
        while name in getattr(module, "__all__", []):
            module.__all__.remove(name)


def test_extension_autoload():
    # An installed extension distribution providing
    # evox_tpu_torch_ext.algorithms with one public class.
    ext_pkg = types.ModuleType("fake_ext_algorithms")
    ext_pkg.__path__ = []  # no submodules

    class MyExtAlgo:
        pass

    ext_pkg.MyExtAlgo = MyExtAlgo
    load_extension(ext_pkg, evox_tpu_torch.algorithms)
    try:
        assert evox_tpu_torch.algorithms.MyExtAlgo is MyExtAlgo
        assert "MyExtAlgo" in evox_tpu_torch.algorithms.__all__
    finally:
        _ungraft(evox_tpu_torch.algorithms, "MyExtAlgo")


def test_extension_autoload_submodule(distro):
    # A real namespace package on disk: evox_tpu_torch_ext.metrics with a
    # module exposing a function, grafted into evox_tpu_torch.metrics.
    _write_package(distro, "evox_tpu_torch_ext.metrics",
                   {"__init__.py": "", "extra_metric.py": "def spacing(f):\n    return 0.0\n"})
    ext = importlib.import_module("evox_tpu_torch_ext.metrics")
    load_extension(ext, evox_tpu_torch.metrics)
    try:
        assert hasattr(evox_tpu_torch.metrics, "extra_metric")
        assert evox_tpu_torch.metrics.extra_metric.spacing(None) == 0.0
    finally:
        _ungraft(evox_tpu_torch.metrics, "extra_metric")


def test_both_loaders_graft_the_same_names(distro):
    """The same extension package grafted by each loader into a fresh module
    holding a core submodule, a core function and an ``__all__``: the same
    attributes and the same ``__all__``, colliding submodules merged and a
    core name never shadowed by a module."""
    _write_package(distro, "shared_ext", {
        "__init__.py": """
            def public_fn():
                return 1

            class PublicCls:
                pass

            def _private():
                return 2

            CONSTANT = 3
        """,
        "newmod.py": "X = 1\n",
        "core_fn.py": "Y = 1\n",
    })
    _write_package(distro, "shared_ext.sub", {"__init__.py": "def merged():\n    return 4\n"})
    ext = importlib.import_module("shared_ext")
    try:
        grafted = []
        for loader in (jautoload.load_extension, load_extension):
            target = types.ModuleType("target")
            target.__all__ = ["core_fn", "sub"]
            target.core_fn = lambda: 0
            target.sub = types.ModuleType("target.sub")
            loader(ext, target)
            grafted.append(target)
        j, t = grafted
        assert j.__all__ == t.__all__
        assert sorted(vars(j)) == sorted(vars(t))
        assert t.newmod is j.newmod and t.PublicCls is j.PublicCls and t.public_fn is j.public_fn
        assert t.sub.merged is j.sub.merged
        assert not isinstance(t.core_fn, types.ModuleType) and not hasattr(t, "_private")
        assert not hasattr(t, "CONSTANT")
    finally:
        for name in [m for m in sys.modules if m.startswith("shared_ext")]:
            sys.modules.pop(name, None)


def test_auto_load_grafts_the_ports_plugins_and_never_the_jax_packages(distro):
    _write_package(distro, "evox_tpu_torch_ext.metrics", {"__init__.py": "def torch_spacing(f):\n    return 0.0\n"})
    # A JAX plugin of the same category: the JAX package's own loader would
    # graft it; the port's must not.
    _write_package(distro, "evox_tpu_ext.metrics", {"__init__.py": "def jax_spacing(f):\n    return 0.0\n"})
    try:
        auto_load_extensions()
        assert evox_tpu_torch.metrics.torch_spacing(None) == 0.0
        assert "torch_spacing" in evox_tpu_torch.metrics.__all__
        assert not hasattr(evox_tpu_torch.metrics, "jax_spacing")
        assert "jax_spacing" not in evox_tpu_torch.metrics.__all__
        assert "evox_tpu_ext.metrics" not in sys.modules
    finally:
        _ungraft(evox_tpu_torch.metrics, "torch_spacing")


def test_import_grafts_an_installed_plugin_in_a_fresh_process(tmp_path):
    distro = tmp_path / "distro"
    _write_package(distro, "evox_tpu_torch_ext.algorithms", {"__init__.py": """
        from evox_tpu_torch.algorithms import PSO


        class HalfInertiaPSO(PSO):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, w=0.3, **kwargs)
    """})
    _write_package(distro, "evox_tpu_ext.algorithms", {"__init__.py": "class JaxPlugin:\n    pass\n"})
    code = textwrap.dedent("""
        import sys

        import torch

        import evox_tpu_torch
        from evox_tpu_torch.problems.numerical import Sphere
        from evox_tpu_torch.workflows import StdWorkflow

        Algo = evox_tpu_torch.algorithms.HalfInertiaPSO
        assert "HalfInertiaPSO" in evox_tpu_torch.algorithms.__all__
        assert issubclass(Algo, evox_tpu_torch.Algorithm)
        assert not hasattr(evox_tpu_torch.algorithms, "JaxPlugin")
        wf = StdWorkflow(Algo(16, -torch.ones(4), torch.ones(4), device="cpu"), Sphere())
        state = wf.step(wf.init_step(wf.init(0)))
        assert state.algorithm.pop.shape == (16, 4) and bool(torch.isfinite(state.algorithm.fit).all())
        assert float(state.algorithm.w) == float(torch.tensor(0.3))
        for name in ("jax", "evox_tpu", "evox_tpu_ext", "evox_tpu_ext.algorithms"):
            assert name not in sys.modules, name
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(distro)])
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
