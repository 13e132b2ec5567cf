"""Every module's exports against the JAX package's, read with ``ast``.

* For each module of ``evox_tpu`` with an ``__all__`` (and the JAX
  autoloader ``evox_tpu_ext/autoload_ext.py``), every exported name is
  exported by the port's module of the same path too, unless it is one of
  the named stand-ins below (a deliberate other form, each with its
  reason) or on the port module's ``_NOT_PORTED`` list; reaching either
  raises ``ImportError`` naming it.  No module of the port keeps a
  ``_NOT_PORTED`` name any more (the last, ``obs/xla.py``'s bench half,
  is exported).
* Each class of the JAX package has every public method of its same-named
  counterpart in the port, less the JAX pytree protocol of ``State``.
* The port and ``chip_smoke.py`` import nothing of ``jax``, ``evox_tpu``
  or ``evox_tpu_ext``.
* ``compile_uncached`` calls its function once.
"""

import ast
import importlib
from pathlib import Path

import pytest

from evox_tpu.utils import exec_cache as jexec_cache  # noqa: E402

from evox_tpu_torch.utils import exec_cache  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "evox_tpu", ROOT / "evox_tpu_torch"

# JAX modules whose counterpart lives in another module of the port:
# JAX path -> (port path, why).
MODULE_STAND_INS = {
    "algorithms/so/pso_variants/pallas_pso.py": (
        "algorithms/so/pso_variants/pso.py",
        "PSO runs the move kernel on every step, so PallasPSO is PSO with the choice of where its draws are made",
    ),
    "ops/pallas_gate.py": (
        "ops/probe.py",
        "the port gates nothing: the probe builds and launches csrc/probe.cu and keeps no verdict",
    ),
}

# Names the port has in another form: (JAX path, name) -> why.  Each raises
# ImportError from the port's module, naming the stand-in (``_STAND_INS``).
NAME_STAND_INS = {
    ("ops/crowding.py", "crowding_distance_pallas"): "crowding_distance_kernel is the crowding kernel's distance",
    ("ops/topk.py", "masked_top_k_xla"): "masked_top_k_plain is the plain version",
    ("ops/pso_step.py", "pad_dim"): "the TPU's 128-lane padding; the CUDA kernel takes any (n, d)",
    ("ops/pso_step.py", "supports_shape"): "the TPU's 128-lane padding; the CUDA kernel takes any (n, d)",
    ("ops/pallas_gate.py", "pallas_enabled"): "no gate: on a CUDA tensor every wrapper launches its kernel",
    ("ops/pallas_gate.py", "PROBE_RECORD_PATH"): "the probe keeps no verdict file",
}

# The JAX pytree protocol: the port's State is a torch.utils._pytree node.
METHOD_STAND_INS = {("core/state.py", "State"): {"tree_flatten_with_keys", "tree_unflatten"}}


def _all(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _jax_modules():
    """``(JAX path relative to the repo, its __all__)`` of every JAX module
    that has one."""
    files = sorted(JAX_PKG.rglob("*.py")) + [ROOT / "evox_tpu_ext" / "autoload_ext.py"]
    return [(str(p.relative_to(ROOT)), names) for p in files if (names := _all(p)) is not None]


JAX_MODULES = _jax_modules()


def _port_path(jax_path: str) -> str:
    """The port's module for a JAX module path (both relative to the repo)."""
    if jax_path == "evox_tpu_ext/autoload_ext.py":
        return "evox_tpu_torch/autoload_ext.py"
    rel = jax_path.removeprefix("evox_tpu/")
    return "evox_tpu_torch/" + MODULE_STAND_INS.get(rel, (rel,))[0]


def _import(port_path: str):
    parts = Path(port_path).with_suffix("").parts
    return importlib.import_module(".".join(parts[:-1] if parts[-1] == "__init__" else parts))


def test_every_jax_module_with_exports_is_checked():
    # 146 modules of evox_tpu (the vis_tools three among them) and the
    # autoloader.
    assert len(JAX_MODULES) >= 142
    assert {p for p, _ in JAX_MODULES} >= {"evox_tpu/vis_tools/__init__.py", "evox_tpu/utils/exec_cache.py"}


@pytest.mark.parametrize("jax_path,names", JAX_MODULES, ids=[p for p, _ in JAX_MODULES])
def test_module_exports_match_the_jax_package(jax_path, names):
    rel = jax_path.removeprefix("evox_tpu/")
    port_path = _port_path(jax_path)
    assert (ROOT / port_path).is_file(), f"{jax_path} has no counterpart ({port_path})"
    if rel in MODULE_STAND_INS:
        # The JAX module's own path is not a module of the port.
        with pytest.raises(ImportError, match=Path(rel).stem):
            _import("evox_tpu_torch/" + rel)
    port_all = _all(ROOT / port_path)
    mod = _import(port_path)
    not_ported = set(getattr(mod, "_NOT_PORTED", ()))
    stand_ins = {n for (p, n) in NAME_STAND_INS if p == rel}
    assert stand_ins == set(getattr(mod, "_STAND_INS", {})), "the port's _STAND_INS and this list differ"
    for name in names:
        if name in not_ported or name in stand_ins:
            assert name not in vars(mod) and name not in port_all, f"{name} is exported after all"
            with pytest.raises(ImportError, match=name):
                getattr(mod, name)
            with pytest.raises(ImportError, match=name):
                exec(f"from {mod.__name__} import {name}", {})
        else:
            assert name in port_all, f"{port_path}: {name} is not in __all__"
            assert name in vars(mod), f"{port_path}: {name} is not defined"
    # Every refusal of the port names a name the JAX module exports.
    assert not_ported <= set(names) and stand_ins <= set(names)


def test_no_port_module_refuses_a_jax_name_as_not_ported():
    """Every JAX export is ported or a named stand-in: ``obs/xla.py``'s
    eight bench names among them, now defined and exported."""
    left = {p: getattr(_import(_port_path(p)), "_NOT_PORTED", ()) for p, _ in JAX_MODULES}
    assert not {p: names for p, names in left.items() if names}
    xla = _import("evox_tpu_torch/obs/xla.py")
    for name in ("DEFAULT_HBM_PEAK_GBPS", "DEFAULT_FLOP_PEAK_TFLOPS", "program_costs", "program_memory",
                 "write_cost_analysis", "roofline", "roofline_from_cost", "publish_roofline_gauges"):
        assert name in xla.__all__ and name in vars(xla)


def _classes(path: Path) -> dict[str, set[str]]:
    """Each top-level class's public names: methods, properties and
    class-level assignments (aliases)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            names = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    names.add(b.name)
                elif isinstance(b, ast.Assign):
                    names.update(t.id for t in b.targets if isinstance(t, ast.Name))
                elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                    names.add(b.target.id)
            out[node.name] = {n for n in names if not n.startswith("_")}
    return out


def test_same_named_classes_have_the_jax_packages_public_methods():
    """The JAX class's own public names (read with ``ast``) against the
    port's: its own (dataclass fields among them) and, as imported, those
    it inherits."""
    compared, missing = 0, {}
    for jax_file in sorted(JAX_PKG.rglob("*.py")):
        rel = str(jax_file.relative_to(JAX_PKG))
        port_file = PORT_PKG / MODULE_STAND_INS.get(rel, (rel,))[0]
        if not port_file.is_file():
            continue
        port_classes = _classes(port_file)
        for cls, names in _classes(jax_file).items():
            if cls not in port_classes:
                continue
            compared += 1
            port_cls = getattr(_import(str(port_file.relative_to(ROOT))), cls)
            gone = names - port_classes[cls] - set(dir(port_cls)) - METHOD_STAND_INS.get((rel, cls), set())
            if gone:
                missing[f"{rel}::{cls}"] = sorted(gone)
    assert not missing
    assert compared > 150
    # The pytree exception is still needed: the port's State has neither.
    from evox_tpu_torch.core.state import State

    assert not set(dir(State)) & METHOD_STAND_INS[("core/state.py", "State")]


FORBIDDEN = ("jax", "jaxlib", "evox_tpu", "evox_tpu_ext")


def test_the_port_and_chip_smoke_import_nothing_of_jax():
    files = sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 100
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [(str(f.relative_to(ROOT)), m) for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not offenders


def test_compile_uncached_calls_its_function_once():
    calls = []

    def compile_fn():
        calls.append(1)
        return "program"

    assert exec_cache.compile_uncached(compile_fn) == "program"
    assert calls == [1]
    # The JAX package's returns the same.
    assert jexec_cache.compile_uncached(compile_fn) == "program"
    assert calls == [1, 1]
    with pytest.raises(KeyError):
        exec_cache.compile_uncached(lambda: {}["missing"])
