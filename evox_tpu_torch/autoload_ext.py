"""Extension auto-loading (counterpart of ``evox_tpu_ext/autoload_ext.py``).

``auto_load_extensions()`` is called from ``evox_tpu_torch/__init__.py`` at
package import.  For each extension category it imports the namespace
package ``evox_tpu_torch_ext.<category>`` (if any distribution provides it)
and grafts its contents into ``evox_tpu_torch.<category>``:

* submodules that don't exist in the target are attached as attributes;
* submodules that collide with an existing target submodule are merged
  recursively;
* public classes/functions defined at the extension package level are
  attached directly.

The port's plugins live under ``evox_tpu_torch_ext``, never under the JAX
package's ``evox_tpu_ext``: a JAX plugin would import JAX into the
process, and its classes compute in JAX arrays.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import types

__all__ = ["auto_load_extensions", "load_extension"]

EXT_PACKAGE = "evox_tpu_torch_ext"
_CATEGORIES = ["utils", "algorithms", "problems", "operators", "metrics"]


def _iter_namespace(ns_pkg):
    return pkgutil.iter_modules(ns_pkg.__path__, ns_pkg.__name__ + ".")


def load_extension(package: types.ModuleType, exposed_module: types.ModuleType) -> None:
    """Graft ``package``'s modules and public callables into
    ``exposed_module`` (recursively merging colliding submodules)."""
    discovered = {name: importlib.import_module(name) for _finder, name, _ispkg in _iter_namespace(package)}
    for name, external_module in discovered.items():
        module_name = name.rsplit(".", 1)[-1]
        existing = exposed_module.__dict__.get(module_name)
        if isinstance(existing, types.ModuleType):
            load_extension(external_module, existing)
        elif existing is not None:
            # Never shadow a non-module core attribute (e.g. the `igd`
            # function in evox_tpu_torch.metrics) with an extension module.
            continue
        else:
            setattr(exposed_module, module_name, external_module)
            exposed_module.__all__ = list(getattr(exposed_module, "__all__", [])) + [module_name]

    for attr_name in dir(package):
        if attr_name.startswith("_"):
            continue
        attr = getattr(package, attr_name)
        if inspect.isclass(attr) or inspect.isfunction(attr):
            setattr(exposed_module, attr_name, attr)
            exposed_module.__all__ = list(getattr(exposed_module, "__all__", [])) + [attr_name]


def auto_load_extensions() -> None:
    """Discover and load all installed ``evox_tpu_torch_ext.*`` extension
    categories into the corresponding ``evox_tpu_torch.*`` namespaces."""
    for category in _CATEGORIES:
        try:
            target = importlib.import_module(f"evox_tpu_torch.{category}")
            ext = importlib.import_module(f"{EXT_PACKAGE}.{category}")
        except ImportError:
            continue
        load_extension(ext, target)
